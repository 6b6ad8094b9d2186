"""Stage 2 of the ER match job — exact normalized edit similarity of
candidate row pairs — as one CUDA kernel written by hand for Hopper
(``csrc/edit_distance.cu``).

:func:`edit_similarity_rows` verifies every pair of a call in one launch:
each thread gathers its pair's code rows through the int64 row indices
and runs Myers' bit-vector Levenshtein (Hyyrö's formulation) over them,
one 64-bit word per 64 a-positions (:func:`words_for`: 1, 2 or 4 at code
widths up to 64, 128, 256). The similarity ``1 - d / max(la, lb, 1)`` is
bit for bit the plain route's (``er.similarity.edit_similarity``, the CPU
route and the oracle). CPU tensors raise; ``er.compiler.verify_pairs``
chooses between this kernel and the plain loop (``ops.resolve_impl``).

:func:`bitvector_distance_np` is a NumPy twin of the kernel's arithmetic
(the SWAR equality mask, the multi-word carry, the score at bit la − 1),
so the CPU tests hold the algorithm itself to the DP. :data:`LAUNCHES`
counts kernel launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build

__all__ = ["WORDS", "words_for", "edit_similarity_rows",
           "bitvector_distance_np", "LAUNCHES"]

# Words of 64 a-positions the kernel is instantiated for.
WORDS = (1, 2, 4)

LAUNCHES = {"edit_similarity_rows": 0}


def words_for(length: int) -> int:
    """The words one pair's pattern takes at code width ``length``; raises
    where the kernel has no instance."""
    for w in WORDS:
        if 1 <= length <= 64 * w:
            return w
    raise ValueError(f"code width {length} is outside the verifier's "
                     f"[1, {64 * WORDS[-1]}]")


def _lib() -> ctypes.CDLL:
    lib = build.load("edit_distance")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.edit_distance_launch.argtypes = [i, p, p, p, p, i, p, p, i, p, p,
                                             p]
        lib.edit_distance_launch.restype = i
        lib.edit_distance_words.argtypes = [i]
        lib.edit_distance_words.restype = i
        lib.edit_distance_error_string.argtypes = [i]
        lib.edit_distance_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(codes_a, lens_a, codes_b, lens_b, rows_a, rows_b):
    dev = codes_a.device
    tensors = (codes_a, lens_a, codes_b, lens_b, rows_a, rows_b)
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("the CUDA verifier needs every operand on one CUDA "
                         f"device (got {[str(t.device) for t in tensors]})")
    if codes_a.dtype != torch.uint8 or codes_b.dtype != torch.uint8 \
            or codes_a.dim() != 2 or codes_b.dim() != 2 \
            or codes_a.shape[1] != codes_b.shape[1]:
        raise ValueError(f"codes must be (n, L) uint8 of one width L (got "
                         f"{tuple(codes_a.shape)} {codes_a.dtype}, "
                         f"{tuple(codes_b.shape)} {codes_b.dtype})")
    if lens_a.dtype != torch.int32 or lens_b.dtype != torch.int32 \
            or lens_a.shape != codes_a.shape[:1] \
            or lens_b.shape != codes_b.shape[:1]:
        raise ValueError("lengths must be (n,) int32, one per code row")
    if rows_a.dtype != torch.int64 or rows_b.dtype != torch.int64 \
            or rows_a.dim() != 1 or rows_a.shape != rows_b.shape:
        raise ValueError("rows_a and rows_b must be (P,) int64 of one length")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("every operand must be contiguous")
    if rows_a.shape[0] >= 2 ** 31:
        raise ValueError("at most 2**31 - 1 pairs a launch")
    words_for(codes_a.shape[1])


def edit_similarity_rows(codes_a, lens_a, codes_b, lens_b, rows_a, rows_b,
                         *, distances: bool = False):
    """Similarity of every pair ``(rows_a[i], rows_b[i])`` in one launch.

    codes_a (na, L), codes_b (nb, L) uint8, 0-padded; lens_a (na,), lens_b
    (nb,) int32 in [0, L]; rows_a, rows_b (P,) int64 in [0, na) and
    [0, nb) — the caller checks the range, the kernel does not. All on one
    CUDA device. Returns (P,) f32 ``1 - d / max(la, lb, 1)``, and with
    ``distances`` also the (P,) int32 Levenshtein distances d.
    """
    _check(codes_a, lens_a, codes_b, lens_b, rows_a, rows_b)
    p = rows_a.shape[0]
    dev = codes_a.device
    sim = torch.empty(p, dtype=torch.float32, device=dev)
    dist = torch.empty(p, dtype=torch.int32, device=dev) if distances \
        else None
    if p:
        lib = _lib()
        err = lib.edit_distance_launch(
            dev.index, codes_a.data_ptr(), lens_a.data_ptr(),
            codes_b.data_ptr(), lens_b.data_ptr(), codes_a.shape[1],
            rows_a.data_ptr(), rows_b.data_ptr(), p, sim.data_ptr(),
            None if dist is None else dist.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError("edit_distance kernel launch failed: "
                               + lib.edit_distance_error_string(err).decode())
        LAUNCHES["edit_similarity_rows"] += 1
    return (sim, dist) if distances else sim


_LOW7 = np.uint64(0x7F7F7F7F7F7F7F7F)
_BROADCAST = np.uint64(0x0101010101010101)
_GATHER = np.uint64(0x0002040810204081)


def bitvector_distance_np(codes_a: np.ndarray, lens_a: np.ndarray,
                          codes_b: np.ndarray, lens_b: np.ndarray
                          ) -> np.ndarray:
    """The kernel's recurrence in NumPy, vectorized over row-paired (P, L)
    uint8 codes and (P,) lengths: (P,) int64 Levenshtein distances. Step
    for step what one CUDA thread computes (uint64 arithmetic wraps as it
    does on the card)."""
    codes_a = np.asarray(codes_a, np.uint8)
    codes_b = np.asarray(codes_b, np.uint8)
    la = np.asarray(lens_a, np.int64)
    lb = np.asarray(lens_b, np.int64)
    p, length = codes_a.shape
    n_words = words_for(length)
    padded = np.zeros((p, 64 * n_words), np.uint8)
    padded[:, :length] = codes_a
    a = padded.view("<u8").reshape(p, 8 * n_words)
    one, all_ones = np.uint64(1), np.uint64(~np.uint64(0))
    pv = np.full((p, n_words), all_ones)
    mv = np.zeros((p, n_words), np.uint64)
    dist = la.copy()
    last = np.maximum(la - 1, 0) >> 6
    bit = (np.maximum(la - 1, 0) & 63).astype(np.uint64)
    for j in range(length):
        live = (j < lb) & (la > 0)
        bc = codes_b[:, j].astype(np.uint64) * _BROADCAST
        hin = np.ones(p, np.int64)
        for w in range(n_words):
            eq = np.zeros(p, np.uint64)
            for q in range(8):
                x = a[:, 8 * w + q] ^ bc
                zero = ~(((x & _LOW7) + _LOW7) | x | _LOW7)
                eq |= ((zero * _GATHER) >> np.uint64(56)) << np.uint64(8 * q)
            xv = eq | mv[:, w]
            eq |= (hin < 0).astype(np.uint64)
            xh = (((eq & pv[:, w]) + pv[:, w]) ^ pv[:, w]) | eq
            ph = mv[:, w] | ~(xh | pv[:, w])
            mh = pv[:, w] & xh
            step = ((ph >> bit) & one).astype(np.int64) \
                - ((mh >> bit) & one).astype(np.int64)
            dist += np.where(live & (last == w), step, 0)
            hout = (ph >> np.uint64(63)).astype(np.int64) \
                - (mh >> np.uint64(63)).astype(np.int64)
            ph = (ph << one) | (hin > 0).astype(np.uint64)
            mh = (mh << one) | (hin < 0).astype(np.uint64)
            keep = live & (w <= last)
            pv[:, w] = np.where(keep, mh | ~(xv | ph), pv[:, w])
            mv[:, w] = np.where(keep, ph & xv, mv[:, w])
            hin = hout
    return np.where(la == 0, lb, dist)
