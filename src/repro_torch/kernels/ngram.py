"""The ER filter features — L2-normalised hashed character n-gram counts —
as one CUDA kernel written by hand for Hopper (``csrc/ngram_features.cu``).

:func:`ngram_features` featurizes every row of a (n, L) uint8 code matrix
in one launch and returns the (n, dim) f32 features on the card, bit for
bit those of ``er.encode.ngram_features`` (the NumPy route: the plain
version and the oracle). The route follows the tensors' device: CPU
tensors run that NumPy route (``impl="cuda"`` on them raises,
``ops.resolve_impl``), CUDA tensors the kernel (``impl="torch"`` on them
raises: the plain route never takes work off the card).
:data:`LAUNCHES` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

__all__ = ["MAX_DIM", "MAX_WINDOWS", "ngram_features", "LAUNCHES"]

# One warp's int histogram of dim entries in 48 KiB of shared memory.
MAX_DIM = 12_288
# Windows a row at most (L - n + 1): every sum of squares of the counts
# stays below 2**24, exact in f32 in any order.
MAX_WINDOWS = 4_096

LAUNCHES = {"ngram_features": 0}


def _lib() -> ctypes.CDLL:
    lib = build.load("ngram_features")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ngram_features_launch.argtypes = [i, p, p, ctypes.c_longlong, i,
                                              i, i, p, p]
        lib.ngram_features_launch.restype = i
        lib.ngram_features_error_string.argtypes = [i]
        lib.ngram_features_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(codes, lens, dim: int, n: int) -> None:
    if codes.device.type != "cuda" or lens.device != codes.device:
        raise ValueError("the CUDA featurizer needs codes and lengths on one "
                         f"CUDA device (got {codes.device}, {lens.device})")
    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise ValueError(f"codes must be (n, L) uint8 (got "
                         f"{tuple(codes.shape)} {codes.dtype})")
    if lens.dtype != torch.int32 or lens.shape != codes.shape[:1]:
        raise ValueError("lengths must be (n,) int32, one per code row")
    if not (codes.is_contiguous() and lens.is_contiguous()):
        raise ValueError("codes and lengths must be contiguous")
    if not 1 <= dim <= MAX_DIM:
        raise ValueError(f"feature width {dim} is outside the kernel's "
                         f"[1, {MAX_DIM}] (one warp's histogram in shared "
                         f"memory)")
    if n < 1 or codes.shape[1] - n + 1 > MAX_WINDOWS:
        raise ValueError(f"n-gram {n} at code width {codes.shape[1]}: n must "
                         f"be >= 1 and a row at most {MAX_WINDOWS} windows")


def ngram_features(codes, lens, dim: int = 256, n: int = 3, *,
                   impl: str = "auto"):
    """(num, dim) f32 hashed n-gram features of every code row, on the
    tensors' device.

    codes (num, L) uint8, 0-padded; lens (num,) int32. On CUDA tensors
    one launch fills a fresh ``torch.empty``; on CPU tensors the NumPy
    ``er.encode.ngram_features`` runs on them as they are."""
    from .ops import resolve_impl

    if resolve_impl(impl, codes.device) == "torch":
        if codes.device.type != "cpu" or lens.device != codes.device:
            raise ValueError("the plain route (NumPy) takes CPU tensors; "
                             "CUDA tensors take the kernel (impl='auto' or "
                             f"'cuda'; got {codes.device}, {lens.device})")
        from ..er.encode import ngram_features as plain
        return torch.from_numpy(plain(codes.numpy(), dim=dim, n=n,
                                      lengths=lens.numpy()))
    _check(codes, lens, dim, n)
    num = codes.shape[0]
    dev = codes.device
    out = torch.empty((num, dim), dtype=torch.float32, device=dev)
    if num:
        lib = _lib()
        err = lib.ngram_features_launch(
            dev.index, codes.data_ptr(), lens.data_ptr(), num,
            codes.shape[1], n, dim, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError("ngram_features kernel launch failed: "
                               + lib.ngram_features_error_string(err)
                               .decode())
        LAUNCHES["ngram_features"] += 1
    return out
