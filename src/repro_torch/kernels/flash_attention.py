"""Flash attention (online softmax, GQA in place) as a CUDA kernel written
by hand for Hopper (``csrc/flash_attention.cu``).

Port of ``repro.kernels.flash_attention``: q (B, H, S, D) against k, v
(B, KVH, S, D), query head h reading KV head ``h // (H / KVH)`` in place,
causal or not, ``scale = D ** -0.5`` by default. The kernel masks a ragged
S itself, so the wrapper makes no padded copies. The reference pads S to
its tiles and raises for a non-causal call whose S is not a multiple of
the kv tile it picks (:func:`kv_tiles`); :func:`check_contract` keeps that
contract, for the kernel and its plain version alike.

:func:`flash_attention` checks its CUDA tensors and launches the kernel on
the current stream, raising if the check or the launch fails; CPU tensors
raise too. ``ops.py`` chooses between it and the plain PyTorch version in
``ref.py``. :data:`LAUNCHES` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

__all__ = ["HEAD_DIMS", "LAUNCHES", "smem_bytes", "kv_tiles",
           "check_contract", "flash_attention"]

HEAD_DIMS = (16, 32, 64, 128)   # template instances of the kernel

# Launches of the CUDA kernel, counted where the wrapper launches it.
LAUNCHES = {"flash_attention": 0}


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_launch.argtypes = (
            [i, i, p, p, p, p] + [i] * 5 + [ctypes.c_float, i, p])
        lib.flash_attention_launch.restype = i
        lib.flash_attention_smem_bytes.argtypes = [i, i]
        lib.flash_attention_smem_bytes.restype = i
        lib.flash_attention_error_string.argtypes = [i]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def smem_bytes(head_dim: int, bf16: bool) -> int:
    """Dynamic shared memory of one block of the kernel. bf16: 1,024 bytes
    of alignment slack, two 128-row q tiles (the persistent block loads the
    next work item's while it finishes one), a 3-stage ring of K and V
    tiles (128 rows, 64 at head dim 128) and 13 8-byte mbarriers (q full
    and empty per q tile, k full, v full and empty per stage). f32: the q
    and k tiles (32 rows of head_dim + 1), the v tile and the 32 × 33 p
    tile."""
    if bf16:
        block_k = 64 if head_dim == 128 else 128
        return (1024 + 2 * 128 * head_dim * 2
                + 2 * 3 * block_k * head_dim * 2 + 8 * (4 + 3 * 3))
    return 4 * (2 * 32 * (head_dim + 1) + 32 * head_dim + 32 * 33)


def kv_tiles(s: int, block_q: int = 512, block_k: int = 512):
    """The (q tile, kv tile) the reference kernel picks for length s
    (``flash_attention.py:103-107``) and the length it pads s to."""
    bq = min(block_q, 128) if s < block_q else block_q
    bk = min(block_k, bq) if s < block_k else block_k
    sp = -(-s // bq) * bq
    return bq, bk, -(-sp // bk) * bk


def check_contract(q, k, v, *, causal: bool = True, block_q: int = 512,
                   block_k: int = 512) -> None:
    """The op's contract on shapes, whatever runs it: q (B, H, S, D), k and
    v (B, KVH, S, D) with H % KVH == 0, one dtype (float32 or bfloat16);
    a non-causal call needs S to be a multiple of the reference's kv tile
    (it would pad and raise)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q (B, H, S, D) and k, v (B, KVH, S, D) expected "
                         f"(got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)})")
    b, h, s, d = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, s, d) or k.shape[1] < 1 \
            or h % k.shape[1]:
        raise ValueError(f"k, v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (H must be a multiple of KVH)")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k and v must all be float32 or bfloat16 (got "
                         f"{q.dtype}, {k.dtype}, {v.dtype})")
    _, bk, sp = kv_tiles(s, block_q, block_k)
    if not causal and sp != s:
        raise ValueError(f"non-causal flash requires S % block_k == 0 "
                         f"(S = {s}, kv tile {bk})")


def _check(q, k, v, causal, block_q, block_k):
    check_contract(q, k, v, causal=causal, block_q=block_q, block_k=block_k)
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError("the CUDA kernel needs q, k and v on one CUDA "
                         f"device (got {q.device}, {k.device}, {v.device})")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[3]} is not one the kernel is "
                         f"built for {HEAD_DIMS}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned")
    if q.shape[0] * q.shape[1] >= 2 ** 31 or q.shape[2] >= 2 ** 31:
        raise ValueError("B·H and S must be < 2**31")


def flash_attention(q, k, v, *, causal: bool = True, scale=None,
                    block_q: int = 512, block_k: int = 512):
    """Softmax attention of q (B, H, S, D) over k, v (B, KVH, S, D); returns
    (B, H, S, D) in q's dtype. ``block_q`` / ``block_k`` name the reference
    kernel's tiles and only decide the non-causal contract: the CUDA kernel
    picks its own tiles. ``scale`` must be > 0: the kernel folds it into
    its exp2."""
    _check(q, k, v, causal, block_q, block_k)
    b, h, s, d = q.shape
    if scale is None:
        scale = d ** -0.5
    if not scale > 0:
        raise ValueError(f"the CUDA kernel folds the scale into its exp2 and "
                         f"needs scale > 0 (got {scale})")
    out = torch.empty_like(q)
    if q.numel():
        lib = _lib()
        err = lib.flash_attention_launch(
            int(q.dtype == torch.bfloat16), q.device.index, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, k.shape[1], s,
            d, float(scale), int(causal),
            torch.cuda.current_stream(q.device).cuda_stream)
        if err:
            raise RuntimeError(
                "flash_attention kernel launch failed: "
                + lib.flash_attention_error_string(err).decode())
        LAUNCHES["flash_attention"] += 1
    return out
