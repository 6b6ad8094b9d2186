"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions
(``ref``) and the dispatcher between them (``ops``)."""
from . import flash_attention, grouped_mm, ops, pair_sim, ref  # noqa: F401
