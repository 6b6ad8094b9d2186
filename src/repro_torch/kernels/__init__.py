"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions
(``ref``) and the dispatcher between them (``ops``)."""
from . import ops, pair_sim, ref  # noqa: F401
