"""PyTorch + CUDA port of the ``repro`` ER system for an NVIDIA H100.

The JAX package ``repro`` stays the reference; this package mirrors its
layout (``core``, ``er``, ``er.compiler``, ``kernels``) and imports
neither it nor JAX. Entry points default to ``device="cuda"``; the CPU
runs the plain PyTorch versions only when asked for with
``device="cpu"``.
"""
