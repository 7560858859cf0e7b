"""PyTorch/CUDA port of the ``repro`` serving path, for NVIDIA Hopper.

Mirrors ``src/repro``'s layout; each module names its JAX counterpart. It
imports neither JAX nor anything from ``repro``. Entry points run on CUDA
unless the caller passes ``device="cpu"``.
"""
