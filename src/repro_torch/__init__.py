"""PyTorch/CUDA port of the ``repro`` serving and training paths, for
NVIDIA Hopper.

Mirrors ``src/repro``'s layout; each module names its JAX counterpart:
``configs``, ``core`` (the allocator's copies), ``kernels`` (the CUDA
kernels, their wrappers and plain versions), ``models``, ``serving``,
``launch`` (the dry-run record and the train step), ``training`` (data,
optimizers, the train loop), ``checkpoint`` and ``tree`` (tree paths and
parameter names, which the models, the optimizers and the checkpoint
share). It imports neither JAX nor anything from ``repro``. Entry points
run on CUDA unless the caller passes ``device="cpu"``.
"""
