"""Checkpoints on the JAX package's on-disk layout (``checkpoint``)."""
