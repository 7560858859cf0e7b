"""Attention kernels: hand-written CUDA for sm_90a (``csrc/``), their
wrappers, the plain PyTorch versions (``ref``) and the dispatch (``ops``)."""
