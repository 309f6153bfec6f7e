"""Hand-written CUDA kernels (``repro_torch/csrc``), their ctypes build,
the checked wrappers (``ops``) and the plain PyTorch versions (``ref``)."""
