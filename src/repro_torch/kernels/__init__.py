"""Tier kernels of the port: hand-written CUDA for the H100 (``csrc/``),
their ctypes wrappers, and the plain PyTorch versions the wrappers run on
CPU tensors."""
