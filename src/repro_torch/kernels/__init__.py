"""Attention kernels of the port: hand-written CUDA for Hopper in
``../csrc``, their launchers, and their plain PyTorch versions."""
