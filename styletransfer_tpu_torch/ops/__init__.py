"""Layers in plain PyTorch and the hand-written CUDA kernels (``ops.cuda``)."""
