"""Round arithmetic (plain PyTorch) and the hand-written CUDA kernels."""
