"""Car dynamics and geometry reductions (plain PyTorch + CUDA kernels)."""
