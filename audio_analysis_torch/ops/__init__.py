"""DSP ops in PyTorch, and the CUDA kernels' wrappers."""
