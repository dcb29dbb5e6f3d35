"""audio_analysis_torch — the PyTorch/CUDA port of audio_analysis_tpu.

Same module layout as the JAX package, so each module's counterpart is easy
to find. Plain tensor code is PyTorch; the JAX package's Pallas kernels on
the main path are CUDA kernels written for Hopper (``csrc/``), built with
nvcc at first use and bound with ctypes (``ops/cuda.py``). Each kernel's
wrapper runs the kernel on CUDA tensors and its plain PyTorch version on CPU
tensors.

This package imports neither jax nor audio_analysis_tpu.
"""

from audio_analysis_torch import device  # noqa: F401  (sets the TF32 flags)
from audio_analysis_torch.version import __version__

__all__ = ["__version__"]
