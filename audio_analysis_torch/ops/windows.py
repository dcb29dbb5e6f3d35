"""Window functions, built on the host in float64 and returned as float32
(the JAX package's ops/windows.py; reference: src/common.py:21-62)."""

from functools import lru_cache

import numpy as np
import torch

_SUPPORTED = (
    "hann",
    "hanning",
    "hamming",
    "bartlett",
    "blackman",
    "kaiser",
    "tukey",
    "rect",
)


@lru_cache(maxsize=64)
def _window_np(name: str, length: int, periodic: bool) -> np.ndarray:
    """`periodic=True` gives the DFT-even ("fftbins") variant used for STFT
    analysis; `periodic=False` the symmetric variant of numpy.hanning etc."""
    if length == 1:
        return np.ones(1, dtype=np.float32)
    n = np.arange(length, dtype=np.float64)
    denom = float(length) if periodic else float(length - 1)
    if name in ("hann", "hanning"):
        w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / denom)
    elif name == "hamming":
        w = 0.54 - 0.46 * np.cos(2.0 * np.pi * n / denom)
    elif name == "blackman":
        w = (
            0.42
            - 0.5 * np.cos(2.0 * np.pi * n / denom)
            + 0.08 * np.cos(4.0 * np.pi * n / denom)
        )
    elif name == "bartlett":
        w = 1.0 - np.abs(2.0 * n / denom - 1.0)
    elif name == "kaiser":
        beta = 14.0  # reference uses beta=14 (src/common.py:43)
        w = np.kaiser(length if not periodic else length + 1, beta)
        if periodic:
            w = w[:-1]
    elif name == "tukey":
        alpha = 0.5
        m = length if not periodic else length + 1
        x = np.linspace(0, 1, m)
        w = np.ones(m)
        lo = x < alpha / 2
        hi = x >= 1 - alpha / 2
        w[lo] = 0.5 * (1 + np.cos(2 * np.pi / alpha * (x[lo] - alpha / 2)))
        w[hi] = 0.5 * (1 + np.cos(2 * np.pi / alpha * (x[hi] - 1 + alpha / 2)))
        if periodic:
            w = w[:-1]
    elif name == "rect":
        w = np.ones(length)
    else:
        raise ValueError(f"window family {name!r} not supported; use {_SUPPORTED}")
    return w.astype(np.float32)


def get_window_np(name: str, length: int, periodic: bool = True) -> np.ndarray:
    """Host (numpy) float32 window of `length` samples."""
    return _window_np(name, int(length), bool(periodic))


def get_window(name: str, length: int, periodic: bool = True, device="cpu") -> torch.Tensor:
    """float32 window of `length` samples as a tensor on `device`."""
    return torch.from_numpy(get_window_np(name, length, periodic)).to(device)
