"""DCT-II through the length-2N real FFT, for the legacy cacophony index
(the JAX package's ops/dct.py; reference: src/cacophony_index.py:57).

Replaces ``scipy.fftpack.dct`` (type 2, norm=None):

    y[k] = 2 * sum_n x[n] * cos(pi * k * (2n + 1) / (2N))

in float32 on the tensor's device (``torch.fft.rfft``).
"""

import numpy as np
import torch


def dct2(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Unnormalised DCT-II along `dim` (scipy.fftpack.dct type=2, norm=None)."""
    x = x.to(torch.float32).movedim(dim, -1)
    n = x.shape[-1]
    # even extension: the rfft of [x, reversed(x)] is the 2N-point spectrum
    # whose phase-shifted real part is the DCT-II
    spec = torch.fft.rfft(torch.cat([x, x.flip(-1)], dim=-1), dim=-1)[..., :n]
    theta = np.pi * np.arange(n) / (2.0 * n)
    cos = torch.from_numpy(np.cos(theta).astype(np.float32)).to(x.device)
    sin = torch.from_numpy(np.sin(theta).astype(np.float32)).to(x.device)
    return (spec.real * cos + spec.imag * sin).movedim(-1, dim)
