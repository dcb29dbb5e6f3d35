"""Sample-rate conversion as a strided polyphase convolution (the JAX
package's ops/resample.py).

Replaces librosa.resample at soxr's "HQ" level (reference:
src/identify_tracks.py:56) and the old-index path's ``ffmpeg -ar 16000``
(src/common.py:76-90) with a windowed-sinc polyphase resampler designed to
the same spec: linear phase, passband to 91.3% of the limiting Nyquist,
~120 dB stopband. The filter is designed on the host in float64
(``design_resample_filter``, ``_polyphase_bank``: copies of the JAX
package's, so both resamplers apply the same float32 taps) and applied by
one ``F.conv1d`` on the tensor's device: a plain strided convolution for
pure decimation, and a convolution with one output channel per phase for
any other ratio. TF32 is off (``device.py``), so the sums are float32.
"""

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

# soxr-HQ-class design targets
_ATTEN_DB = 120.0  # stopband attenuation
_PASSBAND = 0.913  # passband edge as a fraction of Nyquist


def design_resample_filter(up: int, down: int) -> np.ndarray:
    """FIR low-pass for polyphase resampling (host-side, float64), to the
    soxr HQ spec (see module docstring): the JAX package's design at its
    "hq" level."""
    max_rate = max(up, down)
    # Kaiser window design: beta from the attenuation target, tap count
    # from the transition width (Oppenheim & Schafer 7.104/7.105)
    beta = 0.1102 * (_ATTEN_DB - 8.7)
    delta_f = (1.0 - _PASSBAND) / max_rate  # transition width, Nyquist units
    n = int(np.ceil((_ATTEN_DB - 7.95) / (2.285 * np.pi * delta_f)))
    if n % 2 == 0:
        n += 1  # odd length -> integer group delay, linear phase
    half_len = (n - 1) // 2
    # cutoff at the transition midpoint: passband edge stays flat,
    # stopband reaches full attenuation at the folding frequency
    f_c = (1.0 + _PASSBAND) / 2.0 / max_rate
    t = np.arange(n, dtype=np.float64) - half_len
    h = np.sinc(f_c * t) * f_c
    h *= np.kaiser(n, beta)
    # Normalise passband gain to 1 at DC, then scale by `up` to preserve
    # amplitude through zero-stuffing.
    h /= h.sum()
    return (h * up).astype(np.float64)


@lru_cache(maxsize=32)
def _filter_const(up: int, down: int) -> np.ndarray:
    return design_resample_filter(up, down)


@lru_cache(maxsize=32)
def _polyphase_bank(up: int, down: int):
    """Decompose the FIR into a per-phase kernel bank for a channelised conv.

    With the centred zero-stuffed formulation
    ``y[m] = sum_t h[t] * x_up[m*down + t - half_len]`` and m = b*up + p,
    only x indices q with up*q == m*down + t - half_len contribute, so with
    r = q - b*down:  y[b*up+p] = sum_r g_p[r] * x[b*down + r],
    g_p[r] = h[up*r - p*down + half_len]. One conv with `up` output
    channels and stride `down` computes every phase at once.
    Returns (kernel [up, 1, W] float32, r_min).
    """
    h = _filter_const(up, down)
    n = len(h)
    half_len = (n - 1) // 2
    r_min = math.ceil((0 - half_len) / up)
    r_max = math.floor((n - 1 + (up - 1) * down - half_len) / up)
    width = r_max - r_min + 1
    bank = np.zeros((up, 1, width), np.float64)
    for p in range(up):
        w = np.arange(width)
        t = up * (w + r_min) - p * down + half_len
        valid = (t >= 0) & (t < n)
        bank[p, 0, valid] = h[t[valid]]
    return bank.astype(np.float32), r_min


def resample_poly(x: torch.Tensor, up: int, down: int) -> torch.Tensor:
    """Polyphase resample along the last axis of a float tensor, on its
    device (zero-padded edges, output length ceil(n*up/down), as
    scipy.signal.resample_poly and librosa give)."""
    up, down = int(up), int(down)
    g = math.gcd(up, down)
    up //= g
    down //= g
    if up == 1 and down == 1:
        return x

    n_in = x.shape[-1]
    n_out = -(-n_in * up // down)  # ceil
    batch_shape = x.shape[:-1]
    xb = x.reshape(-1, 1, n_in).to(torch.float32)  # [N, C=1, W]

    if up == 1:
        # pure decimation: a plain strided conv
        h = _filter_const(up, down)
        half_len = (len(h) - 1) // 2
        k = torch.from_numpy(h.astype(np.float32)).to(x.device).reshape(1, 1, -1)
        xp = F.pad(xb, (half_len, half_len + down * n_out))
        y = F.conv1d(xp, k, stride=down)[:, 0, :n_out]
        return y.reshape(batch_shape + (n_out,))

    # rational/up-sampling: channelised polyphase conv (see _polyphase_bank)
    bank, r_min = _polyphase_bank(up, down)
    width = bank.shape[-1]
    n_blocks = -(-n_out // up)
    pad_left = -r_min
    # block b reads x[b*down + r_min : b*down + r_max]; ensure the last
    # block's window exists after padding
    pad_right = max(0, (n_blocks - 1) * down + (width - 1) + r_min - (n_in - 1))
    xp = F.pad(xb, (pad_left, pad_right))
    y = F.conv1d(xp, torch.from_numpy(bank).to(x.device), stride=down)  # [N, up, >=n_blocks]
    y = y[:, :, :n_blocks].transpose(1, 2).reshape(y.shape[0], n_blocks * up)[:, :n_out]
    return y.reshape(batch_shape + (n_out,))


def resample(x: torch.Tensor, orig_sr: int, target_sr: int) -> torch.Tensor:
    """Resample a float tensor along its last axis from orig_sr to
    target_sr, on the tensor's device."""
    if int(orig_sr) == int(target_sr):
        return x
    return resample_poly(x, int(target_sr), int(orig_sr))
