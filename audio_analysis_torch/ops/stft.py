"""Short-time Fourier transform with librosa's conventions
(the JAX package's ops/stft.py; reference: src/identify_tracks.py:243,654).

Periodic hann window of ``n_fft``, ``center=True`` with CONSTANT (zero)
padding of ``n_fft//2`` on both ends, a frame every ``hop_length`` samples,
layout ``[..., 1 + n_fft//2, n_frames]``. ``torch.stft`` pads with
``"reflect"`` by default, so framing is written out here.
"""

import torch
import torch.nn.functional as F

from audio_analysis_torch.ops.windows import get_window


def stft(y: torch.Tensor, n_fft: int, hop_length: int, dtype=None) -> torch.Tensor:
    """Complex STFT ``[..., 1 + n_fft//2, n_frames]`` (librosa layout). The
    Hann window multiplies in y's type; ``dtype`` (e.g. float64) then sets
    the type the DFT is taken in."""
    y = F.pad(y, (n_fft // 2, n_fft // 2))
    frames = y.unfold(-1, n_fft, hop_length)  # [..., n_frames, n_fft], a view
    frames = frames * get_window("hann", n_fft, periodic=True, device=y.device)
    if dtype is not None:
        frames = frames.to(dtype)
    return torch.fft.rfft(frames, dim=-1).transpose(-1, -2)


def stft_magnitude(y: torch.Tensor, n_fft: int, hop_length: int, power: float = 1.0,
                   dtype=None) -> torch.Tensor:
    """|STFT|**power, ``[..., 1 + n_fft//2, n_frames]``."""
    mag = stft(y, n_fft, hop_length, dtype=dtype).abs()
    if power == 1.0:
        return mag
    if power == 2.0:
        return mag * mag
    return mag**power
