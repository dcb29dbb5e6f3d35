"""Batched spectrogram frontend: the reference's per-window ``get_spect``
(src/identify_tracks.py:212-288) over the whole window grid (the JAX
package's pipeline/frontend.py::spectrogram_grid).

Normalise -> framed DFT -> mel (the ``stft_mel`` kernel) -> dB -> mean-sub
-> channels.
"""

import torch

from audio_analysis_torch.ops.melspec import stft_mel
from audio_analysis_torch.ops.scale import normalize_minmax, power_to_db


def spectrogram_grid(
    windows: torch.Tensor,
    *,
    sr: int,
    hop_length: int = 281,
    n_fft: int = 4096,
    n_mels: int = 160,
    mel_break: float = 1000.0,
    htk: bool = True,
    fmin: float = 50.0,
    fmax: float = 11000.0,
    power: float = 2.0,
    db_scale: bool = False,
    normalize: bool = True,
    mean_sub: bool = False,
    use_mfcc: bool = False,
    channels: int = 1,
) -> torch.Tensor:
    """[N, sample_size] PCM windows -> [N, n_mels, frames, channels].

    Faithful to get_spect, including the fmax-keyed-on-fmin quirk
    (src/identify_tracks.py:260-261) and per-window power_to_db(ref=max)."""
    if use_mfcc:
        raise NotImplementedError(
            "the mfcc frontend is not ported yet (ROADMAP Queue 1, item 10)"
        )
    if normalize:
        windows = normalize_minmax(windows)
    if htk:
        f_lo = 50.0 if fmin is None else fmin
        f_hi = 11000.0 if fmin is None else fmax  # quirk: keyed on fmin
        mel = stft_mel(
            windows.contiguous(), sr=sr, n_fft=n_fft, hop_length=hop_length,
            n_mels=n_mels, fmin=f_lo, fmax=f_hi, break_freq=mel_break,
            power=power, htk=True,
        )
    else:
        # librosa.feature.melspectrogram defaults: Slaney scale/norm, power 2
        mel = stft_mel(
            windows.contiguous(), sr=sr, n_fft=n_fft, hop_length=hop_length,
            n_mels=n_mels, fmin=50.0, fmax=11000.0, power=2.0, htk=False,
        )
    if db_scale:
        mel = power_to_db(mel, ref_axes=(-2, -1))
    mel = mel[..., None]  # channel dim
    if mean_sub:
        mel = mel - mel.mean(dim=-2, keepdim=True)
    if channels > 1:
        mel = mel.repeat_interleave(channels, dim=-1)
    return mel
