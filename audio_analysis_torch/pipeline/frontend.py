"""Batched spectrogram frontend: the reference's per-window ``get_spect``
(src/identify_tracks.py:212-288) over the whole window grid (the JAX
package's pipeline/frontend.py::spectrogram_grid).

Normalise -> framed DFT -> mel -> dB -> mean-sub -> channels. The DFT -> mel
runs at one of two levels (``frontend_level``): ``exact``, the float64
``stft_mel`` kernel, or ``fast``, the bf16 tensor-core ``stft_mel_bf16``
kernel (the AAT_FAST throughput preset; its dif route for n_fft % 8 == 0).
"""

import logging
import os

import torch

from audio_analysis_torch.ops.melspec import stft_mel, stft_mel_bf16
from audio_analysis_torch.ops.scale import normalize_minmax, power_to_db
from audio_analysis_torch.utils.runtime import fast_mode

EXACT, FAST = "exact", "fast"

_FAST_WORDS = ("1", "true", "on", "yes")
# the JAX package's exact levels (exact, exact1, exact2, 2, 3) and its XLA
# level (0 and the false words) all resolve to the float64 kernel here: it
# meets exact2's 1.5e-6 contract and keeps the XLA level's float parity
_EXACT_WORDS = ("0", "false", "off", "no", "exact", "exact1", "exact2", "2", "3")
_WARNED_BAD_LEVEL = False


def frontend_level() -> str:
    """The DFT -> mel level, the counterpart of the JAX package's
    ``_use_pallas_default``, read at each call so a warm process can flip it:

    - an explicit AAT_PALLAS beats AAT_FAST;
    - AAT_PALLAS=1/true/on/yes, or AAT_FAST=1 with no AAT_PALLAS: ``fast``;
    - unset, 0/false/off/no and exact/exact1/exact2/2/3: ``exact``;
    - any other AAT_PALLAS warns once and takes the default (``fast`` under
      AAT_FAST, else ``exact``).

    Unlike the JAX package, the fast level does not degrade on the CPU:
    there it runs the bf16 kernel's plain version. AAT_PALLAS_ALG=matmul
    sends the fast level to the direct DFT, as in the JAX package
    (``ops/melspec.py::bf16_route``, read at each call)."""
    global _WARNED_BAD_LEVEL
    raw = os.environ.get("AAT_PALLAS", "").strip().lower()
    if raw in _FAST_WORDS:
        return FAST
    if raw in _EXACT_WORDS:
        return EXACT
    if raw and not _WARNED_BAD_LEVEL:
        _WARNED_BAD_LEVEL = True
        logging.warning(
            "unrecognised AAT_PALLAS=%r (expected a boolean or one of %s); using the "
            "default level", raw, sorted(_EXACT_WORDS[4:]),
        )
    return FAST if fast_mode() else EXACT


def dft_mel(level):
    """The DFT -> mel wrapper of a level."""
    if level not in (EXACT, FAST):
        raise ValueError(f"unknown frontend level {level!r}")
    return stft_mel_bf16 if level == FAST else stft_mel


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
    level: str = None,
) -> torch.Tensor:
    """[N, sample_size] PCM windows -> [N, n_mels, frames, channels].

    Faithful to get_spect, including the fmax-keyed-on-fmin quirk
    (src/identify_tracks.py:260-261) and per-window power_to_db(ref=max).
    ``level`` is ``exact`` or ``fast``; None resolves it now
    (``frontend_level``)."""
    if use_mfcc:
        raise NotImplementedError(
            "the mfcc frontend is not ported yet (ROADMAP Queue 1, item 10)"
        )
    mel_of = dft_mel(frontend_level() if level is None else level)
    if normalize:
        windows = normalize_minmax(windows)
    if htk:
        f_lo = 50.0 if fmin is None else fmin
        f_hi = 11000.0 if fmin is None else fmax  # quirk: keyed on fmin
        mel = mel_of(
            windows.contiguous(), sr=sr, n_fft=n_fft, hop_length=hop_length,
            n_mels=n_mels, fmin=f_lo, fmax=f_hi, break_freq=mel_break,
            power=power, htk=True,
        )
    else:
        # librosa.feature.melspectrogram defaults: Slaney scale/norm, power 2
        mel = mel_of(
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
