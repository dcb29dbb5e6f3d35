"""The port's framed-DFT ops (audio_analysis_torch.ops.melspec) against the
Pallas kernels they replace, run in interpret mode as the JAX package's own
tests run them, against the JAX XLA path and against a float64 oracle.

On a CPU tensor the wrappers take their plain PyTorch versions; the kernels
themselves are held against those in tests/test_torch_kernels.py, on a GPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_analysis_tpu.ops.pallas.melspec import (
    _fb_np,
    pallas_mel_spectrogram,
    pallas_stft_magnitude,
)
from audio_analysis_tpu.ops.stft import stft_magnitude as j_stft_magnitude
from audio_analysis_tpu.ops.windows import get_window_np

from audio_analysis_torch.ops import melspec as ms

# (sr, n_fft, hop, n_mels, fmin, fmax, break, samples): a power of two, and
# an n_fft that is not one (480 = 2^5 * 3 * 5, like the end-scan's 4800)
GEOMS = [
    (16000, 512, 160, 40, 50.0, 7000.0, 1750.0, 4000),
    (4800, 480, 120, 24, 50.0, 2000.0, 1750.0, 4800),
]


def _f64_oracle(wins, sr, n_fft, hop, n_mels, fmin, fmax, brk, power):
    """Centre-padded STFT -> |.|^power -> mel matmul, all float64 on the
    host (tests/test_pallas_exact.py's oracle, at any geometry)."""
    win = get_window_np("hann", n_fft, periodic=True).astype(np.float64)
    fb = _fb_np(sr, n_mels, fmin, fmax, n_fft, brk, True).astype(np.float64)
    out = []
    for row in wins:
        x = np.pad(row.astype(np.float64), (n_fft // 2, n_fft // 2))
        nf = 1 + (len(x) - n_fft) // hop
        frames = np.stack([x[i * hop : i * hop + n_fft] for i in range(nf)])
        spec = np.fft.rfft(frames * win, axis=-1)
        out.append(fb @ (np.abs(spec.T) ** power))
    return np.stack(out)


def _max_rel(got, gt):
    """tests/test_pallas_exact.py's measure."""
    den = np.maximum(np.abs(gt), 1e-3 * np.abs(gt).max())
    return (np.abs(got - gt) / den).max()


@pytest.mark.parametrize("geom", GEOMS, ids=["nfft512", "nfft480"])
@pytest.mark.parametrize("power", [1.0, 2.0])
def test_stft_mel_plain_vs_oracle_and_pallas(rng, geom, power):
    sr, n_fft, hop, n_mels, fmin, fmax, brk, s = geom
    wins = rng.randn(2, s).astype(np.float32)
    kw = dict(sr=sr, n_fft=n_fft, hop_length=hop, n_mels=n_mels, fmin=fmin,
              fmax=fmax, break_freq=brk, power=power)
    got = ms.stft_mel(torch.from_numpy(wins), **kw).numpy()
    assert got.shape == (2, n_mels, 1 + s // hop)
    oracle = _f64_oracle(wins, sr, n_fft, hop, n_mels, fmin, fmax, brk, power)
    assert _max_rel(got, oracle) < 1e-5
    pallas = np.asarray(pallas_mel_spectrogram(jnp.asarray(wins), interpret=True, exact=2, **kw))
    assert _max_rel(got, pallas) < 1e-5


def test_stft_mel_frame_slice_and_slaney(rng):
    """frames selects exactly that prefix of the frames; htk=False is
    librosa's Slaney filterbank."""
    wins = torch.from_numpy(rng.randn(2, 4000).astype(np.float32))
    kw = dict(sr=16000, n_fft=512, hop_length=160, n_mels=40, fmin=50.0, fmax=7000.0)
    full = ms.stft_mel(wins, **kw)
    part = ms.stft_mel(wins, frames=13, **kw)
    torch.testing.assert_close(part, full[..., :13], rtol=0, atol=0)
    with pytest.raises(ValueError):
        ms.stft_mel(wins, frames=27, **kw)
    slaney = ms.stft_mel(wins, htk=False, **kw).numpy()
    fb = _fb_np(16000, 40, 50.0, 7000.0, 512, 1750.0, False).astype(np.float64)
    x = np.pad(wins[0].numpy().astype(np.float64), (256, 256))
    fr = np.stack([x[i * 160 : i * 160 + 512] for i in range(26)])
    mag = np.abs(np.fft.rfft(fr * get_window_np("hann", 512), axis=-1)) ** 2
    assert _max_rel(slaney[0], fb @ mag.T) < 1e-5


def test_stft_mag_plain_vs_pallas_and_xla(rng):
    """Tolerances: the Pallas exact2 magnitude is itself ~1.7e-5 max rel
    from float64 in interpret mode (detect/signal_noise.py::_mag_level), so
    5e-5 against it; the XLA path is a float32 FFT, held at atol 1e-5 on
    magnitudes of order 1."""
    y = (0.1 * rng.randn(2, 16000)).astype(np.float32)
    got = ms.stft_mag(torch.from_numpy(y), n_fft=512, hop_length=160).numpy()
    assert got.shape == (2, 257, 101)
    pallas = np.asarray(pallas_stft_magnitude(jnp.asarray(y), n_fft=512, hop_length=160,
                                              interpret=True))
    assert _max_rel(got, pallas) < 5e-5
    xla = np.asarray(j_stft_magnitude(jnp.asarray(y), 512, 160))
    np.testing.assert_allclose(got, xla, rtol=0, atol=1e-5)
    # bin by bin, the float64 DFT of the float32-windowed frames (what the
    # kernel and its plain version compute) up to the final float32 rounding
    x = np.pad(y, ((0, 0), (256, 256)))
    fr = np.stack([x[:, i * 160 : i * 160 + 512] for i in range(101)], axis=1)
    fr = (fr * get_window_np("hann", 512)).astype(np.float64)
    oracle = np.abs(np.fft.rfft(fr, axis=-1)).transpose(0, 2, 1)
    assert _max_rel(got, oracle) < 1e-6


def test_cpu_wrappers_use_the_plain_versions(rng):
    """On a CPU tensor the wrapper IS the plain version and counts nothing."""
    y = torch.from_numpy(rng.randn(1, 3000).astype(np.float32))
    before = (ms.stft_mel.launches, ms.stft_mag.launches)
    kw = dict(sr=16000, n_fft=512, hop_length=160, n_mels=40, fmin=50.0, fmax=7000.0)
    torch.testing.assert_close(ms.stft_mel(y, **kw), ms.stft_mel_plain(y, **kw), rtol=0, atol=0)
    torch.testing.assert_close(ms.stft_mag(y, n_fft=512, hop_length=160),
                               ms.stft_mag_plain(y, n_fft=512, hop_length=160), rtol=0, atol=0)
    assert (ms.stft_mel.launches, ms.stft_mag.launches) == before



def test_float32_dft_misses_the_magnitude_contract(rng):
    """Why the DFT runs in float64: at the 1e-3-of-max floor a float32 FFT
    of noise is off by more than 1e-5 max rel, where the detection mask
    starts flipping bits; the port's plain version (and kernel) is not."""
    y = torch.from_numpy((0.01 * rng.randn(1, 48000 * 5)).astype(np.float32))
    oracle = ms.stft_mag_plain(y, n_fft=4096, hop_length=281).numpy()
    from audio_analysis_torch.ops.stft import stft_magnitude

    f32 = stft_magnitude(y, 4096, 281).numpy()
    assert _max_rel(f32, oracle) > 1e-5
    x = np.pad(y.numpy()[0], (2048, 2048))
    fr = np.stack([x[i * 281 : i * 281 + 4096] for i in range(0, 854, 17)])
    exact = np.abs(np.fft.rfft((fr * get_window_np("hann", 4096)).astype(np.float64), axis=-1))
    assert _max_rel(oracle[0][:, ::17], exact.T) < 1e-6
