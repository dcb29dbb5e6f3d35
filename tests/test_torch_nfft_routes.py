"""The float64 DFTs at the n_fft the one-buffer FFT serves on the card
(4400 = 2^4 5^2 11, a radix-11 pass; 8192, too large for two buffers),
against the JAX package on the CPU: ``stft_mel`` and ``stft_mag`` (their
plain versions on a CPU tensor) against the Pallas kernels in interpret mode, as
``tests/test_pallas_exact.py`` runs them, and the port's ``analyse`` CLI
against the JAX CLI with a TuiNet whose metadata sets n_fft 8192, and
with one whose metadata sets n_fft 16384 (the cluster route on the card;
its DFTs against the Pallas kernels: ``tests/test_torch_cluster_pallas.py``).
The kernels' own routes are held against these plain versions on a GPU
(``tests/test_torch_kernels.py``) and in ``tests/test_torch_fft_plan.py``
and ``tests/test_torch_cluster_fft.py``."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_analysis_tpu.ops.pallas.melspec import pallas_mel_spectrogram, pallas_stft_magnitude

from audio_analysis_torch.ops import melspec as ms
from audio_analysis_torch.ops.windows import get_window_np

import test_torch_pipeline as pipeline  # noqa: E402  (chip_smoke on the path, the CLI helpers)

chip_smoke = pipeline.chip_smoke

# the routes these n_fft take on the H100 (stft_mel at 48 kHz, 160 mels)
ROUTES = {4400: "fft1", 8192: "fft1"}


def _max_rel(got, gt):
    """tests/test_pallas_exact.py's measure."""
    den = np.maximum(np.abs(gt), 1e-3 * np.abs(gt).max())
    return (np.abs(got - gt) / den).max()


@pytest.mark.parametrize("n_fft", sorted(ROUTES))
@pytest.mark.parametrize("power", [1.0, 2.0])
def test_stft_mel_matches_pallas(n_fft, power):
    """Two windows of three frames at the classify geometry: limit 1e-5 max
    rel, as tests/test_torch_melspec.py holds the exact level (the Pallas
    kernel's exact=2 split products carry ~1e-6)."""
    rng = np.random.RandomState(n_fft)
    wins = rng.randn(2, 2 * 640).astype(np.float32)
    kw = dict(sr=48000, n_fft=n_fft, hop_length=640, n_mels=160, fmin=50.0, fmax=11000.0,
              power=power)
    bins = ms.mel_support_bins(48000, 160, 50.0, 11000.0, n_fft, 1750.0, True)
    assert ms.stft_plan(n_fft, bins, mel=True)[0] == ROUTES[n_fft]
    got = ms.stft_mel(torch.from_numpy(wins), **kw).numpy()
    ref = np.asarray(pallas_mel_spectrogram(jnp.asarray(wins), interpret=True, exact=2, **kw))
    assert got.shape == ref.shape == (2, 160, 3)
    assert _max_rel(got, ref) < 1e-5


@pytest.mark.parametrize("n_fft", sorted(ROUTES))
def test_stft_mag_matches_pallas(n_fft):
    """A signal of a few frames ending in silence. Limits as
    tests/test_torch_melspec.py states them: the Pallas exact=2 magnitude is
    itself ~1.7e-5 max rel from float64 (1.8e-5 at n_fft 8192), so 5e-5
    against it; 1e-6 against the float64 DFT of the float32-windowed frames
    (what the kernels and the plain version compute, up to the float32
    rounding)."""
    rng = np.random.RandomState(n_fft + 1)
    y = (0.1 * rng.randn(1, n_fft // 2 + 5 * 281)).astype(np.float32)
    y[:, -2 * 281:] = 0.0
    assert ms.stft_plan(n_fft, n_fft // 2 + 1, mel=False)[0] == ROUTES[n_fft]
    got = ms.stft_mag(torch.from_numpy(y), n_fft=n_fft, hop_length=281).numpy()
    ref = np.asarray(pallas_stft_magnitude(jnp.asarray(y), n_fft=n_fft, hop_length=281,
                                           interpret=True))
    assert got.shape == ref.shape == (1, n_fft // 2 + 1, 1 + y.shape[1] // 281)
    assert _max_rel(got, ref) < 5e-5
    half = n_fft // 2
    x = np.pad(y[0], (half, half))
    frames = np.stack([x[i * 281 : i * 281 + n_fft] for i in range(got.shape[2])])
    frames = (frames * get_window_np("hann", n_fft, periodic=True)).astype(np.float64)
    oracle = np.abs(np.fft.rfft(frames, axis=-1)).T
    assert _max_rel(got[0], oracle) < 1e-6


@pytest.fixture(scope="module")
def nfft8192_fixture(tmp_path_factory):
    """A 16 s, 16-bit WAV with chirps and a silent tail, and a narrow TuiNet
    on linear mel power whose metadata sets n_fft 8192."""
    from audio_analysis_torch.io.audio import write_wav

    d = tmp_path_factory.mktemp("cli8192")
    wav = d / "rec.wav"
    write_wav(wav, chip_smoke.make_recording(seconds=16, silent_from=13.0, seed=5), 48000)
    model = chip_smoke.write_tuinet_model(d / "tuinet", seed=4, channels=(8, 16), stem=8,
                                          dense=16, n_mels=40, n_fft=8192)
    return wav, model


def test_cli_json_equals_jax_cli_at_nfft_8192(nfft8192_fixture):
    from audio_analysis_torch.cli.analyse import run as torch_run
    from audio_analysis_tpu.cli.analyse import run as jax_run

    wav, model = nfft8192_fixture
    assert json.loads((Path(model) / "metadata.txt").read_text())["n_fft"] == 8192
    argv = ["-o", str(wav), "--bird-model", str(model), "--seed", "0"]
    ref = pipeline._cli_json(jax_run, argv)
    got = pipeline._cli_json(torch_run, argv + ["--device", "cpu"])
    assert ref["species_identify"], "the fixture must produce tracks"
    chip_smoke.compare_results(got, ref)
    assert pipeline._without_confidences(got) == pipeline._without_confidences(ref)


@pytest.fixture(scope="module")
def nfft16384_fixture(tmp_path_factory):
    """The same recording and a narrow TuiNet whose metadata sets n_fft
    16384 (the card's cluster route for the classify frontend)."""
    from audio_analysis_torch.io.audio import write_wav

    d = tmp_path_factory.mktemp("cli16384")
    wav = d / "rec.wav"
    write_wav(wav, chip_smoke.make_recording(seconds=16, silent_from=13.0, seed=5), 48000)
    model = chip_smoke.write_tuinet_model(d / "tuinet", seed=4, channels=(8, 16), stem=8,
                                          dense=16, n_mels=40, n_fft=16384)
    return wav, model


def test_cli_json_equals_jax_cli_at_nfft_16384(nfft16384_fixture):
    from audio_analysis_torch.cli.analyse import run as torch_run
    from audio_analysis_tpu.cli.analyse import run as jax_run

    wav, model = nfft16384_fixture
    assert json.loads((Path(model) / "metadata.txt").read_text())["n_fft"] == 16384
    bins = ms.mel_support_bins(48000, 40, 50.0, 11000.0, 16384, 1750.0, True)
    assert ms.stft_plan(16384, bins, mel=True)[0] == "cluster"
    argv = ["-o", str(wav), "--bird-model", str(model), "--seed", "0"]
    ref = pipeline._cli_json(jax_run, argv)
    got = pipeline._cli_json(torch_run, argv + ["--device", "cpu"])
    assert ref["species_identify"], "the fixture must produce tracks"
    chip_smoke.compare_results(got, ref)
    assert pipeline._without_confidences(got) == pipeline._without_confidences(ref)
