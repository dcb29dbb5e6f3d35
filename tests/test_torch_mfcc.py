"""The port's mfcc frontend (``pipeline/frontend.py::_mfcc`` and
``spectrogram_grid(use_mfcc=True)``) against the JAX package on the CPU:
``_mfcc`` on min-max normalised windows, the frontend at the exact level
(the JAX package's XLA frontend, as it runs on the CPU) and at the fast
level (its Pallas frontend in interpret mode, as tests/test_torch_fast.py
runs it), and the analyse CLI's JSON with a ``use_mfcc`` TuiNet."""

import contextlib
import io
import json
import sys
from functools import partial
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audio_analysis_tpu.pipeline.frontend as jfe
from audio_analysis_tpu.ops.pallas import melspec as jm

from audio_analysis_torch.ops.scale import normalize_minmax
from audio_analysis_torch.pipeline import frontend as fe

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (fixture writers and the result contract)

SR = 48000
N_MELS = 40
KW = dict(sr=SR, hop_length=640, n_fft=4096, n_mels=N_MELS, mel_break=1750.0, htk=True,
          fmin=50.0, fmax=11000.0, power=2.0, normalize=True)


def _windows(n=3, seconds=3, seed=0):
    """Windows of the chirp fixture's sound."""
    y = chip_smoke.make_recording(seconds=n * seconds, silent_from=n * seconds, seed=seed)
    return y.reshape(n, seconds * SR)


def _max_rel(got, gt):
    """tests/test_pallas_exact.py's measure."""
    den = np.maximum(np.abs(gt), 1e-3 * np.abs(gt).max())
    return (np.abs(got - gt) / den).max()


def test_mfcc_matches_jax():
    """htk mel (80 bands, 50-11000 Hz, break 700) of |STFT|^2 at n_fft 2048,
    dB with ref 1 and an 80 dB floor, ortho DCT-II, 20 coefficients. Limit
    1e-4 absolute on coefficients of magnitude ~10-100 (float32 FFTs)."""
    w = _windows()
    z = normalize_minmax(torch.from_numpy(w))
    got = fe._mfcc(z, SR, 640).numpy()
    want = np.asarray(jfe._mfcc(jfe.normalize_minmax(jnp.asarray(w)), SR, 640))
    assert got.shape == want.shape == (3, 20, 1 + 3 * SR // 640)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("db_scale,mean_sub,channels", [
    (False, False, 1), (True, True, 1), (False, True, 3),
])
def test_exact_frontend_with_mfcc_matches_jax(db_scale, mean_sub, channels):
    """The mel rows over the resized mfcc rows, then mean-sub and the
    channel repeat, at the exact level against the JAX XLA frontend. Limit:
    max rel 1e-5 (the exact contract) on the mel rows, 1e-4 absolute on the
    mfcc rows."""
    w = _windows()
    kw = dict(KW, db_scale=db_scale, mean_sub=mean_sub, channels=channels, use_mfcc=True)
    got = fe.spectrogram_grid(torch.from_numpy(w), level=fe.EXACT, **kw).numpy()
    want = np.asarray(jfe.spectrogram_grid(jnp.asarray(w), use_pallas=0, **kw))
    assert got.shape == want.shape == (3, 2 * N_MELS, 1 + 3 * SR // 640, channels)
    if db_scale or mean_sub:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    else:
        assert _max_rel(got[:, :N_MELS], want[:, :N_MELS]) < 1e-5
        np.testing.assert_allclose(got[:, N_MELS:], want[:, N_MELS:], rtol=1e-5, atol=1e-4)
    # resize_with_pad centres the 20 coefficients in the 40 rows
    assert not got[:, N_MELS : N_MELS + 10].any() and not got[:, -10:].any()


@pytest.mark.parametrize("alg", ["", "matmul"], ids=["dif", "direct"])
def test_fast_frontend_with_mfcc_matches_jax(monkeypatch, alg):
    """At the fast level the mel rows come from the bf16 DFT (the JAX Pallas
    kernel in interpret mode: ``_kernel_dif`` at exact=0, or ``_kernel``
    under AAT_PALLAS_ALG=matmul) and the mfcc rows stay float32 in both.
    Limits: the bf16 contract, max rel 1e-2, on the mel rows; 1e-4 absolute
    on the mfcc rows."""
    monkeypatch.setenv("AAT_PALLAS_ALG", alg)
    monkeypatch.setattr(jm, "pallas_mel_spectrogram",
                        partial(jm.pallas_mel_spectrogram, interpret=True))
    w = _windows(n=2)
    kw = dict(KW, db_scale=False, use_mfcc=True)
    got = fe.spectrogram_grid(torch.from_numpy(w), level=fe.FAST, **kw).numpy()
    want = np.asarray(jfe.spectrogram_grid(jnp.asarray(w), use_pallas=1, **kw))
    assert got.shape == want.shape == (2, 2 * N_MELS, 1 + 3 * SR // 640, 1)
    assert _max_rel(got[:, :N_MELS], want[:, :N_MELS]) <= 1e-2
    np.testing.assert_allclose(got[:, N_MELS:], want[:, N_MELS:], rtol=1e-5, atol=1e-4)


def test_cli_json_with_a_mfcc_model_equals_jax_cli(tmp_path):
    """``analyse FILE --bird-model DIR`` with a narrow float32 TuiNet whose
    metadata sets ``use_mfcc``: the JSON equal to the JAX CLI's apart from
    the time, confidences within 1."""
    from audio_analysis_torch.cli.analyse import run
    from audio_analysis_torch.io.audio import write_wav
    from audio_analysis_tpu.cli.analyse import run as jax_run

    wav = tmp_path / "rec.wav"
    write_wav(wav, chip_smoke.make_recording(seconds=16, silent_from=13.0, seed=3), SR)
    model = chip_smoke.write_tuinet_model(tmp_path / "mfcc", seed=1, channels=(8, 16), stem=8,
                                          dense=16, n_mels=N_MELS, use_mfcc=True)

    def cli_json(runner, argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            runner(argv)
        res = json.loads(buf.getvalue())
        res.pop("processing_time_seconds")
        return res

    argv = ["-o", str(wav), "--bird-model", str(model), "--seed", "0"]
    want = cli_json(jax_run, argv)
    got = cli_json(run, argv + ["--device", "cpu"])
    assert want["species_identify"], "the fixture must produce tracks"
    chip_smoke.compare_results(got, want)
    assert chip_smoke.count_labels([got]) == chip_smoke.count_labels([want]) > 0
