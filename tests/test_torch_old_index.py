"""The port's legacy cacophony index (``pipeline/old_index.py``,
``ops/dct.py`` and ``--old-cacophony-index``) against scipy and the JAX
package: the DCT against ``scipy.fftpack.dct``, the change points against
the JAX package's ``_points_program`` within the JAX tests' own flip budget
(tests/test_pipeline.py:329), the tables, and the CLI JSON."""

import contextlib
import importlib
import io
import json
import sys
import wave
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.fftpack
import torch

from audio_analysis_torch.ops.dct import dct2
from audio_analysis_torch.pipeline import old_index as toi

joi = importlib.import_module("audio_analysis_tpu.pipeline.old_index")

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (the seeded recording)


@pytest.mark.parametrize("n", [8, 2048, 1000, 17])
def test_dct2_matches_scipy(n):
    x = np.random.RandomState(n).randn(3, n).astype(np.float32)
    ref = scipy.fftpack.dct(x.astype(np.float64))
    np.testing.assert_allclose(dct2(torch.from_numpy(x)).numpy(), ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())
    np.testing.assert_allclose(dct2(torch.from_numpy(x.T.copy()), dim=0).numpy(), ref.T,
                               rtol=1e-4, atol=1e-4 * np.abs(ref).max())


def _recording(seed):
    """tests/test_pipeline.py's fuzz recordings: gated tones in noise."""
    r = np.random.RandomState(100 + seed)
    n = int(float(r.uniform(4.5, 30)) * 16000)
    y = (0.1 * r.randn(n)).astype(np.float32)
    t = np.arange(n) / 16000
    f0 = float(r.uniform(150, 3000))
    gate = np.sin(2 * np.pi * r.uniform(0.5, 4) * t) > r.uniform(-0.5, 0.8)
    return y + (0.4 * np.sin(2 * np.pi * f0 * t) * gate).astype(np.float32)


def test_points_match_jax_within_its_flip_budget():
    total = flipped = 0
    for seed in range(6):
        y = _recording(seed)
        got = toi.points(torch.from_numpy(y)).numpy()
        ref = np.asarray(joi._points_program(jnp.asarray(y), window_size=2048,
                                             half_window=1024, sample_rate=16000))
        assert got.shape == ref.shape, seed
        total += len(ref)
        flipped += int(np.sum(got != ref))
    assert total > 1000
    assert flipped <= max(2, total // 200), (flipped, total)


def _fixture_25s():
    """tests/test_pipeline.py's 25 s fixture: noise and a gated 800 Hz tone."""
    rng = np.random.RandomState(42)
    y = (0.1 * rng.randn(25 * 16000)).astype(np.float32)
    t = np.arange(len(y)) / 16000
    return y + 0.3 * np.sin(2 * np.pi * 800 * t) * (np.sin(2 * np.pi * 2 * t) > 0.3)


@pytest.mark.parametrize("seconds", [25, 45])
def test_table_equals_jax(seconds):
    y = np.tile(_fixture_25s(), 2)[: seconds * 16000].astype(np.float32)
    got = toi.calculate_from_frames(y, 16000, device="cpu")
    ref = joi.calculate_from_frames(y, 16000)
    assert got == ref
    assert len(got["cacophony_index_old"]) == (1 if seconds == 25 else 2)
    # a tensor input stays on its device and gives the same table
    assert toi.calculate_from_frames(torch.from_numpy(y), 16000) == ref


@pytest.mark.parametrize("seed", range(13))
def test_table_assembly_equals_jax(seed):
    lengths = [0, 1, 280, 281, 312, 313, 592, 593, 624, 1000, 1871, 1872, 5000]
    r = np.random.RandomState(seed)
    points = r.randint(0, 21, size=lengths[seed] + int(r.randint(0, 37))).tolist()
    assert toi.table_from_points(points) == joi.table_from_points(points)
    np.testing.assert_array_equal(toi.get_ci_bins_edges(2048, 16000),
                                  joi.get_ci_bins_edges(2048, 16000))


def test_short_audio_warning():
    got = toi.calculate_from_frames(np.zeros(16000 * 5, np.float32), 16000, device="cpu")
    assert got == joi.calculate_from_frames(np.zeros(16000 * 5, np.float32), 16000)
    assert got["cacophony_index_old"] == [] and "ci_warning" in got
    tiny = toi.calculate_from_frames(np.zeros(1000, np.float32), 16000, device="cpu")
    assert tiny["cacophony_index_old"] == [] and "ci_warning" in tiny


def _cli(run, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run(argv)
    out = json.loads(buf.getvalue())
    out.pop("processing_time_seconds")
    return out


@pytest.mark.parametrize("sr", [48000, 44100])
def test_cli_json_equals_jax_cli(tmp_path, sr):
    """``--old-cacophony-index`` on a 16-bit WAV at 48 kHz and at 44.1 kHz
    (decoded, resampled to 16 kHz on the device, then indexed)."""
    from audio_analysis_torch.cli.analyse import run as torch_run
    from audio_analysis_tpu.cli.analyse import run as jax_run

    y = chip_smoke.make_recording(seconds=24, silent_from=24.0, seed=7, sr=sr)
    path = tmp_path / f"rec{sr}.wav"
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(np.clip(y * 32768.0, -32768, 32767).astype("<i2").tobytes())
    argv = ["-o", "--old-cacophony-index", str(path)]
    got = _cli(torch_run, argv + ["--device", "cpu"])
    assert got == _cli(jax_run, argv)
    assert got["cacophony_index_old"] and got["cacophony_index_old_version"] == "2020-01-20_A"


def test_calculate_needs_cuda_unless_cpu_is_asked_for(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is valid here")
    from audio_analysis_torch.io.audio import write_wav

    write_wav(tmp_path / "a.wav", np.zeros(16000, np.float32), 16000)
    with pytest.raises(RuntimeError, match="CUDA"):
        toi.calculate(tmp_path / "a.wav")
    assert "ci_warning" in toi.calculate(tmp_path / "a.wav", device="cpu")
