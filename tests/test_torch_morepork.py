"""The port's morepork detector (``pipeline/morepork.py``) and its lookup of
converted SavedModels (``io/convert.py``) against the JAX package on the
CPU: the spectrogram, the sample grid (negative starts on a recording
shorter than 3 s) and the dB samples at three rates, the label loop over
tests/test_morepork.py's 400 fuzz seeds, two-member ensembles of native
and of ``.keras`` members end to end, the CLI JSON with a converted
three-member ensemble, the empty-directory NaN quirk, the
converted-cache layout, and what a stale or missing conversion does with
and without tensorflow."""

import contextlib
import importlib.util
import io
import json
import shutil
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_analysis_tpu.io import convert as jconvert
from audio_analysis_tpu.pipeline import morepork as jmp

from audio_analysis_torch.io import convert
from audio_analysis_torch.pipeline import morepork as mp

import test_morepork  # noqa: E402  (the label loop's fuzz seeds and oracle)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (fixture writers)


def _burst_recording(sr, seconds, seed=0):
    """tests/test_morepork.py's recording: noise with an 800 Hz tone
    gated on for half a second every 2 s."""
    rng = np.random.RandomState(seed)
    y = (0.05 * rng.randn(int(seconds * sr))).astype(np.float32)
    t = np.arange(len(y)) / sr
    y += (0.4 * np.sin(2 * np.pi * 800 * t) * (t % 2 < 0.5)).astype(np.float32)
    return y


@pytest.mark.parametrize("sr,seconds", [(48000, 7), (44100, 7), (32000, 7), (48000, 2.2)],
                         ids=["48k", "44k1", "32k", "48k-2.2s"])
def test_spectrogram_grid_and_samples_match_jax(sr, seconds):
    """n_fft = sr/10 at the recording's own rate; at 2.2 s every sample's
    start is negative and numpy slices from n + start. Limits: the |STFT|
    within 1e-6 of its max (float32 FFTs), the dB samples rtol/atol 1e-5."""
    y = _burst_recording(sr, seconds)
    ref_spec = jmp._spectrogram_program(jnp.asarray(y), sr=sr)
    spec = mp._spectrogram_program(torch.from_numpy(y), sr=sr)
    ref = np.asarray(ref_spec)
    assert spec.shape == ref.shape == (60, 1 + len(y) // int(sr / 20))
    np.testing.assert_allclose(spec.numpy(), ref, rtol=0, atol=1e-6 * np.abs(ref).max())

    lows, lengths, start_times = mp._sample_grid(int(spec.shape[1]))
    j_lows, j_lengths, j_start_times = jmp._sample_grid(int(ref.shape[1]))
    np.testing.assert_array_equal(lows, j_lows)
    np.testing.assert_array_equal(lengths, j_lengths)
    assert start_times == j_start_times
    if seconds < 3:
        assert all(s < 0 for s in start_times)

    got = mp._samples_program(spec, torch.from_numpy(lows), torch.from_numpy(lengths)).numpy()
    want = np.asarray(jmp._samples_program(ref_spec, jnp.asarray(j_lows), jnp.asarray(j_lengths)))
    assert got.shape == want.shape == (len(lows), 60, 60, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


class _PortAndJax:
    """Stands in for the morepork module in tests/test_morepork.py's fuzz
    seed: each call runs the port and the JAX package, requires equal
    results and returns the port's (which the seed then holds to its
    oracle)."""

    @staticmethod
    def _sample_grid(n_slices):
        got, want = mp._sample_grid(n_slices), jmp._sample_grid(n_slices)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        return got

    @staticmethod
    def labels_from_activations(activations_sum, start_times, n_models):
        got = mp.labels_from_activations(activations_sum, start_times, n_models)
        assert got == jmp.labels_from_activations(activations_sum, start_times, n_models)
        return got


def test_label_loop_fuzz_matches_jax(monkeypatch):
    monkeypatch.setattr(test_morepork, "mp", _PortAndJax)
    for seed in range(400):
        test_morepork.fuzz_label_loop_one_seed(seed)


def _native_ensemble(d):
    """Two narrow float32 TuiNets over [60, 60, 1] with one output each, in
    dirs that also hold a placeholder saved_model.pb (so model_paths finds
    them); their output defaults to a sigmoid."""
    for i in range(2):
        chip_smoke.write_tuinet_model(d / f"m{i}", seed=10 + i, channels=(8, 16), stem=8,
                                      dense=16, n_mels=60, labels=["morepork"])
        (d / f"m{i}" / "saved_model.pb").write_bytes(b"")


def _keras_ensemble(d):
    """Two morepork CNNs seeded from the committed zero-weight archive, each
    an audioModel.keras beside a placeholder saved_model.pb."""
    chip_smoke.morepork_ensemble(d, seed=10, members=2)
    for i in range(2):
        member = d / f"member{i}"
        shutil.move(member / ".aat_native" / "audioModel.keras", member)
        shutil.rmtree(member / ".aat_native")


@pytest.mark.parametrize("kind", ["native", "keras"])
def test_two_member_ensemble_matches_jax(tmp_path, kind):
    """Labels identical to the JAX package's; each member's activations are
    summed on the host in float64, member by member, as the JAX package
    sums them, so the threshold and round() read the same sums."""
    d = tmp_path / "ensemble"
    (_native_ensemble if kind == "native" else _keras_ensemble)(d)
    y = chip_smoke.make_recording(seconds=20, silent_from=20.0, seed=4)
    want = jmp.identify_morepork_frames(y, 48000, str(d))
    got = mp.identify_morepork_frames(y, 48000, str(d), device="cpu")
    assert got == want
    assert got, "the ensemble must put a span over the threshold"


@pytest.fixture(scope="module")
def ensemble(tmp_path_factory):
    return chip_smoke.morepork_ensemble(tmp_path_factory.mktemp("morepork") / "ensemble")


def _cli_json(run, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run(argv)
    res = json.loads(buf.getvalue())
    res.pop("processing_time_seconds")
    return res


@pytest.mark.parametrize("sr", [48000, 44100])
def test_cli_json_equals_jax_cli(tmp_path, ensemble, sr):
    """``analyse FILE --morepork-model DIR`` on a 30 s WAV with three
    converted members, read from their ``.aat_native`` caches by both
    packages (no tensorflow): the JSON equal apart from the time."""
    from audio_analysis_torch.cli.analyse import run
    from audio_analysis_torch.io.audio import write_wav
    from audio_analysis_tpu.cli.analyse import run as jax_run

    wav = tmp_path / "rec.wav"
    write_wav(wav, chip_smoke.make_recording(seconds=30, silent_from=28.0, seed=5, sr=sr), sr)
    argv = ["-o", str(wav), "--morepork-model", str(ensemble)]
    want = _cli_json(jax_run, argv)
    got = _cli_json(run, argv + ["--device", "cpu"])
    assert got == want
    assert got["morepork"], "the fixture ensemble must find spans"


def test_empty_model_dir_keeps_the_nan_quirk(tmp_path):
    """tests/test_morepork.py::test_morepork_empty_model_dir_nan_crash_quirk
    on the port: no member divides 0.0 * 100 by 0, and round(NaN) raises."""
    y = (0.01 * np.random.RandomState(0).randn(48000 * 3)).astype(np.float32)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(ValueError, match="NaN"):
        mp.identify_morepork_frames(y, 48000, mp.model_paths(str(empty)), device="cpu")


def test_converted_cache_is_found_as_the_jax_package_finds_it(ensemble, tmp_path, monkeypatch):
    member = ensemble / "member0"
    assert mp.model_paths(str(ensemble)) == jmp.model_paths(str(ensemble))
    assert convert.auto_convert_saved_model(member) == member / ".aat_native"
    assert jconvert.auto_convert_saved_model(member) == member / ".aat_native"
    # a dir that is not writable keys its cache under ~/.cache
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setattr(convert.os, "access", lambda *a: False)
    assert convert._cache_dir_for(member) == jconvert._cache_dir_for(member)
    assert str(convert._cache_dir_for(member)).startswith(str(tmp_path / ".cache"))


def _hide_tensorflow(monkeypatch):
    """tensorflow and tf_keras unimportable, as on a machine without them."""
    for name in ("tensorflow", "tf_keras"):
        monkeypatch.setitem(sys.modules, name, None)


@pytest.mark.parametrize("fault", ["stale", "missing"])
def test_stale_or_missing_conversion_raises(ensemble, tmp_path, monkeypatch, fault):
    """A stamp that is not saved_model.pb's mtime, or no stamp, makes both
    packages' loaders convert the member. Without tensorflow that raises
    the JAX package's RuntimeError, from the CLI's loader too; with it, the
    fixture's placeholder saved_model.pb fails in the port as in the JAX
    package (tf.saved_model.load's ValueError), and no stamp is written."""
    members = {}
    for side in ("port", "jax"):
        member = tmp_path / side / "member"
        shutil.copytree(ensemble / "member0", member)
        stamp = member / ".aat_native" / ".stamp"
        if fault == "stale":
            stamp.write_text("1")
        else:
            stamp.unlink()
        members[side] = member

    def same_error(load_port, load_jax, kind):
        with pytest.raises(kind) as got:
            load_port()
        with pytest.raises(kind) as ref:
            load_jax()
        assert type(got.value) is type(ref.value)
        assert str(got.value) == str(ref.value).replace(str(members["jax"]), str(members["port"]))
        return got.value

    with monkeypatch.context() as m:
        _hide_tensorflow(m)
        err = same_error(lambda: mp._load_morepork_model(members["port"], "cpu"),
                         lambda: jmp._load_morepork_model(members["jax"]), RuntimeError)
        assert "requires tensorflow" in str(err) and "convert_model.py" in str(err)
        y = (0.01 * np.random.RandomState(0).randn(48000 * 4)).astype(np.float32)
        with pytest.raises(RuntimeError, match="requires tensorflow"):
            mp.identify_morepork_frames(y, 48000, str(tmp_path / "port"), device="cpu")
    if importlib.util.find_spec("tensorflow") is not None:
        same_error(lambda: mp._load_morepork_model(members["port"], "cpu"),
                   lambda: jmp._load_morepork_model(members["jax"]), ValueError)
    for member in members.values():
        stamp = member / ".aat_native" / ".stamp"
        assert (stamp.read_text() == "1") if fault == "stale" else not stamp.exists()


def test_morepork_needs_cuda_unless_cpu_is_asked_for(ensemble, tmp_path):
    """With no GPU the default device (cuda) raises, from the CLI too,
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is valid here")
    from audio_analysis_torch.cli.analyse import run
    from audio_analysis_torch.io.audio import write_wav

    y = np.zeros(48000 * 4, np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        mp.identify_morepork_frames(y, 48000, str(ensemble))
    write_wav(tmp_path / "rec.wav", y, 48000)
    with pytest.raises(RuntimeError, match="CUDA"):
        run(["-o", str(tmp_path / "rec.wav"), "--morepork-model", str(ensemble)])
