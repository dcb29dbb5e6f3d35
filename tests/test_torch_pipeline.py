"""The port end to end: it reproduces the committed golden snapshot, its CLI
JSON equals the JAX CLI's on a shared WAV + TuiNet fixture, it imports
neither jax nor the JAX package, and its entry points run on the card
unless the caller asks for the CPU."""

import contextlib
import io
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (fixture builders and the result contract)

from audio_analysis_torch.pipeline.classify import classify_frames  # noqa: E402

import test_golden_snapshot as golden  # noqa: E402


def test_port_reproduces_golden_snapshot():
    """tests/test_golden_snapshot.py's run and comparison, through the port."""
    np.testing.assert_array_equal(chip_smoke.golden_recording(), golden._recording())
    assert chip_smoke.GOLDEN_MODEL == golden.MODEL.resolve()
    assert chip_smoke.GOLDEN_SNAPSHOT == golden.SNAPSHOT.resolve()
    chip_smoke.check_golden("cpu")


def _cli_json(run, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run(argv)
    res = json.loads(buf.getvalue())
    res.pop("processing_time_seconds")
    return res


def _without_confidences(obj):
    if isinstance(obj, dict):
        return {k: _without_confidences(v) for k, v in obj.items() if k != "confidence"}
    if isinstance(obj, list):
        return [_without_confidences(v) for v in obj]
    return obj


@pytest.fixture(scope="module")
def cli_fixture(tmp_path_factory):
    """A 16 s, 16-bit WAV with chirps and a silent tail, and a narrow TuiNet
    on linear mel power (db_scale off: TuiNet clamps its input at 0, so
    dB features, all <= 0, would reach it as zeros)."""
    from audio_analysis_torch.io.audio import write_wav

    d = tmp_path_factory.mktemp("cli")
    wav = d / "rec.wav"
    write_wav(wav, chip_smoke.make_recording(seconds=16, silent_from=13.0, seed=3), 48000)
    model = chip_smoke.write_tuinet_model(d / "tuinet", seed=1, channels=(8, 16), stem=8,
                                          dense=16, n_mels=40)
    return wav, model


def test_cli_json_equals_jax_cli(cli_fixture):
    from audio_analysis_torch.cli.analyse import run as torch_run
    from audio_analysis_tpu.cli.analyse import run as jax_run

    wav, model = cli_fixture
    argv = ["-o", str(wav), "--bird-model", str(model), "--seed", "0"]
    ref = _cli_json(jax_run, argv)
    got = _cli_json(torch_run, argv + ["--device", "cpu"])
    assert ref["species_identify"], "the fixture must produce tracks"
    assert ref["chirps"]["signals"]
    chip_smoke.compare_results(got, ref)
    assert _without_confidences(got) == _without_confidences(ref)


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, in a fresh interpreter:
    neither jax nor audio_analysis_tpu may be loaded, nor h5py or
    tensorflow (the card's machine may have neither: the port reads
    .keras archives with its own HDF5 reader)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import audio_analysis_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, 'audio_analysis_torch.')\n"
        "        if not m.name.rsplit('.', 1)[-1].startswith('_')]  # not the built _ccl.so\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'audio_analysis_tpu', 'h5py', 'tensorflow', 'keras'))\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad or len(mods) < 20 else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_need_cuda_unless_cpu_is_asked_for(cli_fixture):
    """With no GPU, the default device (cuda) raises instead of quietly
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is valid here")
    from audio_analysis_torch.cli.analyse import run
    from audio_analysis_torch.device import resolve_device

    wav, model = cli_fixture
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        classify_frames(np.zeros(48000, np.float32), 48000, [str(model)], False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run(["-o", str(wav), "--bird-model", str(model)])
    assert resolve_device("cpu").type == "cpu"
