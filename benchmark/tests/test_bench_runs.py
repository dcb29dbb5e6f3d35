"""Whole runs of tiny copies of the cells on the CPU (the harness's look
for a card skipped): a sound run comes out correct, and a run with the
timed path broken underneath comes out not correct, for each fault a
serving cell can have: an answer altered where it is produced (a track's
probabilities), a detected signal lost. And the command's own refusals."""

import os
import subprocess
import sys
import time

import pytest
from conftest import BENCH, ROOT, tiny_root

from benchlib.harness import run_cell
from benchlib.spec import load_cell

CELLS = ("tuinet.backlog_quiet", "effnetb0.cli_exact")


def tiny_run(tmp_path, workload, seconds=30, trace=False):
    import torch

    torch.set_num_threads(4)
    line, _ = run_cell(workload, 2 ** 31 + 101, seconds, trace, time.perf_counter(),
                       device="cpu", root=tiny_root(tmp_path))
    assert line["compared"]["recordings_checked"]["value"] == 2, line["compared"]
    return line


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(tmp_path, workload):
    line = tiny_run(tmp_path, workload)
    assert line["correct"], line["compared"]
    assert set(line["metrics"]) == {m["name"] for m in load_cell(workload).end_to_end}


def _alter_probabilities(monkeypatch):
    from audio_analysis_torch.pipeline import classify

    original = classify._track_means

    def altered(*args):  # every track's first label, wherever it is produced
        out = original(*args).clone()
        out[:, 0] += 0.1
        return out

    monkeypatch.setattr(classify, "_track_means", altered)


def _lose_a_signal(monkeypatch):
    from audio_analysis_torch.detect import signal_noise

    original = signal_noise._signals_from_stats
    monkeypatch.setattr(signal_noise, "_signals_from_stats", lambda *a: original(*a)[:-1])


@pytest.mark.parametrize("fault", (_alter_probabilities, _lose_a_signal),
                         ids=("answer_altered", "signal_lost"))
@pytest.mark.parametrize("workload", CELLS)
def test_broken_path_is_not_correct(tmp_path, monkeypatch, workload, fault):
    fault(monkeypatch)
    line = tiny_run(tmp_path, workload)
    assert not line["correct"], line["compared"]


def test_traced_run_reads_its_metrics(tmp_path):
    line = tiny_run(tmp_path, "tuinet.backlog_quiet", trace=True)
    assert {"serve_dispatch_ms", "detect_ms.backlog", "infer_ms.backlog",
            "mfu.backlog"} <= set(line["metrics"])
    assert "window_s" in line["device"] and "breakdown" in line
    # no kernel on the CPU: the rooflines find nothing to read
    assert "stft_mag_roofline.backlog" not in line["metrics"]


def test_command_refuses_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cmd = [sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed", "1",
           "--seconds", "1", "--trace", "0"]
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and res.stdout == ""
    alone = tmp_path / "alone"
    alone.mkdir()
    (alone / "BENCHMARK.json").write_text((ROOT / "BENCHMARK.json").read_text())
    subprocess.run(["cp", "-r", str(BENCH), str(alone / "benchmark")], check=True)
    res = subprocess.run(cmd, cwd=alone, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=""))
    assert res.returncode != 0 and res.stdout == ""
