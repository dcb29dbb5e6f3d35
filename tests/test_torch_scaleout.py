"""The port's mesh serving (``BatchAnalyzer(mesh=)`` over
torch.distributed, parallel/worker.py) on the CPU: two gloo ranks, each fed
its half of parallel/worker.py's eight deterministic recordings, return the
global result list, which equals one process's analyzer over all eight in
tests/test_multihost.py's five scenarios (plain, band-pass, analyse-tracks,
embeddings alone, spectral with an embeddings pre-model) under its
``_approx_equal`` rule; unequal, empty and too-long per-rank feeds raise
the JAX package's words on every rank; ``analyse_stream`` over the mesh
equals its batches analysed one by one; under AAT_TIMINGS each result
carries its own rank's stage times. The single-process analyzer is
tied to the JAX package's meshless BatchAnalyzer on the plain scenario.

One pair of ranks runs every case (``ranks``, module scope), while this
process computes the single-process results."""

import json
import os
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (fixture writers and the result contract)

from audio_analysis_torch.parallel import distributed as tdist  # noqa: E402
from audio_analysis_torch.parallel import worker  # noqa: E402
from audio_analysis_torch.parallel.mesh import make_mesh  # noqa: E402

LABELS = ["bird", "morepork", "human", "noise"]
SCENARIOS = ("plain", "bandpass", "tracks", "embeddings", "mixed")
TOTAL = 8


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread, as the ranks take (six test workers share the
    cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _approx_equal(a, b, path=""):
    """tests/test_multihost.py's rule: ints (track geometry, confidences)
    exact, floats to 1e-5."""
    if isinstance(a, dict) and isinstance(b, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _approx_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list) and isinstance(b, list):
        assert len(a) == len(b), (path, len(a), len(b))
        for i, (x, y) in enumerate(zip(a, b)):
            _approx_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, rel=1e-5, abs=1e-5), (path, a, b)
    else:
        assert a == b, (path, a, b)


def _tuinet(d, **meta):
    """A narrow float32 TuiNet on linear mel power."""
    chip_smoke.write_tuinet_model(d, seed=4, channels=(8, 16), stem=8, dense=16, n_mels=40,
                                  labels=LABELS)
    p = Path(d) / "metadata.txt"
    p.write_text(json.dumps({**json.loads(p.read_text()), **meta}))
    return str(d)


def _scenarios(tmp):
    """{scenario: (model dirs, analyse_tracks)}, as tests/test_multihost.py
    builds them, from narrow TuiNets and the committed embedder fixture."""
    embedder = chip_smoke.embedder_fixture(tmp / "embedder.keras")
    spec = _tuinet(tmp / "spec")
    return {
        "plain": ([spec], False),
        "bandpass": ([_tuinet(tmp / "fspec", filter_below=20000)], False),
        "tracks": ([spec], True),
        "embeddings": ([str(chip_smoke.embeddings_head(tmp / "emb", embedder))], False),
        "mixed": ([spec, str(chip_smoke.embeddings_head(tmp / "embp", embedder,
                                                       pre_model=True))], False),
    }


def _serve_rank(scenarios):
    """Every case in one rank of a gloo pair; returns {case: results or
    the ValueError's words}."""
    import torch.distributed as dist

    from audio_analysis_torch.pipeline.serve import BatchAnalyzer
    from audio_analysis_torch.utils.runtime import StageTimer

    mesh = make_mesh(device_type="cpu")
    rank, n = dist.get_rank(), dist.get_world_size()
    out = {name: worker.serve(models, TOTAL, rank, n, mesh, tracks)
           for name, (models, tracks) in scenarios.items()}
    a = BatchAnalyzer(scenarios["plain"][0], sr=worker.SR, bucket_seconds=worker.SECONDS,
                      rng=None, mesh=mesh)
    rec = worker.make_recording
    feeds = {
        "unequal": [rec(0), rec(1)] if rank == 0 else [rec(2)],
        "empty": [rec(0)] if rank == 0 else [],
        "too long": [rec(0)] if rank == 0 else [np.zeros(worker.SECONDS * worker.SR + 1,
                                                         np.float32)],
    }
    for case, feed in feeds.items():
        try:
            out[case] = a.analyse_recordings(feed)
        except ValueError as e:
            out[case] = str(e)
    batches = [[rec(10 + 2 * k + rank)] for k in range(2)]
    out["stream"] = list(a.analyse_stream(batches))
    out["one by one"] = [a.analyse_recordings(b) for b in batches]
    timer = StageTimer()
    os.environ["AAT_TIMINGS"] = "1"
    try:
        out["timed"] = a.analyse_recordings([rec(20 + rank)], timer=timer)
    finally:
        os.environ.pop("AAT_TIMINGS")
    out["own timing"] = timer.as_dict()
    return out


@pytest.fixture(scope="module")
def scenarios(tmp_path_factory):
    return _scenarios(tmp_path_factory.mktemp("scaleout"))


@pytest.fixture(scope="module")
def ranks(scenarios):
    """The pair of ranks' outputs, run in a thread while the single-process
    results are computed here."""
    box = {}

    def run():
        try:
            box["out"] = tdist.spawn(_serve_rank, 2, args=(scenarios,), device="cpu",
                                     deadline=400)
        except Exception as e:  # noqa: BLE001  (re-raised below, in the test)
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    yield box, t
    t.join(500)


@pytest.fixture(scope="module")
def single(scenarios):
    """One process's analyzer over all eight recordings, each scenario."""
    return {name: worker.serve(models, TOTAL, analyse_tracks=tracks, device="cpu")
            for name, (models, tracks) in scenarios.items()}


def _outputs(ranks):
    box, t = ranks
    t.join(500)
    assert not t.is_alive(), "the ranks outlived their deadline"
    if "error" in box:
        raise box["error"]
    return box["out"]


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_two_ranks_equal_one_process(single, ranks, scenario):
    ref = single[scenario]
    assert len(ref) == TOTAL and any(r["species_identify"] for r in ref)
    if scenario == "tracks":
        assert all(set(r) == {"non_bird_tags", "species_identify", "species_identify_version"}
                   for r in ref)
    if scenario == "embeddings":
        assert all([m["model"] for m in t["model_results"]] == ["embeddings"]
                   for r in ref for t in r["species_identify"])
    if scenario == "mixed":
        assert any([m["model"] for m in t["model_results"]] == ["tuinet-smoke", "embeddings"]
                   for r in ref for t in r["species_identify"])
    if scenario == "bandpass":  # every track band-passed: other confidences
        assert ref != single["plain"]
    for got in _outputs(ranks):
        _approx_equal(got[scenario], ref)


@pytest.mark.parametrize("case,words", [
    ("unequal", "equal non-empty per-host batches; got per-process sizes [1, 2]"),
    ("empty", "equal non-empty per-host batches; got per-process sizes [0, 1]"),
    ("too long", f"recordings <= bucket_seconds ({8 * 48000 + 1} > {8 * 48000} samples)"),
])
def test_uneven_feeds_raise_on_every_rank(ranks, case, words):
    """The JAX package's ValueError, on both ranks (neither waits on the
    other)."""
    for got in _outputs(ranks):
        assert isinstance(got[case], str) and words in got[case], got[case]


def test_stream_over_the_mesh_equals_batches_one_by_one(ranks):
    for got in _outputs(ranks):
        assert len(got["stream"]) == 2 and all(len(b) == 2 for b in got["stream"])
        assert got["stream"] == got["one by one"]
    a, b = _outputs(ranks)
    assert a["stream"] == b["stream"]


def test_timings_are_each_ranks_own(ranks):
    """With AAT_TIMINGS=1 each gathered result carries the stage times of
    the rank that produced it (its timer before the gather), so both ranks
    return the same list."""
    outs = _outputs(ranks)
    for rank, got in enumerate(outs):
        assert got["timed"] == outs[0]["timed"] and len(got["timed"]) == 2
        own = {k: v for k, v in got["own timing"].items() if k != "gather"}
        assert "gather" in got["own timing"] and got["timed"][rank]["timing"] == own


def test_single_process_equals_jax_batch_analyzer(scenarios, single):
    """The chain's anchor: the port's one-process results of the plain
    scenario against the JAX package's meshless BatchAnalyzer on the same
    recordings (signals identical, the smoke's result contract)."""
    from audio_analysis_tpu.pipeline.serve import BatchAnalyzer as JaxBatchAnalyzer

    models = scenarios["plain"][0]
    recs = [worker.make_recording(i) for i in range(TOTAL)]
    ref = JaxBatchAnalyzer(models, sr=worker.SR, bucket_seconds=worker.SECONDS,
                           rng=None).analyse_recordings(recs)
    ref = json.loads(json.dumps(ref))
    for g, r in zip(single["plain"], ref):
        assert g["chirps"]["signals"] == r["chirps"]["signals"]
        chip_smoke.compare_results(g, r)
