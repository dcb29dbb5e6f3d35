"""The port's batch serving (``pipeline/serve.py::BatchAnalyzer`` and
``cli/batch.py``) at the exact frontend level: its results equal the JAX
package's BatchAnalyzer and batch CLI on the CPU, and it mirrors
tests/test_serve.py's parity cases against the port's own single-recording
path."""

import contextlib
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (fixture writers and the result contract)

from audio_analysis_torch.pipeline.cacophony import (  # noqa: E402
    calc_cacophony_index,
    filter_tracks,
    get_chirps,
    get_max_chirps,
)
from audio_analysis_torch.pipeline.classify import classify_frames  # noqa: E402
from audio_analysis_torch.pipeline.serve import BatchAnalyzer  # noqa: E402

SR = 48000
LABELS = ["bird", "morepork", "human", "noise"]


def _rec(seed, seconds=9):
    """tests/test_serve.py's recording: noise and two tones."""
    rng = np.random.RandomState(seed)
    t = np.arange(seconds * SR) / SR
    y = 0.01 * rng.randn(len(t)).astype(np.float32)
    for f0, t0, dur in [(3000, 2.0, 0.8), (2600, 7.0, 1.0)]:
        m = (t >= t0) & (t < t0 + dur)
        y[m] += (0.5 * np.sin(2 * np.pi * f0 * t[m])).astype(np.float32)
    return y


def _model(d, **meta):
    """A narrow float32 TuiNet on linear mel power, its metadata updated
    with `meta`."""
    chip_smoke.write_tuinet_model(d, seed=4, channels=(8, 16), stem=8, dense=16, n_mels=40,
                                  labels=LABELS)
    p = Path(d) / "metadata.txt"
    p.write_text(json.dumps({**json.loads(p.read_text()), **meta}))
    return str(d)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return _model(tmp_path_factory.mktemp("servemodel") / "m")


@pytest.fixture(scope="module")
def analyzer(model_dir):
    return BatchAnalyzer([model_dir], sr=SR, bucket_seconds=9, rng=None, device="cpu")


@pytest.fixture(scope="module")
def recs():
    """Three recordings of mixed length, each with a track."""
    return [_rec(0), _rec(1, seconds=8.5), _rec(2, seconds=7.5)]


@pytest.fixture(scope="module")
def batch(analyzer, recs):
    return analyzer.analyse_recordings(recs)


def _single_pipeline_result(rec, model_dir):
    tracks, length, signals, raw_length, bird_labels = classify_frames(
        rec, SR, [model_dir], False, None, rng=None, device="cpu"
    )
    for t in tracks:
        t.set_master_tag()
    rec_signals = [s.to_array() for s in signals]
    chirps = get_chirps(tracks, bird_labels, signals)
    max_chirps = get_max_chirps(length)
    return {
        "duration": raw_length,
        "cacophony_index": calc_cacophony_index(filter_tracks(tracks), length)[0],
        "cacophony_index_version": "2.0",
        "chirps": {"chirps": chirps, "max_chirps": max_chirps,
                   "chirp_index": 0 if max_chirps == 0 else round(100 * chirps / max_chirps),
                   "signals": rec_signals},
        "species_identify": [t.get_meta() for t in tracks],
    }


def _same(got, ref):
    """compare_results, on results whose JSON round trip is taken first."""
    got, ref = json.loads(json.dumps(got)), json.loads(json.dumps(ref))
    ref.setdefault("non_bird_tags", got.get("non_bird_tags"))
    ref.setdefault("species_identify_version", got.get("species_identify_version"))
    chip_smoke.compare_results(got, ref)


def test_batch_equals_jax_batch(model_dir, recs, batch):
    """The recordings through both BatchAnalyzers (the JAX one on its XLA
    path, the port's at the exact level)."""
    from audio_analysis_tpu.pipeline.serve import BatchAnalyzer as JaxBatchAnalyzer

    ref = JaxBatchAnalyzer([model_dir], sr=SR, bucket_seconds=9, rng=None).analyse_recordings(recs)
    assert all(r["species_identify"] for r in ref), "the fixture must produce tracks"
    for g, r in zip(batch, ref):
        assert g["chirps"]["signals"] == r["chirps"]["signals"]
        _same(g, r)


def test_batch_matches_single(model_dir, recs, batch):
    for rec, got in zip(recs, batch):
        _same(got, _single_pipeline_result(rec, model_dir))


def test_stream_matches_batch(analyzer, recs, batch):
    """Streamed in two batches, dispatch k+1 before finish k: the same
    results as one batch of all three."""
    streamed = list(analyzer.analyse_stream([recs[:2], recs[2:]]))
    assert [len(b) for b in streamed] == [2, 1]
    assert json.dumps(streamed[0] + streamed[1]) == json.dumps(batch)


def test_batch_timings_surface(analyzer, recs, monkeypatch):
    """tests/test_serve.py:185: with AAT_TIMINGS=1 analyse_recordings puts
    the batch's stage times in each result; the stream, like the JAX one,
    adds none to its results and adds every batch's stages into the timer
    it is given."""
    from audio_analysis_torch.utils.runtime import StageTimer

    monkeypatch.setenv("AAT_TIMINGS", "1")
    t = analyzer.analyse_recordings(recs[:1])[0]["timing"]
    assert {"dispatch", "detect", "plan", "post"} <= set(t)
    assert all(v >= 0 for v in t.values())
    timer = StageTimer()
    streamed = list(analyzer.analyse_stream([recs[:1], recs[1:2]], timer=timer))
    assert not any("timing" in r for b in streamed for r in b)
    assert {"dispatch", "detect", "plan", "infer", "post"} <= set(timer.stages)


def test_batch_int16_matches_float(analyzer):
    y16 = np.clip(_rec(20) * 32768.0, -32768, 32767).astype(np.int16)
    yf = y16.astype(np.float32) / 32768.0  # exactly what the device computes
    a = analyzer.analyse_recordings([y16])
    b = analyzer.analyse_recordings([yf])
    assert json.dumps(a) == json.dumps(b)


def test_batch_mixed_lengths(batch):
    assert [r["duration"] for r in batch] == pytest.approx([9.0, 8.5, 7.5])


def test_prewarm_preserves_seeded_results(model_dir):
    """prewarm() draws from a private rng: a seeded analyzer gives the same
    results whether or not it was prewarmed."""
    recs = [(np.clip(_rec(0), -1, 1) * 32767).astype(np.int16)]
    warmed = BatchAnalyzer([model_dir], sr=SR, bucket_seconds=9,
                           rng=np.random.RandomState(7), device="cpu")
    assert warmed.prewarm(batch_size=1).get("dispatch", 0) > 0
    got = warmed.analyse_recordings(recs)
    cold = BatchAnalyzer([model_dir], sr=SR, bucket_seconds=9,
                         rng=np.random.RandomState(7), device="cpu")
    assert json.dumps(got) == json.dumps(cold.analyse_recordings(recs))


def _labels_only_oracle(rec, md, model_dirs):
    from audio_analysis_torch.io.modelconfig import NON_BIRD
    from audio_analysis_torch.pipeline.analysis import SPECIES_IDENTIFY_VERSION
    from audio_analysis_torch.pipeline.ebird import filter_by_location

    res = classify_frames(rec, SR, model_dirs, True, md, rng=None, device="cpu")
    tracks = [] if res is None else res[0]
    if md is not None:
        filter_by_location(md, tracks)
    for t in tracks:
        t.set_master_tag()
    return {"non_bird_tags": NON_BIRD, "species_identify": [t.get_meta() for t in tracks],
            "species_identify_version": SPECIES_IDENTIFY_VERSION}


def test_batch_analyse_tracks_matches_single(model_dir, analyzer):
    recs = [_rec(0), _rec(1)]
    metas = [
        {"Tracks": [
            {"id": 11, "start": 1.5, "end": 4.0, "minFreq": 1000, "maxFreq": 6000},
            {"id": 12, "start": 6.5, "end": 8.5},
        ]},
        {"Tracks": [{"id": 21, "start": 0.5, "end": 3.5, "minFreq": 2000, "maxFreq": 4000}]},
    ]
    got = analyzer.analyse_recordings(recs, meta_data=metas, analyse_tracks=True)
    for rec, md, g in zip(recs, metas, got):
        ref = _labels_only_oracle(rec, md, [model_dir])
        assert json.dumps(g) == json.dumps(ref)
        assert [t["track_id"] for t in g["species_identify"]] == [t["id"] for t in md["Tracks"]]
    got2 = analyzer.analyse_recordings([recs[0]], meta_data=[None], analyse_tracks=True)
    assert got2[0]["species_identify"] == []
    assert "chirps" not in got2[0]


def test_batch_location_filter_matches_single(tmp_path):
    """Sidecar location metadata drives eBird filtering in batch serving as
    on the single path (filter_by_location before the master tags)."""
    from audio_analysis_torch.pipeline.ebird import filter_by_location

    d = _model(tmp_path / "ebird", name="ebirdnet", threshold=0.05,
               ebird_ids=[["zzz_fake_a"], ["zzz_fake_b"], None, None])
    meta = {"location": {"lat": -36.85, "lng": 174.76}}  # Auckland
    recs = [_rec(3)]
    got = BatchAnalyzer([d], sr=SR, bucket_seconds=9, rng=None, device="cpu") \
        .analyse_recordings(recs, meta_data=[meta])
    saw_filtered = False
    for rec, g in zip(recs, got):
        tracks, *_ = classify_frames(rec, SR, [d], False, None, rng=None, device="cpu")
        filter_by_location(meta, tracks)
        for t in tracks:
            t.set_master_tag()
        assert json.dumps(g["species_identify"]) == json.dumps([t.get_meta() for t in tracks])
        saw_filtered = saw_filtered or any(
            p["filtered"] for t in g["species_identify"] for r in t["model_results"]
            for p in r["predictions"]
        )
    assert saw_filtered  # the fixture exercises the filter


def test_sidecar_without_tracks_raises_on_both_paths(model_dir, analyzer):
    """A sidecar that exists without a "Tracks" key raises KeyError on both
    paths (reference src/identify_tracks.py:425); only meta_data=None gives
    the empty labels-only result."""
    rec = _rec(9)
    with pytest.raises(KeyError):
        classify_frames(rec, SR, [model_dir], True, {"foo": 1}, rng=None, device="cpu")
    with pytest.raises(KeyError):
        analyzer.analyse_recordings([rec], meta_data=[{"foo": 1}], analyse_tracks=True)
    got = analyzer.analyse_recordings([rec], meta_data=[None], analyse_tracks=True)
    assert got[0]["species_identify"] == []


@pytest.mark.parametrize("part", ["mesh", "band-pass", "embeddings"])
def test_later_parts_give_the_single_path_result(tmp_path, model_dir, analyzer, part):
    """Parts ported after batch serving give the single path's result: a
    mesh (item 12) on a gloo world of one rank, band-pass plans (item 9)
    and embeddings groups (item 10); tests/test_torch_scaleout.py,
    tests/test_torch_bandpass.py and tests/test_torch_embeddings.py hold
    them to the JAX package."""
    if part == "mesh":
        from audio_analysis_torch.parallel import distributed
        from audio_analysis_torch.parallel.mesh import make_mesh

        distributed.initialize(device="cpu")
        try:
            a = BatchAnalyzer([model_dir], sr=SR, bucket_seconds=9, rng=None,
                              mesh=make_mesh(device_type="cpu"))
            assert a.device == torch.device("cpu")
            (got,) = a.analyse_recordings([_rec(30)])
        finally:
            distributed.shutdown()
        assert got["species_identify"]
        assert got == analyzer.analyse_recordings([_rec(30)])[0]
    elif part == "band-pass":
        d = _model(tmp_path / "bp", filter_below=20000)
        a = BatchAnalyzer([d], sr=SR, bucket_seconds=9, rng=None, device="cpu")
        (got,) = a.analyse_recordings([_rec(30)])
        assert got["species_identify"]
        _same(got, _single_pipeline_result(_rec(30), d))
    else:
        d = str(chip_smoke.embeddings_head(
            tmp_path / "emb", chip_smoke.embedder_fixture(tmp_path / "embedder.keras")))
        a = BatchAnalyzer([d], sr=SR, bucket_seconds=9, rng=None, device="cpu")
        (got,) = a.analyse_recordings([_rec(30)])
        assert got["species_identify"]
        _same(got, _single_pipeline_result(_rec(30), d))


def test_batch_needs_cuda_unless_cpu_is_asked_for(model_dir):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchAnalyzer([model_dir])


def _cli_json(run, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run(argv)
    out = json.loads(buf.getvalue())
    for r in out:
        r["analysis"].pop("processing_time_seconds")
    return out


def test_batch_cli_json_equals_jax_batch_cli(tmp_path, model_dir):
    from audio_analysis_torch.cli.batch import run as torch_run
    from audio_analysis_torch.io.audio import write_wav
    from audio_analysis_tpu.cli.batch import run as jax_run

    wavs = []
    for i, (seconds, silent_from) in enumerate([(12, 10.0), (9, 9.0)]):
        w = tmp_path / f"rec{i}.wav"
        write_wav(w, chip_smoke.make_recording(seconds=seconds, silent_from=silent_from,
                                               seed=11 + i), SR)
        wavs.append(str(w))
    argv = ["-o", "--bird-model", model_dir, "--seed", "0", "--batch-size", "2", *wavs]
    ref = _cli_json(jax_run, argv)
    got = _cli_json(torch_run, argv + ["--device", "cpu"])
    assert [r["file"] for r in got] == [r["file"] for r in ref] == wavs
    assert all(r["analysis"]["species_identify"] for r in ref), "the fixture must produce tracks"
    for g, r in zip(got, ref):
        chip_smoke.compare_results(g["analysis"], r["analysis"])
    assert _without_confidences(got) == _without_confidences(ref)


def _without_confidences(obj):
    if isinstance(obj, dict):
        return {k: _without_confidences(v) for k, v in obj.items() if k != "confidence"}
    if isinstance(obj, list):
        return [_without_confidences(v) for v in obj]
    return obj


def test_spool_scan_equals_jax(tmp_path):
    """The batch daemon's spool scan (``_pending``) and the directory
    expansion (``_expand_dirs``) pick the same files as the JAX package's."""
    from audio_analysis_torch.cli import batch as tb
    from audio_analysis_tpu.cli import batch as jb

    for name in ("a.wav", "b.WAV", "c.txt", "d.flac", "e.mp3"):
        (tmp_path / name).write_bytes(b"x")
    (tmp_path / "b.txt").write_text(json.dumps({"analysis_result": {}}))  # done
    (tmp_path / "d.txt").write_text("{not json")  # unreadable sidecar
    (tmp_path / "sub").mkdir()
    got = [tb._pending(tmp_path, 0, set(), {}) for _ in range(2)]
    ref = [jb._pending(tmp_path, 0, set(), {}) for _ in range(2)]
    assert got == ref and [p.name for p in got[0]] == ["a.wav", "e.mp3"]
    assert tb._expand_dirs([str(tmp_path), "x.wav"]) == jb._expand_dirs([str(tmp_path), "x.wav"])
