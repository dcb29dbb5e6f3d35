"""The port's embeddings groups (``pipeline/embeddings.py``, the embeddings
branch of ``classify_frames`` and of ``BatchAnalyzer``) against the JAX
package on the CPU: the track windows (track ends on and just past a
window's end, a window running off the recording, a fractional stride),
the embeddings of int16 and float PCM through a ``dense`` + ``net_pool``
embedder and the seeded two-output Conv1D ``.keras`` embedder, an
embeddings group before and after a TuiNet group, batch serving with an
embeddings group alone, beside a TuiNet and beside a band-pass model, and
the embedder loader's refusals."""

import importlib.util
import json
import shutil
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from audio_analysis_tpu.pipeline import embeddings as jemb
from audio_analysis_tpu.pipeline.classify import classify_frames as j_classify
from audio_analysis_tpu.pipeline.serve import BatchAnalyzer as JBatchAnalyzer

from audio_analysis_torch.pipeline import embeddings as emb
from audio_analysis_torch.pipeline.classify import classify_frames
from audio_analysis_torch.pipeline.serve import BatchAnalyzer

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (fixture writers and the result contract)

SR = 48000


def TRACK(start, end):
    """A track as the window loop reads it."""
    return SimpleNamespace(start=start, end=end)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The seeded Conv1D embedder (chip_smoke.embedder_fixture), its Dense
    head as the first group and as a pre-model group, a narrow float32
    TuiNet as either, a band-pass TuiNet, and a dense + net_pool embedder
    with its head."""
    d = tmp_path_factory.mktemp("embeddings")
    embedder = chip_smoke.embedder_fixture(d / "embedder" / "audioModel.keras")
    head = chip_smoke.embeddings_head(d / "head", embedder)

    def tui(name, **meta):
        return str(chip_smoke.write_tuinet_model(d / name, seed=1, channels=(8, 16), stem=8,
                                                 dense=16, n_mels=40, name=name, **meta))

    dense = d / "dense-embedder"
    dense.mkdir()
    rng = np.random.RandomState(9)
    np.savez(dense / "weights.npz", **{"0/kernel": (0.5 * rng.randn(320, 32)).astype(np.float32),
                                       "0/bias": np.zeros(32, np.float32)})
    (dense / "metadata.txt").write_text(json.dumps(
        {"architecture": "dense", "net_pool": 320, "output_activation": "linear", "labels": []}))
    return dict(
        embedder=embedder, head=str(head),
        head_pre=str(chip_smoke.embeddings_head(d / "head-pre", embedder, pre_model=True)),
        dense=dense,
        dense_head=str(_dense_head(d / "dense-head", dense)),
        tui=tui("tui"), tui_pre=tui("tui-pre", pre_model=True),
        bandpass=tui("bandpass", filter_below=9000),
    )


def _dense_head(d, embedder):
    """A head over the dense embedder's 32-wide output."""
    d.mkdir()
    rng = np.random.RandomState(3)
    np.savez(d / "weights.npz", **{"0/kernel": rng.randn(32, 4).astype(np.float32),
                                   "0/bias": np.zeros(4, np.float32)})
    (d / "metadata.txt").write_text(json.dumps(
        {"architecture": "dense", "name": "embeddings", "labels": ["bird", "kiwi", "tui", "noise"],
         "embedding_model": str(embedder), "segment_stride": 5, "threshold": 0.3}))
    return d


@pytest.mark.parametrize("tracks,stride", [
    ([TRACK(0.5, 5.5), TRACK(0.5, 5.5 - 1e-9)], 5),  # an end on a window's end, just short
    ([TRACK(1.0, 3.0), TRACK(2.25, 9.0)], 1),
    ([TRACK(8.0, 11.9)], 2),  # windows run off the 10 s recording
], ids=["end-on-boundary", "stride-1", "off-the-end"])
def test_chirp_windows_match_jax(tracks, stride):
    """The reference's slices (the JAX package's host windows) against the
    port's starts laid out on the host and gathered on the device: the
    same windows, bit for bit, and the same count a track."""
    rec = np.random.RandomState(0).randn(10 * emb.EMBED_SR).astype(np.float32)
    want = jemb.get_chirp_samples(rec, tracks, sr=emb.EMBED_SR, stride=stride)
    got, counts = emb.get_chirp_samples(torch.from_numpy(rec), tracks, stride=stride)
    assert counts == [len(t) for t in want]
    np.testing.assert_array_equal(got.numpy(), np.stack([w for t in want for w in t]))
    if stride == 5:
        assert counts == [2, 1]


def test_fractional_stride_fails_as_the_reference_slice_does():
    """A stride of 1.5 s makes the second start a float: numpy's slice
    refuses it in the JAX package (and the reference); the port refuses it
    alike, with a TypeError."""
    rec = np.zeros(10 * emb.EMBED_SR, np.float32)
    tracks = [TRACK(0.0, 8.0)]
    with pytest.raises(TypeError):
        jemb.get_chirp_samples(rec, tracks, sr=emb.EMBED_SR, stride=1.5)
    with pytest.raises(TypeError):
        emb.get_chirp_samples(torch.from_numpy(rec), tracks, stride=1.5)
    got, counts = emb.get_chirp_samples(torch.from_numpy(rec), [TRACK(0.0, 4.0)], stride=1.5)
    assert counts == [1]  # one window: the float start is never sliced


@pytest.mark.parametrize("kind", ["dense", "keras"])
@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_chirp_embeddings_match_jax(models, kind, dtype):
    """int16 PCM is scaled by 1/32768 before the 48 -> 32 kHz resample; the
    multi-output embedder gives its second output. Limit: max abs 1e-4 of
    the embeddings' largest magnitude (float32 resamplers and convs)."""
    y = chip_smoke.make_recording(seconds=12, silent_from=12.0, seed=6)
    frames = (y * 32767).astype(np.int16) if dtype == "int16" else y
    tracks = [TRACK(0.4, 3.1), TRACK(4.0, 10.5)]
    path = models["dense" if kind == "dense" else "embedder"]
    want = jemb.chirp_embeddings(frames, SR, tracks, 5, embedder=jemb.load_embedder(str(path)))
    want = np.stack([np.asarray(e) for t in want for e in t])
    got, counts = emb.chirp_embeddings(torch.from_numpy(frames), SR, tracks, 5,
                                       emb.load_embedder(str(path), "cpu"))
    assert counts == [1, 2]
    assert got.shape == want.shape == (3, 32 if kind == "dense" else chip_smoke.EMBED_DIM)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())


def _result(tracks, length, signals, raw_length, labels):
    from audio_analysis_torch.pipeline.cacophony import (
        calc_cacophony_index, filter_tracks, get_chirps, get_max_chirps,
    )

    for t in tracks:
        t.set_master_tag()
    return json.loads(json.dumps({
        "duration": raw_length, "length": length, "signals": [s.to_array() for s in signals],
        "chirps": get_chirps(tracks, labels, signals), "max_chirps": get_max_chirps(length),
        "cacophony_index": calc_cacophony_index(filter_tracks(tracks), length)[0],
        "species_identify": [t.get_meta() for t in tracks],
    }))


@pytest.mark.parametrize("order", ["before", "after", "dense"])
def test_classify_with_an_embeddings_group_matches_jax(models, order):
    """An embeddings group before a TuiNet (pre-model) group, after a TuiNet
    group, and the dense embedder's group alone: the result JSON equal to
    the JAX package's, each track's results in the groups' order."""
    names = {"before": ["head", "tui_pre"], "after": ["tui", "head_pre"],
             "dense": ["dense_head"]}[order]
    paths = [str(models[n]) for n in names]
    y = chip_smoke.make_recording(seconds=16, silent_from=13.0, seed=3)
    want = _result(*j_classify(y, SR, paths, False, None, rng=np.random.RandomState(0)))
    got = _result(*classify_frames(y, SR, paths, False, None, rng=np.random.RandomState(0),
                                   device="cpu"))
    assert want["species_identify"], "the fixture must produce tracks"
    results = [[r["model"] for r in t["model_results"]] for t in want["species_identify"]]
    assert results[0][0 if order != "after" else -1] == "embeddings"
    chip_smoke.compare_results(got, want, confidence_tol=0)
    assert got == want


@pytest.mark.parametrize("group", ["alone", "tuinet", "bandpass"])
def test_batch_with_an_embeddings_group_matches_jax(models, group):
    """BatchAnalyzer with an embeddings group alone (no window plan), after
    a TuiNet group, and after a band-pass TuiNet (the embeddings group
    reads the raw PCM): results equal to the JAX package's BatchAnalyzer."""
    paths = {"alone": [models["head"]], "tuinet": [models["tui"], models["head_pre"]],
             "bandpass": [models["bandpass"], models["head_pre"]]}[group]
    recs = [chip_smoke.make_recording(seconds=10, silent_from=9.0, seed=s) for s in (7, 8)]
    want = JBatchAnalyzer(paths, sr=SR, bucket_seconds=10,
                          rng=np.random.RandomState(0)).analyse_recordings(recs)
    got = BatchAnalyzer(paths, sr=SR, bucket_seconds=10, rng=np.random.RandomState(0),
                        device="cpu").analyse_recordings(recs)
    assert all(r["species_identify"] for r in want), "every recording must have tracks"
    assert all(len(t["model_results"]) == len(paths) for r in want for t in r["species_identify"])
    for g, w in zip(got, want):
        chip_smoke.compare_results(g, w, confidence_tol=0)
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))


def test_batch_with_embeddings_alone_draws_nothing_from_the_rng(models):
    """An analyzer with embeddings groups only plans no windows, so its rng
    is left as the single path leaves it."""
    rng = np.random.RandomState(0)
    BatchAnalyzer([models["head"]], sr=SR, bucket_seconds=10, rng=rng, device="cpu") \
        .analyse_recordings([chip_smoke.make_recording(seconds=10, silent_from=9.0, seed=7)])
    assert rng.randint(1 << 30) == np.random.RandomState(0).randint(1 << 30)


def test_embedder_loader_refuses_as_it_should(models, tmp_path):
    """No path: the JAX package would download the TF-Hub embedder; the port
    raises RuntimeError (so does the JAX package without tensorflow_hub). A
    missing artifact raises FileNotFoundError in both. A SavedModel dir is
    read from its current converted copy; without one both convert it, and
    the placeholder saved_model.pb fails in both alike: ModuleNotFoundError
    without tensorflow, tf.saved_model.load's ValueError with it."""
    with pytest.raises(RuntimeError, match="embedding_model"):
        emb.load_embedder(None, "cpu")
    if importlib.util.find_spec("tensorflow_hub") is None:
        with pytest.raises(RuntimeError, match="embedding_model"):
            jemb.load_embedder(None)
    with pytest.raises(FileNotFoundError):
        emb.load_embedder(str(tmp_path / "nowhere"), "cpu")
    with pytest.raises(FileNotFoundError):
        jemb.load_embedder(str(tmp_path / "nowhere"))
    saved = tmp_path / "saved"
    (saved / ".aat_native").mkdir(parents=True)
    (saved / "saved_model.pb").write_bytes(b"")
    errors = []
    for hide in (True, False):
        if not hide and importlib.util.find_spec("tensorflow") is None:
            continue
        with pytest.MonkeyPatch.context() as m:
            if hide:
                for name in ("tensorflow", "tf_keras"):
                    m.setitem(sys.modules, name, None)
            for load in (lambda: emb.load_embedder(str(saved), "cpu"),
                         lambda: jemb.load_embedder(str(saved))):
                with pytest.raises(ModuleNotFoundError if hide else ValueError) as e:
                    load()
                errors.append(str(e.value))
    assert errors[0::2] == errors[1::2]
    assert not (saved / ".aat_native" / ".stamp").exists()
    shutil.copy(models["embedder"], saved / ".aat_native" / "audioModel.keras")
    (saved / ".aat_native" / ".stamp").write_text(str((saved / "saved_model.pb").stat().st_mtime_ns))
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 5 * emb.EMBED_SR).astype(np.float32))
    with torch.inference_mode():
        torch.testing.assert_close(emb.load_embedder(str(saved), "cpu")(x)[1],
                                   emb.load_embedder(str(models["embedder"]), "cpu")(x)[1])
