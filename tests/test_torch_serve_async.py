"""The port's upload path in batch serving and the single-recording path
(``pipeline/serve.py``'s ``_prepare`` / ``_dispatch_prepared``,
``pipeline/classify.py``'s codec upload) on the CPU: the stream gives the
same results, on the caller's thread, whatever AAT_ASYNC_UPLOAD and
AAT_ENCODE_AHEAD say (the port does not run the JAX package's worker
threads), with the wire codec on and off, equal to the JAX package's
``analyse_stream`` (tests/test_serve.py:110-170); the codec batch and CLI
equal the raw ones on mixed lengths that are not multiples of the codec's
block (tests/test_serve.py:194, tests/test_pcmcodec.py:177); an exception in
a batch's prepare or dispatch reaches the caller; at step k the stream
dispatches batch k+1, queues batch k and collects batch k-1, and its
results equal ``analyse_recordings`` batch by batch, bit for bit, with
each batch's thresholds applied between the previous batch's yield and its
own; the dispatched tensors are inference tensors."""

import json
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from audio_analysis_torch.io.pcmcodec import BLOCK
from audio_analysis_torch.pipeline import classify, serve
from audio_analysis_torch.pipeline.serve import BatchAnalyzer
from audio_analysis_torch.utils.runtime import StageTimer

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from test_torch_serve import SR, _model, _rec, _same  # noqa: E402

# the JAX package's dispatch modes; the port ignores both variables
MODES = {
    "sync": {"AAT_ASYNC_UPLOAD": "0"},
    "async-default": {},
    "async": {"AAT_ASYNC_UPLOAD": "1", "AAT_ENCODE_AHEAD": "0"},
    "encode-ahead": {"AAT_ASYNC_UPLOAD": "1", "AAT_ENCODE_AHEAD": "1"},
}


def _i16(y):
    return np.clip(y * 32768.0, -32768, 32767).astype(np.int16)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return _model(tmp_path_factory.mktemp("asyncmodel") / "m")


@pytest.fixture(scope="module")
def batches():
    """Three batches of int16 recordings whose lengths are not multiples of
    BLOCK (the bucket is 9 s, 432000 samples: BLOCK rounds it up)."""
    lengths = [9 * SR, int(8.5 * SR) + 13, int(7.5 * SR) + 101, 8 * SR + 7, 9 * SR - 3]
    recs = [_i16(_rec(40 + i))[:n] for i, n in enumerate(lengths)]
    assert all(len(r) % BLOCK for r in recs[1:]) and (9 * SR) % BLOCK
    return [recs[:2], recs[2:4], recs[4:]]


def _set_env(monkeypatch, env, codec):
    for k in ("AAT_ASYNC_UPLOAD", "AAT_ENCODE_AHEAD"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("AAT_WIRE_CODEC", codec)


def _stream(model_dir, batches, timer=None):
    a = BatchAnalyzer([model_dir], sr=SR, bucket_seconds=9, rng=None, device="cpu")
    return list(a.analyse_stream(batches, timer=timer))


@pytest.fixture(scope="module")
def reference(model_dir, batches):
    """The synchronous stream with the codec off, and the JAX package's
    stream (its default modes) on the same batches."""
    from audio_analysis_tpu.pipeline.serve import BatchAnalyzer as JaxBatchAnalyzer

    with pytest.MonkeyPatch.context() as m:
        _set_env(m, MODES["sync"], "0")
        port = _stream(model_dir, batches)
    jax = list(JaxBatchAnalyzer([model_dir], sr=SR, bucket_seconds=9,
                                rng=None).analyse_stream(batches))
    assert all(r["species_identify"] for b in jax for r in b), "the fixture must produce tracks"
    return port, jax


@pytest.mark.parametrize("codec", ["1", "0"], ids=["codec", "raw"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_stream_modes_give_identical_results(model_dir, batches, reference, monkeypatch,
                                             mode, codec):
    """Every mode setting and codec setting gives the synchronous raw
    stream's results byte for byte, in batch order, and the JAX package's
    within the result contract; the codec runs once a batch when it is on,
    on the caller's thread; every stage reaches the caller's timer."""
    _set_env(monkeypatch, MODES[mode], codec)
    encodes = []
    real = serve.encode_pcm
    monkeypatch.setattr(serve, "encode_pcm",
                        lambda x: encodes.append((x.shape, threading.current_thread()))
                        or real(x))
    timer = StageTimer()
    got = _stream(model_dir, batches, timer)
    port, jax = reference
    assert json.dumps(got) == json.dumps(port)
    assert [len(b) for b in got] == [len(b) for b in batches]
    for g, r in zip(sum(got, []), sum(jax, [])):
        _same(g, r)
    t_bucket = -(-9 * SR // BLOCK) * BLOCK
    caller = threading.current_thread()
    assert encodes == ([((len(b), t_bucket), caller) for b in batches] if codec == "1" else [])
    assert {"dispatch", "detect", "plan", "post"} <= set(timer.stages)
    assert "dispatch_wait" not in timer.stages


def test_codec_batch_equals_raw(model_dir, batches, monkeypatch):
    """tests/test_serve.py:194 on mixed lengths: AAT_WIRE_CODEC=1 serving is
    byte-identical to the raw int16 upload, though its bucket is BLOCK
    longer."""
    recs = batches[0] + batches[1]
    out = {}
    for codec in ("1", "0"):
        monkeypatch.setenv("AAT_WIRE_CODEC", codec)
        a = BatchAnalyzer([model_dir], sr=SR, bucket_seconds=9, rng=None, device="cpu")
        out[codec] = a.analyse_recordings(recs)
    assert json.dumps(out["1"]) == json.dumps(out["0"])
    assert all(r["species_identify"] for r in out["1"])


@pytest.mark.parametrize("n", [9 * SR - 3, int(7.5 * SR) + 101], ids=["9s-3", "7.5s+101"])
def test_codec_cli_equals_raw(model_dir, monkeypatch, n):
    """tests/test_pcmcodec.py:177: classify_frames' codec upload gives the
    raw upload's result, on lengths that are not multiples of BLOCK."""
    y = _i16(_rec(50))[:n]
    uploads = []
    real = classify.upload_pcm
    monkeypatch.setattr(classify, "upload_pcm", lambda *a: uploads.append(1) or real(*a))
    out = {}
    for codec in ("1", "0"):
        monkeypatch.setenv("AAT_WIRE_CODEC", codec)
        tracks, length, signals, *_ = classify.classify_frames(y, SR, [model_dir], False, None,
                                                               rng=None, device="cpu")
        out[codec] = ([t.get_meta() for t in tracks], length, [s.to_array() for s in signals])
    assert uploads == [1]
    assert json.dumps(out["1"], default=str) == json.dumps(out["0"], default=str)
    assert out["1"][0], "the fixture must produce tracks"


@pytest.mark.parametrize("where", ["prepare", "dispatch"])
@pytest.mark.parametrize("mode", ["async", "encode-ahead"])
def test_dispatch_exception_reaches_the_caller(model_dir, batches, monkeypatch, mode, where):
    """An exception raised in the third batch's prepare (the codec's
    encode) or dispatch, which the stream runs before it collects the
    first batch, comes out of the stream after the first batch's results
    (the one batch queued before it), raised on the caller's thread, and
    no thread is started, whatever the JAX package's mode variables say."""
    _set_env(monkeypatch, MODES[mode], "1")

    class Boom(Exception):
        pass

    calls = []
    target = "encode_pcm" if where == "prepare" else "detect_batch_dispatch"
    real = getattr(serve, target)

    def failing(*a, **k):
        calls.append(threading.current_thread())
        if len(calls) == 3:
            raise Boom(where)
        return real(*a, **k)

    monkeypatch.setattr(serve, target, failing)
    before = set(threading.enumerate())
    a = BatchAnalyzer([model_dir], sr=SR, bucket_seconds=9, rng=None, device="cpu")
    stream = a.analyse_stream(batches)
    assert len(next(stream)) == len(batches[0])
    with pytest.raises(Boom, match=where):
        next(stream)
    assert calls == [threading.current_thread()] * 3
    assert set(threading.enumerate()) == before


@pytest.mark.parametrize("bad", [0, 1, 2])
def test_queue_exception_reaches_the_caller_after_the_batches_before(model_dir, batches, bad):
    """A sidecar without "Tracks" raises KeyError in its batch's queue
    half; the stream first yields every batch before it, then raises, and
    yields nothing after: the last batch's queue runs when the input ends,
    the others' while the next batch is dispatched."""
    metas = [[{"Tracks": []} for _ in b] for b in batches]
    metas[bad][0] = {}
    a = BatchAnalyzer([model_dir], sr=SR, bucket_seconds=9, rng=None, device="cpu")
    stream = a.analyse_stream(batches, meta_batches=metas, analyse_tracks=True)
    for k in range(bad):
        assert len(next(stream)) == len(batches[k])
    with pytest.raises(KeyError, match="Tracks"):
        next(stream)
    assert next(stream, None) is None


@pytest.mark.parametrize("multihost", [True, False], ids=["multi-rank", "one-rank"])
def test_multi_rank_serving_dispatches_on_the_callers_thread(model_dir, batches, reference,
                                                             monkeypatch, multihost):
    """Multi-rank serving and one rank both dispatch on the caller's thread
    whatever AAT_ASYNC_UPLOAD says (a rank's feed check runs collectives,
    whose order must match on every rank). The ranks' collectives are stood
    in for by a world of one."""
    _set_env(monkeypatch, MODES["async"], "0")
    threads = []
    real = BatchAnalyzer._dispatch_prepared
    monkeypatch.setattr(BatchAnalyzer, "_dispatch_prepared",
                        lambda self, prep: threads.append(threading.current_thread())
                        or real(self, prep))
    if multihost:
        monkeypatch.setattr(BatchAnalyzer, "_multihost", property(lambda self: True))
        monkeypatch.setattr(BatchAnalyzer, "_check_feeds", lambda self, recs: None)
        monkeypatch.setattr(BatchAnalyzer, "_gather", lambda self, results, timer: results)
    got = _stream(model_dir, batches)
    assert json.dumps(got) == json.dumps(reference[0])
    assert len(threads) == len(batches)
    on_caller = [t is threading.current_thread() for t in threads]
    assert on_caller == [True] * len(batches)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_dispatch_makes_inference_tensors_on_any_thread(model_dir, batches, monkeypatch, mode):
    """The device halves enter torch.inference_mode themselves: the
    uploaded PCM is an inference tensor whatever the mode variables say,
    and the caller is left outside the mode."""
    import torch

    _set_env(monkeypatch, MODES[mode], "1")
    frames = []
    real = BatchAnalyzer._queue
    monkeypatch.setattr(BatchAnalyzer, "_queue",
                        lambda self, handle, timer: frames.append(handle[1])
                        or real(self, handle, timer))
    _stream(model_dir, batches[:2])
    assert len(frames) == 2 and all(f.is_inference() for f in frames)
    assert not torch.is_inference_mode_enabled()


# the order and batch-by-batch tests: 3 s buckets and 1 s windows keep each
# batch's classify (64 windows after the bucket padding) cheap
SHORT = 3


@pytest.fixture(scope="module")
def short_models(tmp_path_factory):
    """On 1 s windows: a TuiNet; and a band-passed TuiNet (``filter_below``)
    with an embeddings pre-model group over a dense ``net_pool``
    embedder."""
    d = tmp_path_factory.mktemp("shortmodels")
    windows = dict(segment_length=1.0, segment_stride=0.5)
    rng = np.random.RandomState(9)
    embedder, head = d / "embedder", d / "head"
    embedder.mkdir()
    np.savez(embedder / "weights.npz", **{"0/kernel": (0.5 * rng.randn(320, 32)).astype(np.float32),
                                          "0/bias": np.zeros(32, np.float32)})
    (embedder / "metadata.txt").write_text(json.dumps(
        {"architecture": "dense", "net_pool": 320, "output_activation": "linear", "labels": []}))
    head.mkdir()
    np.savez(head / "weights.npz", **{"0/kernel": rng.randn(32, 4).astype(np.float32),
                                      "0/bias": np.zeros(4, np.float32)})
    (head / "metadata.txt").write_text(json.dumps(
        {"architecture": "dense", "name": "embeddings", "labels": ["bird", "kiwi", "tui", "noise"],
         "embedding_model": str(embedder), "segment_stride": 5, "threshold": 0.3,
         "pre_model": True}))
    return {"tuinet": [_model(d / "tuinet", **windows)],
            "bandpass_embeddings": [_model(d / "bandpass", filter_below=9000, **windows),
                                    str(head)]}


def _short_rec(seed, call=True):
    """int16, SHORT s a little shortened, with a chirp at 1 s and digital
    silence from 2.8 s, or noise alone."""
    import chip_smoke

    n = SHORT * SR
    y = (chip_smoke.make_recording(seconds=SHORT, silent_from=2.8, seed=seed) if call
         else 0.01 * np.random.RandomState(seed).randn(n).astype(np.float32))
    return _i16(y)[: n - 37 * (seed % 3)]


def _order(n):
    """The stream's calls over n batches: dispatch k+1, queue k, collect
    k-1 at each step, then the last queue and the two last collects."""
    out = []
    for k in range(n):
        out.append(("dispatch", k))
        if k >= 1:
            out.append(("queue", k - 1))
        if k >= 2:
            out.append(("collect", k - 2))
    if n:
        out.append(("queue", n - 1))
    out += [("collect", k) for k in range(max(0, n - 2), n)]
    return out


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_stream_dispatches_the_next_batch_before_finishing(short_models, monkeypatch, n):
    """The stream is pipelined on the caller's thread: batch k+1 is
    dispatched and batch k's classify queued before batch k-1 is collected,
    so the device runs classify k-1 while the host stacks batch k+1 and
    labels and plans batch k; each batch's results are yielded right after
    its collect, in batch order. (The tracks come from sidecars, here none,
    so the batches cost next to nothing: the order does not depend on what
    they hold.)"""
    _set_env(monkeypatch, MODES["async-default"], "0")
    order, ids = [], {}  # the batch number of each live handle, by id
    real = {k: getattr(BatchAnalyzer, f"_{k}") for k in ("dispatch", "queue", "collect")}

    def dispatch(self, recs, *a):
        handle = real["dispatch"](self, recs, *a)
        ids[id(handle)] = sum(step[0] == "dispatch" for step in order)
        order.append(("dispatch", ids[id(handle)]))
        return handle

    def queue(self, handle, timer):
        order.append(("queue", ids[id(handle)]))
        queued = real["queue"](self, handle, timer)
        ids[id(queued)] = ids[id(handle)]
        return queued

    def collect(self, queued, timer, **k):
        order.append(("collect", ids[id(queued)]))
        return real["collect"](self, queued, timer, **k)

    for name, fn in (("dispatch", dispatch), ("queue", queue), ("collect", collect)):
        monkeypatch.setattr(BatchAnalyzer, f"_{name}", fn)
    batches = [[_short_rec(60 + k)] * (1 + k % 2) for k in range(n)]
    a = BatchAnalyzer(short_models["tuinet"], sr=SR, bucket_seconds=SHORT, rng=None,
                      device="cpu")
    got = []
    for results in a.analyse_stream(batches, analyse_tracks=True):
        order.append(("yield", len(got)))
        got.append(results)
    want = []
    for step in _order(n):
        want.append(step)
        if step[0] == "collect":
            want.append(("yield", step[1]))
    assert order == want
    assert [len(b) for b in got] == [len(b) for b in batches]


# -- the stream against analyse_recordings, batch by batch ---------------------

# (kind, batches streamed): tracks detected by a TuiNet over streams of every
# length the pipeline treats apart (empty, shorter than it, filling it, longer);
# tracks from sidecars through a band-passed group and an embeddings group
STREAMS = [("detect", n) for n in (0, 1, 2, 3, 5)] + [("tracks", 3)]


@pytest.fixture(scope="module")
def stream_cases(short_models):
    """Per kind: the models, the batches and their sidecars (None: tracks
    are detected). ``detect``: five batches, the second without a call, so
    without a track, the third of two recordings. ``tracks``: the first
    three, the second's sidecar without tracks, a recording of the third
    without one."""
    recs = [[_short_rec(70 + k)] for k in range(5)]
    recs[1] = [_short_rec(80, call=False)]
    recs[2].append(_short_rec(81))
    track = lambda i, start: {"id": i, "start": start, "end": start + 0.8, "minFreq": 2000,
                              "maxFreq": 4000}
    metas = [[{"Tracks": [track(0, 0.5), track(1, 1.7)]}], [{"Tracks": []}],
             [{"Tracks": [track(20, 0.9)]}, None]]
    return {"detect": (short_models["tuinet"], recs, None),
            "tracks": (short_models["bandpass_embeddings"], recs[:3], metas)}


def _thresholds_log(monkeypatch, log):
    """Every apply_thresholds call, the spectral groups' (``serve``'s name,
    which the benchmark patches) and the embeddings groups'
    (``classify``'s), as ("thresholds", probabilities)."""
    for module in (serve, classify):
        real = module.apply_thresholds

        def logged(tracks, probs, windows, cfg, real=real):
            log.append(("thresholds", np.array(probs, copy=True)))
            return real(tracks, probs, windows, cfg)

        monkeypatch.setattr(module, "apply_thresholds", logged)


@pytest.fixture(scope="module")
def stream_references(stream_cases):
    """Per kind, each batch through ``analyse_recordings`` on one analyzer
    (rng seeded 0, batches in order): the results and the thresholds
    calls."""
    out = {}
    for kind, (models, recs, metas) in stream_cases.items():
        a = BatchAnalyzer(models, sr=SR, bucket_seconds=SHORT, rng=np.random.RandomState(0),
                          device="cpu")
        per_batch = []
        for k, batch in enumerate(recs):
            log = []
            with pytest.MonkeyPatch.context() as m:
                _thresholds_log(m, log)
                results = a.analyse_recordings(
                    batch, meta_data=metas[k] if metas else None, analyse_tracks=bool(metas))
            per_batch.append((results, log))
        out[kind] = per_batch
    return out


@pytest.mark.parametrize("kind,n", STREAMS, ids=[f"{k}-{n}" for k, n in STREAMS])
def test_stream_equals_analyse_recordings(stream_cases, stream_references, monkeypatch,
                                          kind, n):
    """The reordered stream over its first n batches: every batch's results
    equal ``analyse_recordings``' bit for bit (the window plans drawn from
    the rng in batch order), all of them yielded when the input ends, and
    each batch's thresholds calls, with the same probabilities, fall
    between the previous batch's yield and its own."""
    models, recs, metas = stream_cases[kind]
    refs = stream_references[kind][:n]
    calls = [len(log) for _, log in refs]
    if kind == "tracks":  # a spectral call a recording, an embeddings call a recording with tracks
        assert calls == [2, 0, 3]
    elif n == 5:
        assert calls[1] == 0 and all(calls[k] for k in (0, 2, 3, 4)), calls
    log = []
    _thresholds_log(monkeypatch, log)
    a = BatchAnalyzer(models, sr=SR, bucket_seconds=SHORT, rng=np.random.RandomState(0),
                      device="cpu")
    got = []
    stream = (a.analyse_stream(recs[:n], meta_batches=metas[:n], analyse_tracks=True)
              if metas else a.analyse_stream(recs[:n]))
    for results in stream:
        log.append(("yield", len(got)))
        got.append(results)
    assert json.dumps(got) == json.dumps([r for r, _ in refs])
    want = []
    for _, batch_calls in refs:
        want += [c[0] for c in batch_calls] + ["yield"]
    assert [e[0] for e in log] == want
    got_probs = [e[1] for e in log if e[0] == "thresholds"]
    ref_probs = [c[1] for _, batch_calls in refs for c in batch_calls]
    assert all(np.array_equal(g, r) for g, r in zip(got_probs, ref_probs))
