"""The port's upload path in batch serving and the single-recording path
(``pipeline/serve.py``'s ``_prepare`` / ``_dispatch_prepared``,
``pipeline/classify.py``'s codec upload) on the CPU: the stream gives the
same results, on the caller's thread, whatever AAT_ASYNC_UPLOAD and
AAT_ENCODE_AHEAD say (the port does not run the JAX package's worker
threads), with the wire codec on and off, equal to the JAX package's
``analyse_stream`` (tests/test_serve.py:110-170); the codec batch and CLI
equal the raw ones on mixed lengths that are not multiples of the codec's
block (tests/test_serve.py:194, tests/test_pcmcodec.py:177); an exception in
a batch's prepare or dispatch reaches the caller; the stream dispatches
batch k+1 before it finishes batch k; the dispatched tensors are inference
tensors."""

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
    encode) or dispatch, which the stream runs before it finishes the
    second batch, comes out of the stream after the first batch's results,
    raised on the caller's thread, and no thread is started, whatever the
    JAX package's mode variables say."""
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
    real = BatchAnalyzer._finish
    monkeypatch.setattr(BatchAnalyzer, "_finish",
                        lambda self, handle, **k: frames.append(handle[1]) or real(self, handle, **k))
    _stream(model_dir, batches[:2])
    assert len(frames) == 2 and all(f.is_inference() for f in frames)
    assert not torch.is_inference_mode_enabled()


def test_stream_dispatches_the_next_batch_before_finishing(model_dir, batches, monkeypatch):
    """The stream is pipelined on the caller's thread: batch k+1's dispatch
    is queued before batch k is finished, so the device runs the next
    batch's detection while the host finishes the current one."""
    _set_env(monkeypatch, MODES["async-default"], "0")
    order = []
    real_dispatch, real_finish = BatchAnalyzer._dispatch, BatchAnalyzer._finish
    monkeypatch.setattr(BatchAnalyzer, "_dispatch",
                        lambda self, recs, *a: order.append(("dispatch", len(recs)))
                        or real_dispatch(self, recs, *a))
    monkeypatch.setattr(BatchAnalyzer, "_finish",
                        lambda self, handle, **k: order.append(("finish", handle[4]))
                        or real_finish(self, handle, **k))
    got = _stream(model_dir, batches)
    n = [len(b) for b in batches]
    assert order == [("dispatch", n[0]), ("dispatch", n[1]), ("finish", n[0]),
                     ("dispatch", n[2]), ("finish", n[1]), ("finish", n[2])]
    assert [len(b) for b in got] == n
