"""Batch serving's dispatch and queue halves leave the device's queue alone
(``pipeline/serve.py``'s ``_dispatch`` and ``_queue``).

On a card (marked ``cuda``): with ~200 ms of work queued ahead of them,
both return while that work still runs, so no pageable copy or other wait
remains in them, and the collected results then equal the serial
``_finish``'s. On the CPU: ``gather_windows``, ``_track_means`` and
``detect_batch_mask`` send their host arrays through
``device.py::to_device_async`` and give the outputs the direct copies gave.

This file imports neither jax nor the JAX package and uses no conftest
fixture, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_stream_overlap.py
"""

import json

import numpy as np
import pytest
import torch

from audio_analysis_torch.detect import signal_noise
from audio_analysis_torch.pipeline import classify, samples, serve
from audio_analysis_torch.pipeline.samples import WindowPlan
from audio_analysis_torch.utils.runtime import StageTimer
from test_torch_serve import SR, _model, _rec


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the queue's order is the card's")
    return torch.device("cuda")


def _spy(monkeypatch, module):
    """Count the calls of `module`'s ``to_device_async``."""
    calls = []
    real = module.to_device_async
    monkeypatch.setattr(module, "to_device_async",
                        lambda x, device: calls.append(tuple(x.shape)) or real(x, device))
    return calls


def test_gather_windows_on_the_queued_copy(monkeypatch):
    """The plan's base, valid_lo and valid_hi in one staged copy; each
    window as the reference slices and pads it, bases below 0 and past
    the end included."""
    calls = _spy(monkeypatch, samples)
    frames = torch.arange(1, 41, dtype=torch.float32)
    plan = WindowPlan(base=np.array([-3, 0, 30, 37], np.int32),
                      valid_lo=np.array([3, 1, 0, 0], np.int32),
                      valid_hi=np.array([8, 7, 8, 3], np.int32),
                      track_index=np.array([0, 0, 1, 2], np.int32), n_tracks=2, sample_size=8)
    got = samples.gather_windows(frames, plan).numpy()
    want = np.zeros((4, 8), np.float32)
    for i, (b, lo, hi) in enumerate(zip(plan.base, plan.valid_lo, plan.valid_hi)):
        for j in range(lo, hi):
            want[i, j] = frames[b + j]
    assert calls == [(3, 4)]
    np.testing.assert_array_equal(got, want)


def test_track_means_on_the_queued_copy(monkeypatch):
    """The segment index in one staged copy; the mean over each track's
    windows, the padding windows (index n_tracks) dropped."""
    calls = _spy(monkeypatch, classify)
    probs = torch.from_numpy(np.random.RandomState(0).rand(7, 3).astype(np.float32))
    index = np.array([0, 0, 2, 1, 2, 3, 3], np.int32)
    got = classify._track_means(probs, index, 3).numpy()
    want = np.stack([probs.numpy()[index == t].mean(axis=0) for t in range(3)])
    assert calls == [(7,)]
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_detect_batch_mask_on_the_queued_copy(monkeypatch):
    """n_valid in one staged copy, from an array or a list; each recording
    of the batch masked as it is alone, at its own valid length."""
    calls = _spy(monkeypatch, signal_noise)
    frames = torch.from_numpy(np.stack([_rec(3, seconds=3), _rec(4, seconds=3)]))
    lengths = np.array([3 * SR, int(2.2 * SR)], np.int32)  # the second cut in its tone (2.0-2.8 s)
    batch = signal_noise.detect_batch_mask(frames, lengths, sr=SR)
    alone = [signal_noise.detect_batch_mask(frames[i : i + 1], [int(lengths[i])], sr=SR)
             for i in range(2)]
    uncut = signal_noise.detect_batch_mask(frames[1:], [3 * SR], sr=SR)
    assert calls == [(2,), (1,), (1,), (1,)]
    for i, one in enumerate(alone):
        for a, b in zip(batch, one):
            assert torch.equal(a[i : i + 1], b)
    assert batch[2].any() and not torch.equal(batch[2][1:], uncut[2])


def _int16(seed):
    return (np.clip(_rec(seed), -1, 1) * 32767).astype(np.int16)


@pytest.mark.cuda
def test_dispatch_and_queue_return_with_the_device_busy(cuda_device, tmp_path, monkeypatch):
    """Behind ~200 ms of queued sleep, the next batch's dispatch and the
    current batch's queue half return before the sleep ends; the collect
    half then gives the serial ``_finish``'s probabilities and results."""
    a = serve.BatchAnalyzer([_model(tmp_path / "m")], sr=SR, bucket_seconds=9, rng=None,
                            device=cuda_device)
    recs = [_int16(30), _int16(31)]
    probs = []
    real = serve.apply_thresholds
    monkeypatch.setattr(serve, "apply_thresholds",
                        lambda t, p, w, c: probs.append(np.array(p, copy=True)) or real(t, p, w, c))
    list(a.analyse_stream([recs] * 3))  # warm: kernels, plans, allocator blocks, pinned blocks
    probs.clear()
    serial = a._finish(a._dispatch(recs))
    serial_probs, probs[:] = list(probs), []
    assert serial_probs and all(r["species_identify"] for r in serial)

    handle = a._dispatch(recs)
    torch.cuda.synchronize()  # the batch's masks are back, as the stream's are by its queue step
    torch.cuda._sleep(400_000_000)  # ~200 ms at the H100's clocks
    busy = torch.cuda.Event()
    busy.record()
    ahead = a._dispatch(recs)
    queued = a._queue(handle, StageTimer())
    pending = not busy.query()
    got = a._collect(queued, StageTimer())
    got_probs = list(probs)
    a._finish(ahead)
    assert pending, "a host-device wait remains in _dispatch or _queue"
    assert json.dumps(got) == json.dumps(serial)
    assert len(got_probs) == len(serial_probs)
    assert all(np.array_equal(g, s) for g, s in zip(got_probs, serial_probs))
