"""The one traffic generator: a pool of seeded recordings from a mix file's
``recording`` parameters, written as 16-bit mono WAVs.

Parameters (ranges [lo, hi]). What sets a recording's amount of work is
spread evenly over the pool, in a seeded order, so that every seed makes
the same work: the call counts, the noise level and the start of the
silent tail take the pool's evenly spaced quantiles of their range; each
call's own parameters are drawn uniformly.

- ``seconds``, ``sr``, ``noise_rms``;
- ``calls``: ``count`` [lo, hi] (the pool holds every count from lo to hi
  equally often, in a seeded order, so every seed makes the same amount of
  work) or ``every_s`` (one call every that many seconds of the part
  before the silent tail, at least one); ``placement`` ``even`` (call i at
  1 + i (end - 2) / n s) or ``random``; ``duration_s``, ``f0_hz``,
  ``sweep_hz_s2`` (phase 2 pi (f0 t + sweep t^2)), ``amplitude``;
- ``silent_tail``: ``share`` of the pool (an exact count, seeded
  positions) whose samples are digital silence from ``from_s`` on.
"""

import struct
from pathlib import Path

import numpy as np


def _uniform(rng, r):
    return float(rng.uniform(r[0], r[1]))


def _spread(r, n, rng):
    """n evenly spaced quantiles of the range r, in a seeded order."""
    return rng.permutation(r[0] + (np.arange(n) + 0.5) / n * (r[1] - r[0]))


def _counts(calls, pool, rng):
    if "count" not in calls:
        return None
    lo, hi = calls["count"]
    values = np.arange(lo, hi + 1)
    return rng.permutation(np.resize(values, pool))


def make_pool(params: dict, pool: int, seed: int):
    """``pool`` int16 recordings from ``params`` (a mix's ``recording``)."""
    root = np.random.SeedSequence(seed)
    rng = np.random.default_rng(root.spawn(1)[0])
    calls = params["calls"]
    counts = _counts(calls, pool, rng)
    tail = params.get("silent_tail", {"share": 0.0})
    n_tail = int(round(tail["share"] * pool))
    ends = np.full(pool, float(params["seconds"]))
    if n_tail:
        ends[rng.permutation(pool)[:n_tail]] = _spread(tail["from_s"], n_tail, rng)
    noise = _spread(params["noise_rms"], pool, rng)
    sr, seconds = int(params["sr"]), float(params["seconds"])
    n = int(seconds * sr)
    out = []
    for i, child in enumerate(root.spawn(pool)):
        r = np.random.default_rng(child)
        end = float(ends[i])
        y = float(noise[i]) * r.standard_normal(n, dtype=np.float32)
        k = (int(counts[i]) if counts is not None
             else max(1, int(end // float(calls["every_s"]))))
        for c in range(k):
            dur = _uniform(r, calls["duration_s"])
            if calls["placement"] == "even":
                t0 = 1.0 + c * (end - 2.0) / k
            else:
                t0 = float(r.uniform(0.0, max(end - dur, 0.0)))
            f0, sweep = _uniform(r, calls["f0_hz"]), _uniform(r, calls["sweep_hz_s2"])
            amp = _uniform(r, calls["amplitude"])
            a, b = int(t0 * sr), min(int((t0 + dur) * sr), n)
            t = np.arange(b - a, dtype=np.float64) / sr
            y[a:b] += (amp * np.sin(2 * np.pi * (f0 * t + sweep * t * t))).astype(np.float32)
        y[int(end * sr):] = 0.0
        out.append((np.clip(y, -1.0, 1.0) * 32767.0).astype(np.int16))
    return out


def write_wav(path: Path, pcm: np.ndarray, sr: int) -> Path:
    """16-bit mono PCM WAV."""
    data = np.ascontiguousarray(pcm, "<i2").tobytes()
    header = struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(data), b"WAVE", b"fmt ", 16,
                         1, 1, sr, sr * 2, 2, 16, b"data", len(data))
    path.write_bytes(header + data)
    return path
