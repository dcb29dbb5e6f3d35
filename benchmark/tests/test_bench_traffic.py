"""The traffic generator repeats per seed, gives every seed the same amount
of work in another order, and keeps to its file's parameters."""

import json

import numpy as np
import pytest
from conftest import BENCH

from benchlib import traffic

MIXES = {p.stem: json.loads(p.read_text())["recording"]
         for p in sorted((BENCH / "traffic").glob("*.json"))}


def small(params, seconds=12):
    p = json.loads(json.dumps(params))
    p["seconds"] = seconds
    p["silent_tail"]["from_s"] = [seconds - 4, seconds - 1]
    return p


@pytest.mark.parametrize("name", sorted(MIXES))
def test_same_seed_same_pool(name):
    p = small(MIXES[name])
    a, b = traffic.make_pool(p, 6, 2 ** 31 + 5), traffic.make_pool(p, 6, 2 ** 31 + 5)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    c = traffic.make_pool(p, 6, 2 ** 31 + 6)
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))


@pytest.mark.parametrize("name", sorted(MIXES))
def test_pool_keeps_to_parameters(name):
    p = small(MIXES[name])
    pool = traffic.make_pool(p, 8, 77)
    n = int(p["seconds"] * p["sr"])
    tails = 0
    for pcm in pool:
        assert pcm.dtype == np.int16 and len(pcm) == n
        nz = np.flatnonzero(pcm)
        end = (nz.max() + 1) / p["sr"]
        if end < p["seconds"] - 0.01:
            tails += 1
            assert p["silent_tail"]["from_s"][0] - 0.01 <= end <= p["silent_tail"]["from_s"][1]
        # the noise floor before the first call
        head = pcm[: p["sr"] // 4].astype(np.float64) / 32768
        lo, hi = p["noise_rms"]
        assert 0.8 * lo <= np.sqrt((head ** 2).mean()) <= 1.2 * hi + 0.5
    assert tails == round(p["silent_tail"]["share"] * 8) or p["silent_tail"]["share"] == 1.0


def test_call_counts_are_the_same_multiset_for_every_seed():
    p = small(MIXES["backlog_quiet"])
    rng_counts = []
    for seed in (1, 2 ** 31 + 9):
        rng = np.random.default_rng(np.random.SeedSequence(seed).spawn(1)[0])
        rng_counts.append(sorted(traffic._counts(p["calls"], 64, rng)))
    assert rng_counts[0] == rng_counts[1]
    lo, hi = p["calls"]["count"]
    assert set(rng_counts[0]) == set(range(lo, hi + 1))


def test_wav_round_trip(tmp_path):
    from audio_analysis_torch.io.audio import load_recording

    pcm = traffic.make_pool(small(MIXES["cli_exact"]), 1, 3)[0]
    f = traffic.write_wav(tmp_path / "a.wav", pcm, 48000)
    got, sr = load_recording(f, resample=48000, prefer_int16=True, device="cpu")
    assert sr == 48000 and np.array_equal(got, pcm)
