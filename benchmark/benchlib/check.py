"""What decides ``correct`` for the serving cells: a seeded sample of the
recordings the window completed, each analysed again by the reference
(``benchref``) from the PCM the benchmark made, and held against what the
timed path produced for it.

The numbers, each with its limit from ``benchmark/limits/<workload>.json``:

- ``signals_mismatch``: recordings whose detected signals (the result's
  ``chirps.signals``) differ from the reference's; exact, limit 0;
- ``tracks_mismatch``: recordings whose track boxes differ; exact, 0;
- ``windows_mismatch``: recordings whose model groups or windows per track
  differ from the reference's window plan; exact, 0;
- ``prob_gap``: the widest gap between a track's mean probability, as the
  program handed it to its thresholds, and the reference's (float64 DFTs,
  float32 classifiers, TF32 off), over every label, track and group;
- ``prob_rms``: the root mean square of the same gaps, over every label,
  track, group and recording checked;
- ``prob_mean``, ``prob_median``: their mean and median, steadier than
  the widest gap where a few tracks of a random network turn on bfloat16
  rounding;
- ``post_mismatch``: recordings whose result, apart from the processing
  time and the stage timings, differs from the one the reference builds
  from the reference's tracks and the program's own probabilities; exact, 0.
"""

import json
import sys

import numpy as np
import torch

from benchref import dsp
from benchref.analyse import analyse, result_json

NUMBERS = ("recordings_checked", "signals_mismatch", "tracks_mismatch", "windows_mismatch",
           "prob_gap", "prob_rms", "prob_mean", "prob_median", "post_mismatch")
VOLATILE = ("processing_time_seconds", "timing")


def _plain(obj):
    return json.loads(json.dumps(obj, default=lambda o: o.item() if hasattr(o, "item") else str(o)))


def _boxes(result):
    return [[t["begin_s"], t["end_s"], t["freq_start"], t["freq_end"]]
            for t in result["species_identify"]]


class ProbCapture:
    """Keeps a copy of every (per-track probabilities, windows per track)
    that the program hands to ``apply_thresholds`` in `module`, the point
    where its probabilities become the rounded confidences of the result."""

    def __init__(self, module):
        self.module = module
        self.original = module.apply_thresholds
        self.calls = []

    def _wrapped(self, tracks, track_probs, windows_per_track, cfg):
        self.calls.append((np.array(track_probs, copy=True),
                           np.array(windows_per_track, copy=True)))
        return self.original(tracks, track_probs, windows_per_track, cfg)

    def __enter__(self):
        self.module.apply_thresholds = self._wrapped
        return self

    def __exit__(self, *exc):
        self.module.apply_thresholds = self.original

    def take(self):
        out, self.calls = self.calls, []
        return out


def program_groups(calls):
    """The groups that ran on a recording: (probs, windows per track), those
    whose tracks had no window left out. The CLI counts its padding windows
    in one more entry past the tracks; it is dropped."""
    calls = [(p, np.asarray(w)[: len(p)]) for p, w in calls]
    return [(p, w) for p, w in calls if w.sum() > 0]


def judge(samples, models, device, cli=False, prec=dsp.EXACT):
    """samples: dicts with ``pcm`` (int16), ``result`` (the program's result
    dict), ``groups`` (its (probs, windows per track) per group) and ``rng``
    (the seed of its window plan's RandomState, or None). Returns the
    numbers."""
    n = dict.fromkeys(NUMBERS, 0)
    n["prob_gap"] = 0.0
    gaps = []
    for s in samples:
        rng = np.random.RandomState(s["rng"]) if s["rng"] is not None else None
        ref = analyse(s["pcm"], models, rng=rng, prec=prec, device=device)
        got = _plain({k: v for k, v in s["result"].items() if k not in VOLATILE})
        n["recordings_checked"] += 1
        ref_signals = _plain([x.to_array() for x in ref["signals"]])
        if not (cli and not ref["tracks"]) and got["chirps"]["signals"] != ref_signals:
            n["signals_mismatch"] += 1
        if _boxes(got) != _plain(_boxes({"species_identify": [t.get_meta()
                                                               for t in ref["tracks"]]})):
            n["tracks_mismatch"] += 1
            continue
        groups = program_groups(s["groups"])
        if len(groups) != len(ref["probs"]) or any(
                not np.array_equal(w, rw) for (_, w), (_, rw) in zip(groups, ref["probs"])):
            n["windows_mismatch"] += 1
            continue
        for (p, w), (rp, _) in zip(groups, ref["probs"]):
            rows = np.asarray(w) > 0
            gap = np.abs(np.asarray(p, np.float64)[rows] - rp[rows])
            n["prob_gap"] = max(n["prob_gap"], float(gap.max()))
            gaps.append(gap.ravel())
        if _plain(result_json(ref, models, groups, cli=cli)) != got:
            n["post_mismatch"] += 1
    gaps = np.concatenate(gaps) if gaps else np.zeros(1)
    n["prob_rms"] = float(np.sqrt(np.mean(gaps ** 2)))
    n["prob_mean"] = float(np.mean(gaps))
    n["prob_median"] = float(np.median(gaps))
    return n


def verdict(numbers, limits):
    """(correct, [(name, value, limit)]), in the limits file's order: each
    number within its limit, a count of what was checked (``*_checked``)
    at least its limit."""
    rows = [(k, numbers[k], lim) for k, lim in limits.items()]
    ok = all(v >= lim if k.endswith("_checked") else v <= lim for k, v, lim in rows)
    return ok, rows


def compared(rows):
    """{name: {value, limit}}; a count of what was checked is held to at least its limit."""
    return {k: {"value": v, "limit": (f">={lim}" if k.endswith("_checked") else lim)}
            for k, v, lim in rows}


def print_compared(rows):
    for name, c in compared(rows).items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)


def free_device():
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
