"""The reference analysis of one recording (reference src/analyse.py:129-175
and src/identify_tracks.py, as the port's pipeline documents them):
detection, tracks, the window plan of the first model group, the frontend,
each group's ensemble mean over its windows and its per-track means, then
thresholds, master tags, chirps and the cacophony index.

``analyse`` gives the reference's own per-track probabilities;
``result_json`` builds the result from any probabilities, so a program's
probabilities can be judged apart from its result's assembly.
"""

from dataclasses import dataclass

import numpy as np
import torch

from benchref import dsp
from benchref.cacophony import calc_cacophony_index, filter_tracks, get_chirps, get_max_chirps
from benchref.samples import gather, plan_windows
from benchref.signal import NON_BIRD, ModelResult, Prediction, get_tracks_from_signals

SPECIES_IDENTIFY_VERSION = "2025-12-01"
DEFAULT_BIRDS = ["bird", "kiwi", "whistler", "morepork"]
UNSUPPORTED = ("mean_sub", "use_mfcc", "filter_freq", "filter_below", "pad_short_tracks",
               "embedding_model")


@dataclass
class Model:
    """One classifier: its metadata.txt dict and a callable over features."""

    meta: dict
    net: object

    @property
    def is_efficientnet(self):
        return "efficientnet" in (self.meta.get("name") or "").lower()


def groups_of(models):
    """The reference's grouping: the main ensemble, then the pre-models."""
    main = [m for m in models if not m.meta.get("pre_model", False)]
    pre = [m for m in models if m.meta.get("pre_model", False)]
    return [g for g in (main, pre) if g]


def _plan(meta, length, tracks, rng):
    if any(meta.get(key) for key in UNSUPPORTED) or meta.get("channels", 1) != 1:
        raise ValueError(f"the reference does not model one of {UNSUPPORTED} or channels")
    return plan_windows(int(length), 48000, tracks, meta.get("segment_length", 3),
                        meta.get("segment_stride", 1.5), fmin=meta.get("fmin", 50),
                        fmax=meta.get("fmax", 11000), rng=rng)


@torch.no_grad()
def analyse(pcm: np.ndarray, models, rng=None, prec=dsp.EXACT, device="cpu"):
    """int16 PCM at 48 kHz -> dict(length, signals, tracks, probs): probs is
    a list, one per group, of (per-track mean probabilities [tracks,
    labels] float64, windows per track)."""
    y = torch.from_numpy(np.asarray(pcm)).to(device).to(torch.float32) / 32768.0
    length, signals = dsp.detect(y, 48000, prec)
    tracks = get_tracks_from_signals([s.copy() for s in signals], length)
    probs = []
    if tracks:
        groups = groups_of(models)
        plan = _plan(groups[0][0].meta, len(pcm), tracks, rng)
        feats = None
        for group in groups:
            if len(plan.base) == 0:
                break
            if feats is None:
                feats = dsp.features(gather(y, plan), groups[0][0].meta, prec)
            p = None
            for m in group:
                x = feats.repeat_interleave(3, dim=-1) if m.is_efficientnet else feats
                out = m.net(x).to(torch.float64)
                p = out if p is None else p + out
            p = (p / len(group)).cpu().numpy()
            wpt = np.bincount(plan.track_index, minlength=len(tracks))
            sums = np.zeros((len(tracks), p.shape[1]))
            np.add.at(sums, plan.track_index, p)
            probs.append((sums / np.maximum(wpt, 1)[:, None], wpt))
    return dict(length=length, signals=signals, tracks=tracks, probs=probs,
                raw_length=len(pcm) / 48000)


def apply_thresholds(tracks, track_probs, windows_per_track, meta):
    """Per-track Predictions (reference src/identify_tracks.py:553-571)."""
    labels, ebird_ids = meta.get("labels") or [], meta.get("ebird_ids")
    thresh = meta.get("threshold", 0.7)
    for ti, t in enumerate(tracks):
        if windows_per_track[ti] == 0:
            continue
        result = ModelResult(meta.get("name", False) or "", meta.get("pre_model", False))
        t.results.append(result)
        max_p = None
        for i, p in enumerate(track_probs[ti]):
            if max_p is None or p > max_p[1]:
                max_p = (i, p)
            if p >= thresh:
                result.add_prediction(labels[i], p, ebird_ids[i] if ebird_ids else None, thresh)
        if not result.predictions:
            result.raw_prediction = Prediction(labels[max_p[0]], max_p[1],
                                               ebird_ids[max_p[0]] if ebird_ids else None)


def result_json(ref, models, probs, cli=False):
    """The result dict of one recording from the reference's detection and
    tracks and the given per-group (probabilities, windows per track).
    ``cli``: the single-recording CLI's quirk (no tracks: no signals)."""
    tracks = [t.copy() for t in ref["tracks"]]
    signals = [s.copy() for s in ref["signals"]]
    groups = groups_of(models)
    for group, (p, wpt) in zip(groups, probs):
        apply_thresholds(tracks, np.asarray(p), wpt, group[0].meta)
    bird_labels = set()
    for m in models:
        bird_labels.update(m.meta.get("bird_labels", DEFAULT_BIRDS))
    if cli and not tracks:
        signals = []
    for t in tracks:
        t.set_master_tag()
    rec_signals = [s.to_array() for s in signals]
    chirps = get_chirps(tracks, list(bird_labels), signals)
    index, _ = calc_cacophony_index(filter_tracks(tracks), ref["length"])
    max_chirps = get_max_chirps(ref["length"])
    return {
        "duration": ref["raw_length"],
        "cacophony_index": index,
        "cacophony_index_version": "2.0",
        "chirps": {"chirps": chirps, "max_chirps": max_chirps,
                   "chirp_index": 0 if max_chirps == 0 else round(100 * chirps / max_chirps),
                   "signals": rec_signals},
        "non_bird_tags": NON_BIRD,
        "species_identify": [t.get_meta() for t in tracks],
        "species_identify_version": SPECIES_IDENTIFY_VERSION,
    }
