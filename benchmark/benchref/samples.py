"""Window placement: a frozen copy of the port's pipeline/samples.py
``plan_windows`` (the reference's placement rules, src/identify_tracks.py:
65-199, in numpy's RNG draw order), and the gather of the planned windows
from one recording.
"""

from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class WindowPlan:
    """Index plan for the device gather."""

    base: np.ndarray  # [N] absolute sample index of window sample 0 (may be <0)
    valid_lo: np.ndarray  # [N] first in-window index holding real audio
    valid_hi: np.ndarray  # [N] one-past-last in-window index holding real audio
    track_index: np.ndarray  # [N] which track each window belongs to
    n_tracks: int = 0
    sample_size: int = 0
    skipped_tracks: list = field(default_factory=list)  # out-of-band tracks
    filter_specs: list = field(default_factory=list)  # (track_idx, low, high)
    track_bounds: dict = field(default_factory=dict)  # track_idx -> (g0, g1)


def _randint(rng, n):
    if rng is None or n <= 0:
        return 0
    return int(rng.randint(0, n))


def plan_windows(
    n_frames_total: int,
    sr: int,
    tracks,
    segment_length: float,
    stride: float,
    fmin: float = 50,
    fmax: float = 11000,
    filter_freqs: bool = False,
    filter_below=None,
    pad_short_tracks: bool = False,
    rng=None,
) -> WindowPlan:
    """Reproduce the reference's window placement (src/identify_tracks.py:109-198).

    Returns a WindowPlan whose (base, valid range) pairs produce byte-identical
    windows to the reference's slice+pad logic for the same random draws.
    """
    sample_size = int(sr * segment_length)
    bases, vlo, vhi, tidx = [], [], [], []
    skipped = []
    filter_specs = []
    track_bounds = {}

    for ti, t in enumerate(tracks):
        if t.freq_start > fmax or t.freq_end < fmin:
            skipped.append(ti)  # reference skips id for out-of-band tracks (:116-119)
            continue

        sr_end = int(t.end * sr)
        sr_start = int(sr * t.start)

        if pad_short_tracks:
            track_g0, track_g1 = sr_start, sr_end
        else:
            missing = sample_size - (sr_end - sr_start)
            if missing > 0:
                offset = _randint(rng, missing)
                sr_start = sr_start - offset
                if sr_start <= 0:
                    sr_start = 0
                    sr_end = min(sr_start + sample_size, n_frames_total)
                else:
                    end_offset = sr_end + missing - offset
                    if end_offset > n_frames_total:
                        end_offset = n_frames_total
                        sr_start = max(end_offset - sample_size, 0)
                    sr_end = end_offset
            track_g0, track_g1 = sr_start, sr_end

        if filter_freqs:
            filter_specs.append((ti, t.freq_start, t.freq_end))
        elif filter_below and t.freq_end < filter_below:
            filter_specs.append((ti, t.freq_start, t.freq_end))

        track_bounds[ti] = (track_g0, track_g1)
        track_len = track_g1 - track_g0

        # window walk (reference :150-196); local indices into the track
        start = 0.0
        ls = 0
        le = min(track_g1, sample_size)  # quirk: global end clamped (:151)
        while True:
            lo = ls
            hi = min(le, track_len)
            data_len = max(hi - lo, 0)  # empty slice when lo >= track_len
            if data_len != sample_size:
                extra = sample_size - data_len
                offset = _randint(rng, extra)
            else:
                offset = 0
            bases.append(track_g0 + lo - offset)
            vlo.append(offset)
            vhi.append(offset + data_len)
            tidx.append(ti)

            start = start + stride
            end = start + segment_length
            ls = int(start * sr)
            le = min(int(end * sr), ls + sample_size)
            if end > (t.end - t.start):
                break

    return WindowPlan(
        base=np.asarray(bases, np.int32),
        valid_lo=np.asarray(vlo, np.int32),
        valid_hi=np.asarray(vhi, np.int32),
        track_index=np.asarray(tidx, np.int32),
        n_tracks=len(tracks),
        sample_size=sample_size,
        skipped_tracks=skipped,
        filter_specs=filter_specs,
        track_bounds=track_bounds,
    )


def gather(y: torch.Tensor, plan: WindowPlan) -> torch.Tensor:
    """[T] float32 PCM -> [n_windows, sample_size]: window i is
    y[base_i : base_i + sample_size] with in-window positions outside
    [valid_lo_i, valid_hi_i) zero (the reference's slice and np.pad)."""
    n = int(plan.sample_size)
    padded = torch.nn.functional.pad(y, (n, n))
    j = torch.arange(n, device=y.device)
    as_t = lambda a: torch.from_numpy(np.asarray(a, np.int64)).to(y.device)
    base, lo, hi = as_t(plan.base), as_t(plan.valid_lo), as_t(plan.valid_hi)
    idx = (base[:, None] + n + j[None, :]).clamp(0, padded.shape[0] - 1)
    keep = (j[None, :] >= lo[:, None]) & (j[None, :] < hi[:, None])
    return torch.where(keep, padded[idx], 0.0)
