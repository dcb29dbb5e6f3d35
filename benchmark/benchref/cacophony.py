"""Frozen copy of the port's pipeline/cacophony.py (plain host code).

Cacophony index v2 (track coverage) + chirp counting.

Host-side ports of reference src/analyse.py:18-126 — tiny data, pure Python,
preserved bin-walking behaviour including the 61-second last-bin merge
(:27-29) and the running `bird_until` span logic.
"""

import math

from benchref.signal import NON_BIRD, segment_overlap

SIGNAL_WIDTH = 0.25


def get_max_chirps(length):
    """Rough max possible chirps (reference: src/identify_tracks.py:45-46)."""
    return int(length / (SIGNAL_WIDTH + 0.01))


def filter_tracks(tracks):
    """Tracks whose master tag is a bird (reference: src/analyse.py:83-89)."""
    return [
        t
        for t in tracks
        if t.master_tag is not None and t.master_tag.what not in NON_BIRD
    ]


def calc_cacophony_index(tracks, length):
    """% of each 20 s bin covered by bird tracks
    (reference: src/analyse.py:18-80)."""
    version = "1.0"
    bird_percent = 0
    bird_until = -1
    period_length = 20
    bins = math.ceil(length / period_length)
    last_bin_size = length - period_length * (bins - 1)
    last_bin = None
    if bins > 1 and last_bin_size < 2:
        bins -= 1
        last_bin = length
    percents = []
    for i in range(bins):
        percents.append(
            {
                "begin_s": i * period_length,
                "end_s": min(length, (i + 1) * period_length),
                "index_percent": 0,
            }
        )
    if last_bin is not None:
        percents[-1]["end_s"] = last_bin
    period = 0
    period_length = 20
    if len(percents) > 0:
        period_length = percents[period]["end_s"] - percents[period]["begin_s"]
    period_end = period_length
    for track in tracks:
        if bird_until >= track.start and bird_until < track.end:
            new_span = (bird_until, track.end)
        elif bird_until < track.end:
            new_span = (track.start, track.end)
        else:
            continue
        if new_span[1] > period_end:
            while new_span[1] > period_end:
                if new_span[0] < period_end:
                    bird_percent += period_end - new_span[0]
                    new_span = (period_end, new_span[1])
                percents[period]["index_percent"] = round(
                    100 * bird_percent / period_length, 1
                )
                bird_percent = 0
                period += 1
                period = min(period, bins - 1)
                period_length = percents[period]["end_s"] - percents[period]["begin_s"]
                period_end += period_length
        bird_percent += new_span[1] - new_span[0]
        bird_until = new_span[1]
        period = min(len(percents) - 1, int(bird_until / period_length))
        period = min(period, bins - 1)
        period_length = percents[period]["end_s"] - percents[period]["begin_s"]
    if period < len(percents):
        percents[period]["index_percent"] = round(100 * bird_percent / period_length, 1)

    return percents, version


def get_chirps(tracks, bird_labels, signals):
    """Count signals overlapping bird tracks; mutates `signals`
    (reference: src/analyse.py:92-126, deletion included)."""
    sorted_tracks = [
        t for t in tracks if t.master_tag is not None and t.master_tag.what in bird_labels
    ]
    sorted_tracks = sorted(sorted_tracks, key=lambda track: track.start)
    last_end = 0
    chirps = 0
    for t in sorted_tracks:
        start = t.start
        end = t.end
        if start < last_end:
            start = last_end
            end = max(start, end)
        i = 0
        while i < len(signals):
            s = signals[i]
            if (
                segment_overlap((start, end), (s.start, s.end)) > 0
                and t.mel_freq_overlap(s) > -200
            ):
                chirps += 1
                del signals[i]
            elif s.start > end:
                break
            else:
                i += 1
        last_end = t.end
    return chirps
