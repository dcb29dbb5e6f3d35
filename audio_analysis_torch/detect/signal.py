"""Signal/track host logic: data classes, merging, master-tag arbitration.

This is deliberately host-side Python: the data is tiny (tens of boxes) and
the merge rules are an order-dependent fixpoint. Semantics are preserved
rule-for-rule from the reference (src/identify_tracks.py:580-647, 709-842,
845-1033) including its observable quirks, which are called out inline —
track boxes feed every downstream number, so behaviour parity wins over
cleanliness here.
"""

import logging
import math

MAX_FREQUENCY = 48000 / 2  # reference MAX_FRQUENCY (src/identify_tracks.py:22)
SIGNAL_WIDTH = 0.25


def segment_overlap(first, second) -> float:
    """Overlap length of two [start, end] segments; negative = gap
    (reference: src/identify_tracks.py:709-714)."""
    return (
        (first[1] - first[0])
        + (second[1] - second[0])
        - (max(first[1], second[1]) - min(first[0], second[0]))
    )


def mel_freq(f: float) -> float:
    """Mel used for *merging* decisions — note break 700, not the feature
    filterbank's 1750 (reference: src/identify_tracks.py:717-718)."""
    return 2595.0 * math.log10(1.0 + f / 700.0)


class Prediction:
    """One thresholded label (reference: src/identify_tracks.py:845-866)."""

    def __init__(self, what, confidence, ebird_id, threshold_used=None, normalize_confidence=True):
        self.what = what
        if normalize_confidence:
            self.confidence = round(100 * confidence)
        else:
            self.confidence = confidence
        self.ebird_id = ebird_id
        self.filtered = False
        self.threshold_used = threshold_used

    def get_meta(self):
        return {
            "label": self.what,
            "confidence": self.confidence,
            "filtered": self.filtered,
            "ebird_id": self.ebird_id,
            "threshold_used": self.threshold_used,
        }


class ModelResult:
    """Per-(track, model) predictions (reference: src/identify_tracks.py:869-912)."""

    def __init__(self, model, pre_model):
        self.model = model
        self.pre_model = pre_model
        self.raw_prediction = None
        self.predictions = []

    def add_prediction(self, what, confidence, ebird_ids, threshold_used, normalize_confidence=True):
        eid = ebird_ids
        if ebird_ids is not None and len(ebird_ids) == 0:
            eid = None
        self.predictions.append(
            Prediction(what, confidence, eid, threshold_used, normalize_confidence)
        )

    def get_meta(self):
        meta = {
            "model": self.model,
            "pre_model": self.pre_model,
            "predictions": [p.get_meta() for p in self.predictions],
        }
        if self.raw_prediction is not None:
            meta["raw_prediction"] = self.raw_prediction.get_meta()
        return meta


class Signal:
    """A time-frequency box; also used as a track
    (reference: src/identify_tracks.py:915-1033)."""

    def __init__(self, start, end, freq_start, freq_end):
        self.start = start
        self.end = end
        self.freq_start = freq_start
        self.freq_end = freq_end
        self.mel_freq_start = mel_freq(freq_start)
        self.mel_freq_end = mel_freq(freq_end)
        self.results = []
        self.master_tag = None
        self.master_model = None
        self.master_below_thresh = True
        self.track_id = None

    # -- geometry ----------------------------------------------------------

    @property
    def length(self):
        return self.end - self.start

    @property
    def mel_freq_range(self):
        return self.mel_freq_end - self.mel_freq_start

    @property
    def freq_range(self):
        return self.freq_end - self.freq_start

    def time_overlap(self, other):
        return segment_overlap((self.start, self.end), (other.start, other.end))

    def mel_freq_overlap(self, other):
        return segment_overlap(
            (self.mel_freq_start, self.mel_freq_end),
            (other.mel_freq_start, other.mel_freq_end),
        )

    def freq_overlap(self, other):
        return segment_overlap(
            (self.freq_start, self.freq_end), (other.freq_start, other.freq_end)
        )

    def copy(self):
        return Signal(self.start, self.end, self.freq_start, self.freq_end)

    def enlarge(self, scale, min_track_length):
        """Grow in time (floored at min_track_length) and frequency.

        Frequency endpoints get int-truncated exactly like the reference
        (src/identify_tracks.py:988-1005)."""
        new_length = self.length * scale
        if new_length < min_track_length:
            new_length = min_track_length
        extension = (new_length - self.length) / 2
        self.start = self.start - extension
        self.end = self.end + extension
        self.start = max(self.start, 0)

        new_length = (self.freq_end - self.freq_start) * scale
        extension = (new_length - (self.freq_end - self.freq_start)) / 2
        self.freq_start = self.freq_start - extension
        self.freq_end = int(self.freq_end + extension)
        self.freq_start = int(max(self.freq_start, 0))
        self.mel_freq_start = mel_freq(self.freq_start)
        self.mel_freq_end = mel_freq(self.freq_end)

    def merge(self, other):
        self.start = min(self.start, other.start)
        self.end = max(self.end, other.end)
        self.freq_start = min(self.freq_start, other.freq_start)
        self.freq_end = max(self.freq_end, other.freq_end)
        self.mel_freq_start = mel_freq(self.freq_start)
        self.mel_freq_end = mel_freq(self.freq_end)

    # -- results -----------------------------------------------------------

    def set_master_tag(self):
        master = get_master_tag(self)
        if master is None:
            return
        tag, model, below_thresh = master
        self.master_tag = tag
        self.master_model = model
        self.master_below_thresh = below_thresh

    def to_array(self, decimals=1):
        a = [self.start, self.end, self.freq_start, self.freq_end]
        if decimals is not None:
            a = [round(float(v), decimals) for v in a]
        return a

    def get_meta(self):
        meta = {
            "begin_s": self.start,
            "end_s": self.end,
            "freq_start": self.freq_start,
            "freq_end": self.freq_end,
        }
        if self.master_tag is not None:
            meta["master_tag"] = {
                "below_thresh": self.master_below_thresh,
                "prediction": self.master_tag.get_meta(),
                "model": self.master_model,
            }
        meta["model_results"] = [r.get_meta() for r in self.results]
        if self.track_id is not None:
            meta["track_id"] = self.track_id
        return meta

    def __str__(self):
        return f"Signal: {self.start}-{self.end} f: {self.freq_start}-{self.freq_end}"


# ---------------------------------------------------------------------------
# merge rules (reference: src/identify_tracks.py:725-842)
# ---------------------------------------------------------------------------


def merge_signals(signals):
    """One merge pass; returns (signals, something_merged).

    Rules keyed on the 700-break mel scale with a 1500-mel split; exact port
    of reference src/identify_tracks.py:725-792 including iteration order
    (sorted by start, ties by descending mel_freq_end) and the
    first-eligible-wins inner break.
    """
    to_delete = []
    something_merged = False

    signals = sorted(signals, key=lambda s: s.mel_freq_end, reverse=True)
    signals = sorted(signals, key=lambda s: s.start)

    for s in signals:
        if s in to_delete:
            continue
        merged = False
        u = None
        for u in signals:
            if u in to_delete:
                continue
            if u is s:
                continue
            in_freq = u.mel_freq_end < 1500 and s.mel_freq_end < 1500
            in_freq = in_freq or (u.mel_freq_end > 1500 and s.mel_freq_end > 1500)
            if not in_freq:
                continue
            overlap = s.time_overlap(u)
            if s.mel_freq_start > 1000 and u.mel_freq_start > 1000:
                freq_overlap_time = 0.5
            else:
                freq_overlap_time = 0.75
            if s.start > u.end:
                time_diff = s.start - u.end
            else:
                time_diff = u.start - s.end
            mel_overlap = s.mel_freq_overlap(u)
            if overlap > u.length * 0.75 and mel_overlap > -20:
                s.merge(u)
                merged = True
                break
            elif overlap > 0 and mel_overlap > u.mel_freq_range * freq_overlap_time:
                s.merge(u)
                merged = True
                break
            elif mel_overlap > u.mel_freq_range * freq_overlap_time and time_diff <= 2:
                if u.mel_freq_end > s.mel_freq_range:
                    range_overlap = s.mel_freq_range / u.mel_freq_range
                else:
                    range_overlap = u.mel_freq_range / s.mel_freq_range
                if range_overlap < 0.75:
                    continue
                s.merge(u)
                merged = True
                break

        if merged:
            something_merged = True
            to_delete.append(u)

    for s in to_delete:
        signals.remove(s)

    return signals, something_merged


def get_tracks_from_signals(signals, end):
    """Fixpoint-merge signals into tracks, then filter/enlarge
    (reference: src/identify_tracks.py:795-842).

    Quirk preserved: the reference shadows ``min_length`` inside the overlap
    loop (line 824), so after the first track the 0.35 s short-track filter
    compares against the *previous iteration's* min track length instead.
    """
    merged = True
    min_mel_range = 50
    while merged:
        signals, merged = merge_signals(signals)

    to_delete = []
    min_length = 0.35
    min_track_length = 0.7
    for s in signals:
        if s in to_delete:
            continue
        if s.length < min_length:
            to_delete.append(s)
            continue

        s.enlarge(1.4, min_track_length=min_track_length)
        s.end = min(end, s.end)

        for s2 in signals:
            if s2 in to_delete:
                continue
            if s2 is s:
                continue
            overlap = s.time_overlap(s2)
            min_length = min(s.length, s2.length)  # shadows the 0.35 filter (quirk)
            if overlap > 0.7 * min_length:
                s.merge(s2)
                to_delete.append(s2)

    for s in to_delete:
        signals.remove(s)
    to_delete = []
    for s in signals:
        if s.mel_freq_range < min_mel_range:
            to_delete.append(s)
    for s in to_delete:
        signals.remove(s)
    return signals


# ---------------------------------------------------------------------------
# master-tag arbitration (reference: src/identify_tracks.py:580-647)
# ---------------------------------------------------------------------------


def get_master_tag(track):
    """Pick the track's master tag: sure specific > sure generic from the
    main model(s), pre-model noise/human overrides morepork, raw (argmax)
    predictions as a below-threshold fallback."""
    pre_model = None
    other_model = []
    raw_preds = []
    for model_result in track.results:
        if model_result.pre_model:
            pre_model = model_result
            continue
        for p in model_result.predictions:
            if p.filtered:
                continue
            other_model.append((p, model_result.model))
        if model_result.raw_prediction is not None:
            raw_preds.append((model_result.raw_prediction, model_result.model))

    first_specific = None
    if len(other_model) > 0:
        ordered = sorted(other_model, key=lambda pred: pred[0].confidence, reverse=True)
        first_specific = None
        for p in ordered:
            if p[0].what == "bird":
                continue
            first_specific = p
            break
        if first_specific is None:
            first_specific = ordered[0]

    pre_pred = None
    if pre_model is not None and len(pre_model.predictions) > 0:
        pre_prediction = pre_model.predictions[0]
        if not pre_prediction.filtered:
            pre_pred = (pre_prediction, pre_model.model)

    if first_specific is None and pre_pred is not None:
        return (*pre_pred, False)
    if first_specific is not None and pre_pred is not None:
        is_morepork = first_specific[0].what == "morepork"
        is_noise = pre_pred[0].what in ["human", "noise"]
        if is_morepork and is_noise:
            logging.debug(
                "Overriding morepork because pre is noise/human %s %s",
                pre_pred[0].what,
                pre_pred[0].confidence,
            )
            return (*pre_pred, False)
        return (*first_specific, False)
    elif first_specific is not None:
        return (*first_specific, False)

    if len(raw_preds) > 0:
        ordered = sorted(raw_preds, key=lambda rp: rp[0].confidence, reverse=True)
        return (*ordered[0], True)
    elif pre_model is not None and pre_model.raw_prediction is not None:
        return pre_model.raw_prediction, pre_model.model, True
    return None
