"""Top-level analysis: the reference's ``species_identify`` / ``examine``
(src/analyse.py:129-175, 367-373) — classify, region-filter, master tags,
chirps, cacophony index, result JSON assembly (the JAX package's
pipeline/analysis.py). Output schema is identical.
"""

from audio_analysis_torch.io.metadata import read_sidecar
from audio_analysis_torch.io.modelconfig import NON_BIRD
from audio_analysis_torch.pipeline.classify import classify
from audio_analysis_torch.pipeline.cacophony import (
    calc_cacophony_index,
    filter_tracks,
    get_chirps,
    get_max_chirps,
)
from audio_analysis_torch.pipeline.ebird import filter_by_location
from audio_analysis_torch.utils.runtime import StageTimer, timings_on

SPECIES_IDENTIFY_VERSION = "2025-12-01"


def recording_result(tracks, signals, length, duration, bird_labels, meta_data,
                     analyse_tracks):
    """One recording's result dict (reference: src/analyse.py:129-175), on
    the CLI and the batch path alike. `tracks` carry their model results;
    `signals` are the detected ones (``get_chirps`` consumes them); `length`
    is the detected length and `duration` the recording's; `meta_data`'s
    location filters the tracks' eBird ids before the master tags. Under
    `analyse_tracks` the result has the per-track labels only (the
    reference's chirps and cacophony index are gated on not
    analyse_tracks)."""
    if meta_data is not None:
        filter_by_location(meta_data, tracks)
    for t in tracks:
        t.set_master_tag()
    result = {}
    if not analyse_tracks:
        rec_signals = [s.to_array() for s in signals]  # before get_chirps consumes them
        chirps = get_chirps(tracks, bird_labels, signals)
        cacophony_index, _ = calc_cacophony_index(filter_tracks(tracks), length)
        max_chirps = get_max_chirps(length)
        result["duration"] = duration
        result["cacophony_index"] = cacophony_index
        result["cacophony_index_version"] = "2.0"
        result["chirps"] = {
            "chirps": chirps,
            "max_chirps": max_chirps,
            "chirp_index": 0 if max_chirps == 0 else round(100 * chirps / max_chirps),
            "signals": rec_signals,
        }
    result["non_bird_tags"] = NON_BIRD
    result["species_identify"] = [t.get_meta() for t in tracks]
    result["species_identify_version"] = SPECIES_IDENTIFY_VERSION
    return result


def species_identify(file_name, bird_models, analyse_tracks, rng=None, device=None):
    """Full analysis for one recording (reference: src/analyse.py:129-175)."""
    timer = StageTimer()
    meta_data = read_sidecar(file_name)
    classify_res = None
    if bird_models is not None:
        classify_res = classify(
            file_name, bird_models, analyse_tracks, meta_data, rng=rng, timer=timer,
            device=device,
        )
    if classify_res is None:
        # no models, or tracks to analyse without a sidecar: no labels
        result = recording_result([], [], 0, 0, [], None, analyse_tracks=True)
    else:
        tracks, length, signals, raw_length, bird_labels = classify_res
        with timer.stage("post"):
            result = recording_result(tracks, signals, length, raw_length, bird_labels,
                                      meta_data, analyse_tracks)
    if timings_on():
        # framework extension: per-stage wall clock (decode/detect/infer/post)
        result["timing"] = timer.as_dict()
    return result


def examine(file_name, bird_model, analyse_tracks=False, rng=None, device=None):
    """Reference: src/analyse.py:367-373."""
    summary = {}
    summary.update(
        species_identify(file_name, bird_model, analyse_tracks, rng=rng, device=device)
    )
    return summary
