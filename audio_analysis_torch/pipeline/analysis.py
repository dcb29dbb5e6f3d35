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
from audio_analysis_torch.utils.runtime import StageTimer, env_flag

SPECIES_IDENTIFY_VERSION = "2025-12-01"


def species_identify(file_name, bird_models, analyse_tracks, rng=None, device=None):
    """Full analysis for one recording (reference: src/analyse.py:129-175)."""
    labels = []
    result = {}
    timer = StageTimer()
    meta_data = read_sidecar(file_name)
    region_code = None  # quirk kept: never set, so the field never emits

    if bird_models is not None:
        classify_res = classify(
            file_name, bird_models, analyse_tracks, meta_data, rng=rng, timer=timer,
            device=device,
        )
        if classify_res is not None:
            tracks, length, signals, raw_length, bird_labels = classify_res

            with timer.stage("post"):
                if meta_data is not None:
                    filter_by_location(meta_data, tracks)

                for t in tracks:
                    t.set_master_tag()
                rec_signals = [s.to_array() for s in signals]
                chirps = get_chirps(tracks, bird_labels, signals)
                cacophony_index, version = calc_cacophony_index(
                    filter_tracks(tracks), length
                )
                labels.extend([track.get_meta() for track in tracks])

            if not analyse_tracks:
                max_chirps = get_max_chirps(length)
                version = "2.0"
                chirp_index = 0 if max_chirps == 0 else round(100 * chirps / max_chirps)
                if region_code is not None:
                    result["region_code"] = region_code
                result["duration"] = raw_length
                result["cacophony_index"] = cacophony_index
                result["cacophony_index_version"] = version
                result["chirps"] = {
                    "chirps": chirps,
                    "max_chirps": max_chirps,
                    "chirp_index": chirp_index,
                    "signals": rec_signals,
                }
    result["non_bird_tags"] = NON_BIRD
    result["species_identify"] = labels
    result["species_identify_version"] = SPECIES_IDENTIFY_VERSION
    if env_flag("AAT_TIMINGS"):
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
