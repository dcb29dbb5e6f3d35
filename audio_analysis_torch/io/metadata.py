"""Sidecar metadata JSON read/merge-write (reference contract).

A recording ``foo.wav`` may carry ``foo.txt`` with JSON metadata (location,
human-marked Tracks); analysis merges its result back under the
``analysis_result`` key with sorted keys and indent 4
(reference: src/analyse.py:132-137, 457-468; src/common.py:216-217).
"""

import json
from pathlib import Path


def jsdump(source) -> str:
    """Stable JSON dump (reference: src/common.py:216-217)."""
    return json.dumps(source, sort_keys=True, indent=4)


def sidecar_path(audio_file) -> Path:
    return Path(audio_file).with_suffix(".txt")


def read_sidecar(audio_file):
    """Return the sidecar metadata dict, or None when absent."""
    meta_file = sidecar_path(audio_file)
    if not meta_file.exists():
        return None
    with meta_file.open("r") as f:
        return json.load(f)


def write_sidecar_result(audio_file, summary) -> Path:
    """Merge `summary` into the sidecar under "analysis_result"
    (reference: src/analyse.py:457-468)."""
    meta_file = sidecar_path(audio_file)
    if meta_file.exists():
        with meta_file.open("r") as f:
            metadata = json.load(f)
    else:
        metadata = {}
    metadata["analysis_result"] = summary
    with meta_file.open("w") as f:
        json.dump(metadata, f, sort_keys=True, indent=4)
    return meta_file
