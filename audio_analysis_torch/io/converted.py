"""Converted SavedModels: where the JAX package's ``io/convert.py`` caches a
TF SavedModel converted to a ``.keras`` archive, and the check that the
cache is current (``_cache_dir_for`` and the stamp check of
``auto_convert_saved_model``).

The port runs a converted member TF-free; it never converts one, since
conversion needs tensorflow. A member without a current cache raises.
"""

import hashlib
import os
from pathlib import Path

ARCHIVE = "audioModel.keras"


def cache_dir_for(src) -> Path:
    """The conversion cache of the SavedModel dir `src`: ``<src>/.aat_native``
    when `src` is writable, else ``~/.cache/audio_analysis_tpu/converted/``
    keyed by the dir's resolved path and mtime."""
    src = Path(src)
    if os.access(src, os.W_OK):
        return src / ".aat_native"
    key = hashlib.sha1(f"{src.resolve()}:{src.stat().st_mtime_ns}".encode()).hexdigest()[:16]
    return Path.home() / ".cache" / "audio_analysis_tpu" / "converted" / key


def converted_model_dir(src) -> Path:
    """The converted model dir (holding ``audioModel.keras``) of the
    SavedModel dir `src`. Its ``.stamp`` must hold ``saved_model.pb``'s
    st_mtime_ns; otherwise the conversion is missing or stale and this
    raises RuntimeError."""
    src = Path(src)
    pb = src / "saved_model.pb"
    if not pb.exists():
        raise FileNotFoundError(f"{src} has no saved_model.pb")
    cache = cache_dir_for(src)
    stamp = cache / ".stamp"
    if (stamp.exists() and stamp.read_text() == str(pb.stat().st_mtime_ns)
            and (cache / ARCHIVE).exists()):
        return cache
    state = "is stale" if stamp.exists() else "is missing"
    raise RuntimeError(
        f"the converted copy of the SavedModel at {src} ({cache / ARCHIVE}) {state}; "
        "convert it on a machine with tensorflow: the JAX package's loader converts and "
        "stamps it in place (audio_analysis_tpu/io/convert.py::auto_convert_saved_model), "
        f"or run python tools/convert_model.py {src} {cache} and write saved_model.pb's "
        f"st_mtime_ns to {stamp} (converting in the port: ROADMAP Queue 1, item 11)"
    )
