"""Read ``.keras`` archives without TensorFlow or h5py (the JAX package's
io/keras_import.py).

The archive is a zip of config.json (the graph), metadata.json (the saving
Keras version) and model.weights.h5, whose weights sit under
``layers/<name>/vars/<i>`` (nested functionals recurse through
``layers/<name>/layers/...``). The HDF5 file is read by ``io/h5read.py``.
"""

import json
import zipfile
from pathlib import Path

from audio_analysis_torch.io.h5read import read_h5


def read_keras_archive(path):
    """Return (config_dict, weights, meta) where weights maps
    "layer/path" -> [np.ndarray var0, var1, ...] in Keras variable order and
    meta is the archive's metadata.json ({"keras_version": ...} — the
    saving generation changes both graph-ref conventions and some
    activation SEMANTICS, e.g. Keras-2 hard_sigmoid)."""
    path = Path(path)
    if path.is_dir():
        # a model dir containing the archive (reference passes either form)
        candidates = sorted(path.glob("*.keras"))
        if not candidates:
            raise FileNotFoundError(f"no .keras archive in {path}")
        path = candidates[0]
    with zipfile.ZipFile(path) as z:
        config = json.loads(z.read("config.json"))
        h5_bytes = z.read("model.weights.h5")
        try:
            meta = json.loads(z.read("metadata.json"))
        except KeyError:
            meta = {}
    weights = _read_weights_h5(h5_bytes)
    return config, weights, meta


def _read_weights_h5(h5_bytes):
    weights = {}

    def walk(group, prefix):
        for key, item in group.items():
            if key == "vars" and isinstance(item, dict):
                arrs = [item[idx].array for idx in sorted(item, key=int)]
                if arrs:
                    weights[prefix.rstrip("/")] = arrs
                continue
            if not isinstance(item, dict):  # stray dataset
                continue
            walk(item, prefix + key + "/")

    tree = read_h5(h5_bytes)
    walk(tree.get("layers", tree), "")
    return weights
