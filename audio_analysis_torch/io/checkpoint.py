"""Native checkpoint load: metadata.txt + a flat ``weights.npz`` holding the
parameter tree (the load side of the JAX package's io/checkpoint.py)."""

from pathlib import Path

import numpy as np


def _unflatten(flat):
    root = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        # only contiguous 0..n-1 digit keys round-trip to a list
        if keys and all(k.isdigit() for k in keys):
            idx = sorted(int(k) for k in keys)
            if idx == list(range(len(keys))):
                return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def load_checkpoint_params(model_dir):
    """The parameter tree (numpy arrays) from weights.npz."""
    with np.load(Path(model_dir) / "weights.npz") as z:
        flat = {k: z[k] for k in z.files}
    return _unflatten(flat)
