"""Native checkpoint format: metadata.txt (the reference's schema) + a flat
``weights.npz`` holding the parameter tree (the JAX package's
io/checkpoint.py). Both packages read what either writes."""

import json
from pathlib import Path

import numpy as np
import torch


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            if "/" in str(k):
                raise ValueError(
                    f"parameter name {k!r} contains '/', which is the "
                    "checkpoint path separator; rename the leaf"
                )
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif isinstance(tree, torch.Tensor):
        out[prefix.rstrip("/")] = tree.detach().cpu().numpy()
    else:
        out[prefix.rstrip("/")] = np.asarray(tree)
    return out


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


def save_checkpoint(model_dir, params, meta: dict):
    """Write metadata.txt + weights.npz into `model_dir`. `params` is a tree
    of dicts and lists over numpy arrays or tensors (moved to the host)."""
    model_dir = Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    (model_dir / "metadata.txt").write_text(json.dumps(meta, indent=4, sort_keys=True))
    np.savez(model_dir / "weights.npz", **_flatten(params))
    return model_dir


def load_checkpoint_params(model_dir):
    """The parameter tree (numpy arrays) from weights.npz."""
    with np.load(Path(model_dir) / "weights.npz") as z:
        flat = {k: z[k] for k in z.files}
    return _unflatten(flat)
