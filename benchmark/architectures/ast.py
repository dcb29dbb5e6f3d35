"""The Audio Spectrogram Transformer (``benchref/ast.py``): ``metadata.txt``
and ``weights.npz`` as ``models/ast.py`` reads them, drawn from the seed at
a scale where attention is peaked: the dense kernels, the patch kernel and
the head normal with std 1.5 / sqrt(fan-in); the [CLS] and [DIST] tokens
N(0, 1) and the position embedding 0.5 N(0, 1), of the order of the patch
embeddings; the biases 0.1 N(0, 1); LayerNorm gamma 1 + 0.1 N(0, 1) and
beta 0.1 N(0, 1), as TuiNet's BatchNorm is perturbed. Published ViT
initialisation (std 0.02 throughout) leaves attention near uniform over the
1,142 tokens, so that leaving [DIST] out of the pooled output, a
time-major token order or a wrong attention scale moves the probabilities
less than the check's limits; at this scale each fails them. The input
normalisation's mean and std are those of the reference's own features of
the calibration windows, as EfficientNetB0's BatchNorm statistics are
calibrated. The weights (345 MB in float32 at ViT-B widths) go under the
run's work directory.
"""

import json
from pathlib import Path

import numpy as np

from benchlib.fixtures import Draws, calibration_windows
from benchref.analyse import Model
from benchref.ast import AST, grid
from benchref.ast import macs as ast_macs

SR = 48000


def widths(meta):
    """(dim, depth, heads, mlp, patch, stride, n_mels, frames, labels)."""
    frames = 1 + int(meta["segment_length"] * SR) // int(meta["hop_length"])
    return (int(meta["net_dim"]), int(meta["net_depth"]), int(meta["net_heads"]),
            int(meta["net_mlp"]), int(meta["net_patch"]), int(meta["net_patch_stride"]),
            int(meta["n_mels"]), frames, len(meta["labels"]))


# each kind of weight from a standard normal z and its fan-in
INIT = {
    "kernel": lambda z, fan_in: 1.5 * z / fan_in ** 0.5,
    "token": lambda z, _: z,
    "pos": lambda z, _: 0.5 * z,
    "bias": lambda z, _: 0.1 * z,
    "gamma": lambda z, _: 1.0 + 0.1 * z,
    "beta": lambda z, _: 0.1 * z,
}


def shapes(meta):
    """{key: (kind, shape, fan-in)} of every weight, in the order they are
    drawn; the kinds are INIT's."""
    dim, depth, _, mlp, patch, stride, n_mels, frames, labels = widths(meta)
    fg, tg = grid(n_mels, frames, patch, stride)
    out = {"patch/w": ("kernel", (patch, patch, 1, dim), patch * patch),
           "patch/b": ("bias", (dim,), 0),
           "cls": ("token", (dim,), 0), "dist": ("token", (dim,), 0),
           "pos": ("pos", (fg * tg + 2, dim), 0)}
    for i in range(depth):
        p = f"blocks/{i}/"
        for ln in ("ln1", "ln2"):
            out[p + ln + "/gamma"] = ("gamma", (dim,), 0)
            out[p + ln + "/beta"] = ("beta", (dim,), 0)
        for name, n_in, n_out in (("qkv", dim, 3 * dim), ("proj", dim, dim), ("fc1", dim, mlp),
                                  ("fc2", mlp, dim)):
            out[p + name + "/w"] = ("kernel", (n_in, n_out), n_in)
            out[p + name + "/b"] = ("bias", (n_out,), 0)
    for ln in ("norm", "head/ln"):
        out[ln + "/gamma"], out[ln + "/beta"] = ("gamma", (dim,), 0), ("beta", (dim,), 0)
    out["head/w"], out["head/b"] = ("kernel", (dim, labels), dim), ("bias", (labels,), 0)
    return out


def build(spec, root, model_dir: Path, seed, device, calib_pcm):
    meta = dict(spec["metadata"])
    drawn = shapes(meta)
    d = Draws(sum(int(np.prod(s)) for _, s, _ in drawn.values()), seed, device)
    w = {k: INIT[kind](d.take(s), fan_in) for k, (kind, s, fan_in) in drawn.items()}
    feats = calibration_windows(calib_pcm, meta, device)[..., 0]
    meta["norm_mean"], meta["norm_std"] = float(feats.mean()), float(feats.std())
    model_dir.mkdir(parents=True, exist_ok=True)
    (model_dir / "metadata.txt").write_text(json.dumps(meta, indent=4, sort_keys=True))
    np.savez(model_dir / "weights.npz", **{k: v.detach().cpu().numpy() for k, v in w.items()})
    w.update(heads=int(meta["net_heads"]), stride=int(meta["net_patch_stride"]),
             mean=meta["norm_mean"], std=meta["norm_std"])
    return Model(meta, AST(w))


def macs(config, spec):
    dim, depth, heads, mlp, patch, stride, n_mels, frames, labels = widths(spec["metadata"])
    return ast_macs(n_mels, frames, dim, depth, heads, mlp, patch, stride, labels)
