"""TuiNet (``benchref/tuinet.py``): ``metadata.txt`` and ``weights.npz``
in the JAX layout (HWIO kernels), He-normal kernels, BatchNorm gamma ~1 and
beta ~0 (perturbed), its statistics calibrated on the reference's own
forward as EfficientNetB0's are.
"""

import json
from pathlib import Path

import numpy as np
import torch

from benchlib.fixtures import Draws, calibration_windows
from benchref.analyse import Model
from benchref.tuinet import TuiNet, macs as tuinet_macs

SR = 48000


def build(spec, root, model_dir: Path, seed, device, calib_pcm):
    meta = spec["metadata"]
    channels, stem = meta["net_channels"], meta["net_stem_channels"]
    dense, labels = meta["net_dense_units"], len(meta["labels"])
    shapes = {"stem/w": (3, 3, 1, stem)}
    c_in = stem
    for i, c in enumerate(channels):
        shapes[f"blocks/{i}/w1"], shapes[f"blocks/{i}/w2"] = (3, 3, c_in, c), (3, 3, c, c)
        c_in = c
    shapes["head/w1"], shapes["head/w2"] = (c_in, dense), (dense, labels)
    n_bn = 2 * sum(channels)
    d = Draws(sum(int(np.prod(s)) for s in shapes.values()) + 2 * n_bn + stem + dense + labels,
               seed, device)
    fan = lambda s: int(np.prod(s[:-1]))
    w = {k: d.take(s) * float(np.sqrt((1.0 if k == "head/w2" else 2.0) / fan(s)))
         for k, s in shapes.items()}
    w["mag_a"] = torch.full((1,), -1.0, device=device)
    w["stem/b"] = 0.01 * d.take((stem,))
    for i, c in enumerate(channels):
        for bn in ("bn1", "bn2"):
            p = f"blocks/{i}/{bn}/"
            w[p + "gamma"] = 1.0 + 0.1 * d.take((c,))
            w[p + "beta"] = 0.1 * d.take((c,))
            w[p + "mean"], w[p + "var"] = torch.zeros(c, device=device), torch.ones(c, device=device)
    w["head/b1"] = 0.01 * d.take((dense,))
    w["head/b2"] = 0.01 * d.take((labels,))
    net = TuiNet(w)
    stats = {}
    with torch.no_grad():
        net(calibration_windows(calib_pcm, meta, device)[..., :1], calibrate=stats)
    for prefix, (mean, var) in stats.items():
        w[prefix + "mean"], w[prefix + "var"] = mean, var
    model_dir.mkdir(parents=True, exist_ok=True)
    (model_dir / "metadata.txt").write_text(json.dumps(meta, indent=4, sort_keys=True))
    np.savez(model_dir / "weights.npz", **{k: v.detach().cpu().numpy() for k, v in w.items()})
    return Model(meta, net)


def macs(config, spec):
    m = spec["metadata"]
    frames = 1 + int(m["segment_length"] * SR) // int(m["hop_length"])
    return tuinet_macs(int(m["n_mels"]), frames, m["net_channels"], m["net_stem_channels"],
                       m["net_dense_units"], len(m["labels"]))
