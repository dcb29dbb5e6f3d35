"""EfficientNetB0 (``benchref/effnet.py``): the zero-weight ``.keras``
archive beside the configuration (Keras' EfficientNetB0 at the
configuration's input), seeded in place: conv and dense kernels He-normal
over their fan-in, biases 0, BatchNorm gamma ~1 and beta ~0 (perturbed),
Normalization mean 0 and variance 1; then BatchNorm's moving statistics
set to the batch statistics the reference's EfficientNetB0 sees on
calibration windows, as training would leave them. Written into the HDF5
weights at each dataset's offset (the archive's layout does not change).
"""

import json
import zipfile
from pathlib import Path

import numpy as np
import torch

from benchlib.fixtures import Draws, calibration_windows, keras_groups, write_archive
from benchref import effnet
from benchref.analyse import Model


def _weights(n_labels, seed, device):
    shapes = effnet.weight_shapes(n_labels)
    drawn = sum(int(np.prod(s)) for vs in shapes.values() for s in vs if len(s) > 1) + sum(
        2 * vs[0][0] for name, vs in shapes.items() if len(vs) == 4)
    d = Draws(drawn, seed, device)
    w = {}
    for name, vs in shapes.items():
        if name == "normalization":
            w[name] = [torch.zeros(3, device=device), torch.ones(3, device=device)]
        elif len(vs) == 4:  # BatchNormalization
            c = vs[0][0]
            w[name] = [1.0 + 0.1 * d.take((c,)), 0.1 * d.take((c,)),
                       torch.zeros(c, device=device), torch.ones(c, device=device)]
        else:
            kernel = vs[0]
            fan_in = int(np.prod(kernel[:-2])) * (1 if "dwconv" in name else kernel[-2])
            w[name] = [d.take(kernel) * float(np.sqrt(2.0 / fan_in))] + [
                torch.zeros(s, device=device) for s in vs[1:]]
    return w



def build(spec, root, model_dir: Path, seed, device, calib_pcm):
    meta = spec["metadata"]
    w = _weights(len(meta["labels"]), seed, device)
    stats = {}
    net = effnet.EfficientNetB0(w)
    with torch.no_grad():
        net(calibration_windows(calib_pcm, meta, device), calibrate=stats)
    for name, (mean, var) in stats.items():
        w[name][2], w[name][3] = mean, var
    zero = root / spec["archive"]
    with zipfile.ZipFile(zero) as z:
        groups = keras_groups(json.loads(z.read("config.json")))
    model_dir.mkdir(parents=True, exist_ok=True)
    write_archive(zero, model_dir / "audioModel.keras", {k: w[k] for k in w}, groups)
    (model_dir / "metadata.txt").write_text(json.dumps(meta, indent=4, sort_keys=True))
    return Model(meta, net)


def macs(config, spec):
    h, w, _ = config["input"]
    return effnet.macs(h, w, len(spec["metadata"]["labels"]))
