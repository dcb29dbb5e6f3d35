"""The models a configuration names, made from the seed on the device and
written where the program loads them from, and the same weights handed to
the reference. Each ``architecture`` is a file of its own,
``benchmark/architectures/<architecture>.py``, found by name: its
``build(spec, root, model_dir, seed, device, calib_pcm)`` draws the
weights, writes them as the program reads them and returns the reference's
``Model``; its ``macs(config, spec)`` counts one window's multiply-adds
from the layer shapes. What they share is here.

Every draw is one ``torch.randn`` on the device from a generator seeded
from the run's seed, sliced in a fixed order.
"""

import zipfile
from pathlib import Path

import numpy as np
import torch

from benchlib import h5read
from benchref import dsp

KERAS_GROUP = {  # Keras 3 names each layer's weight group after its class
    "InputLayer": "input_layer", "Rescaling": "rescaling", "Normalization": "normalization",
    "ZeroPadding2D": "zero_padding2d", "Conv2D": "conv2d",
    "BatchNormalization": "batch_normalization", "Activation": "activation",
    "DepthwiseConv2D": "depthwise_conv2d", "GlobalAveragePooling2D": "global_average_pooling2d",
    "Reshape": "reshape", "Multiply": "multiply", "Dropout": "dropout", "Add": "add",
    "Dense": "dense",
}


def keras_groups(config_json: dict) -> dict:
    """{layer name: weight group} ('stem_bn' -> 'batch_normalization'), as
    Keras numbers the groups of one class in the order of the layers."""
    seen, out = {}, {}
    for layer in config_json["config"]["layers"]:
        base = KERAS_GROUP[layer["class_name"]]
        k = seen.get(base, 0)
        seen[base] = k + 1
        out[layer["config"]["name"]] = base if k == 0 else f"{base}_{k}"
    return out


class Draws:
    """Consecutive slices of one standard-normal draw on the device."""

    def __init__(self, total, seed, device):
        g = torch.Generator(device=device).manual_seed(seed)
        self.z = torch.randn(total, generator=g, device=device)
        self.at = 0

    def take(self, shape):
        n = int(np.prod(shape)) if shape else 1
        out = self.z[self.at : self.at + n].reshape(shape)
        self.at += n
        return out


def calibration_windows(pcm, meta, device, n=15):
    """Up to n 3 s windows at a 1.5 s stride from the start of `pcm`, before
    its silent tail, through the reference frontend, repeated to 3 channels."""
    y = torch.from_numpy(pcm).to(device).to(torch.float32) / 32768.0
    size, hop = 3 * 48000, 48000 * 3 // 2
    n = max(1, min(n, (int(np.flatnonzero(pcm).max()) + 1 - size) // hop + 1))
    windows = torch.stack([y[i * hop : i * hop + size] for i in range(n)])
    return dsp.features(windows, meta).repeat_interleave(3, dim=-1)


def write_archive(zero: Path, out: Path, weights: dict, groups: dict):
    with zipfile.ZipFile(zero) as z:
        infos = z.infolist()
        members = {i.filename: z.read(i) for i in infos}
    h5 = bytearray(members["model.weights.h5"])
    tree = h5read.read_h5(bytes(h5))["layers"]
    for name, arrays in weights.items():
        vs = tree[groups[name]]["vars"]
        for i, a in enumerate(arrays):
            ds = vs[str(i)]
            a = np.asarray(a.detach().cpu().numpy(), dtype=ds.array.dtype)
            if a.shape != ds.array.shape:
                raise ValueError(f"{name}/{i}: {a.shape} where the archive has {ds.array.shape}")
            raw = a.tobytes()
            h5[ds.offset : ds.offset + len(raw)] = raw
    members["model.weights.h5"] = bytes(h5)
    with zipfile.ZipFile(out, "w") as z:
        for info in infos:
            keep = zipfile.ZipInfo(info.filename, info.date_time)
            keep.compress_type, keep.external_attr = info.compress_type, info.external_attr
            z.writestr(keep, members[info.filename])


def build_models(config, root, workdir: Path, seed, device, calib_pcm):
    """[(model dir, reference Model)] for the configuration's models, in
    its order; model i is drawn from seed (seed, i)."""
    from benchlib.spec import load_architecture

    arch = load_architecture(config["architecture"], root)
    out = []
    for i, spec in enumerate(config["models"]):
        sub = int(np.random.SeedSequence([seed, i]).generate_state(1, np.uint64)[0] >> 1)
        model_dir = workdir / f"model{i}"
        out.append((model_dir, arch.build(spec, root, model_dir, sub, device, calib_pcm)))
    return out
