"""TuiNet, the repo's native classifier, in plain PyTorch, inference mode:
MagTransform (x clamped at 0, raised to sigmoid(a)), a stride-2 3x3 stem
with bias and relu, per width two 3x3 convolutions each followed by
BatchNorm (eps 1e-3, running statistics) and relu, then a 2x2 max-pool
(TF SAME padding), global average pooling, a dense relu layer and a dense
layer, softmax. Convolutions take TF SAME padding. Weights are the JAX
layout that ``weights.npz`` holds (HWIO kernels), as float32 tensors.
"""

import math

import torch
import torch.nn.functional as F

from benchref.dsp import fp8_round
from benchref.effnet import cnn_precision

BN_EPS = 1e-3


def same_pads(size, k, stride):
    out = math.ceil(size / stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _same(x, k, stride, value=0.0):
    (t, b), (l, r) = same_pads(x.shape[2], k, stride), same_pads(x.shape[3], k, stride)
    return F.pad(x, (l, r, t, b), value=value)


class TuiNet:
    """forward(x [N, n_mels, T, 1]) -> softmax probabilities [N, labels].
    With ``calibrate`` (a dict), BatchNorm normalises with the batch's
    statistics and stores them under each BatchNorm's key prefix."""

    def __init__(self, w, mode="float32"):
        self.w = w
        self.mode = mode

    def _q(self, t):
        return fp8_round(t) if self.mode == "fp8" else t

    def conv(self, x, kernel, bias=None, stride=1):
        k = kernel.permute(3, 2, 0, 1).contiguous()
        return F.conv2d(self._q(_same(x, k.shape[-1], stride)), self._q(k), bias, stride=stride)

    def bn(self, x, prefix, calibrate):
        p = {k: self.w[prefix + k] for k in ("gamma", "beta", "mean", "var")}
        if calibrate is not None:
            p["mean"], p["var"] = x.mean(dim=(0, 2, 3)), x.var(dim=(0, 2, 3), unbiased=False)
            calibrate[prefix] = (p["mean"], p["var"])
        shape = (1, -1, 1, 1)
        return ((x - p["mean"].reshape(shape)) * torch.rsqrt(p["var"].reshape(shape) + BN_EPS)
                * p["gamma"].reshape(shape) + p["beta"].reshape(shape))

    def __call__(self, x, calibrate=None):
        w = self.w
        with cnn_precision(self.mode):
            y = torch.pow(torch.clamp(x, min=0.0), torch.sigmoid(w["mag_a"])).permute(0, 3, 1, 2)
            y = torch.relu(self.conv(y, w["stem/w"], w["stem/b"], stride=2))
            i = 0
            while f"blocks/{i}/w1" in w:
                y = torch.relu(self.bn(self.conv(y, w[f"blocks/{i}/w1"]), f"blocks/{i}/bn1/",
                                       calibrate))
                y = torch.relu(self.bn(self.conv(y, w[f"blocks/{i}/w2"]), f"blocks/{i}/bn2/",
                                       calibrate))
                y = F.max_pool2d(_same(y, 2, 2, float("-inf")), 2, 2)
                i += 1
            y = y.mean(dim=(2, 3))
            y = torch.relu(self._q(y) @ self._q(w["head/w1"]) + w["head/b1"])
            return torch.softmax(self._q(y) @ self._q(w["head/w2"]) + w["head/b2"], dim=-1)


def macs(n_mels, frames, channels, stem, dense, n_labels):
    """Multiply-accumulates of one forward over an [n_mels, frames, 1]
    window, counted from the layer shapes (convolutions and the head)."""
    h, w = -(-n_mels // 2), -(-frames // 2)
    total = h * w * 9 * stem
    c_in = stem
    for c in channels:
        total += h * w * 9 * (c_in * c + c * c)
        h, w = -(-h // 2), -(-w // 2)
        c_in = c
    return total + c_in * dense + dense * n_labels
