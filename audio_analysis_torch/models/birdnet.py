"""TuiNet: the framework's native bird classifier as an ``nn.Module``
(the JAX package's models/birdnet.py).

Input NHWC [B, n_mels, T, 1] mel windows -> logits [B, num_classes]:
MagTransform, a stride-2 3x3 stem conv, then per width in ``channels`` two
3x3 conv + BN + relu layers and a 2x2 SAME max-pool, global average pool
and a two-layer dense head. Compute runs in ``cfg.dtype`` (float32, or
bfloat16 with BN and the head in float32, as in the JAX package).
``from_jax_params`` carries the JAX parameter tree (weights.npz) across and
``to_jax_params`` writes it back; ``init`` draws fresh weights from a
``torch.Generator`` (the JAX package's ``init_params`` distributions).

In ``.train()`` mode BatchNorm normalises with the batch statistics (mean
and biased variance over N, H, W, gradients flowing through both) and
``forward(x, with_stats=True)`` returns them, detached, for the running
statistics' EMA (parallel/train.py).
"""

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from audio_analysis_torch.models import layers as L
from audio_analysis_torch.models.magtransform import mag_transform


@dataclass(frozen=True)
class TuiNetConfig:
    num_classes: int = 8
    n_mels: int = 160
    time_steps: int = 226  # 3 s at 48 kHz / hop 640 -> 1 + 144000//640
    channels: tuple = (64, 128, 256)
    stem_channels: int = 32
    dense_units: int = 256
    dtype: str = "bfloat16"  # compute dtype; params stay float32


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class _BatchNorm(nn.Module):
    """BN (eps 1e-3) over the last (channel) axis: the running statistics
    in eval mode, the batch's in train mode. Returns (y, batch statistics
    or None)."""

    def __init__(self, c):
        super().__init__()
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))
        self.gamma = nn.Parameter(torch.ones(c))
        self.beta = nn.Parameter(torch.zeros(c))

    def forward(self, x, group=None):
        if not self.training:
            return L.batch_norm(x, self.mean, self.var, self.gamma, self.beta, eps=1e-3), None
        mean, var = L.batch_moments(x, (0, 1, 2), group)
        y = L.batch_norm(x, mean, var, self.gamma, self.beta, eps=1e-3)
        return y, {"mean": mean.detach(), "var": var.detach()}


class _Block(nn.Module):
    def __init__(self, c_in, c_out):
        super().__init__()
        self.w1 = nn.Parameter(torch.zeros(c_out, c_in, 3, 3))
        self.bn1 = _BatchNorm(c_out)
        self.w2 = nn.Parameter(torch.zeros(c_out, c_out, 3, 3))
        self.bn2 = _BatchNorm(c_out)

    def forward(self, y, dt, group=None):
        y = L.conv2d(y, self.w1.to(dt))
        y, s1 = self.bn1(y.float(), group)
        y = torch.relu(y.to(dt))
        y = L.conv2d(y, self.w2.to(dt))
        y, s2 = self.bn2(y.float(), group)
        y = torch.relu(y.to(dt))
        return L.max_pool2d(y, (2, 2), (2, 2), "SAME"), {"bn1": s1, "bn2": s2}


class TuiNet(nn.Module):
    def __init__(self, cfg: TuiNetConfig):
        super().__init__()
        if cfg.dtype not in _DTYPES:
            raise ValueError(f"TuiNet dtype {cfg.dtype!r} not in {sorted(_DTYPES)}")
        self.cfg = cfg
        self.mag_a = nn.Parameter(torch.full((1,), -1.0))
        self.stem_w = nn.Parameter(torch.zeros(cfg.stem_channels, 1, 3, 3))
        self.stem_b = nn.Parameter(torch.zeros(cfg.stem_channels))
        widths = (cfg.stem_channels,) + tuple(cfg.channels)
        self.blocks = nn.ModuleList(_Block(a, b) for a, b in zip(widths[:-1], widths[1:]))
        self.head_w1 = nn.Parameter(torch.zeros(widths[-1], cfg.dense_units))
        self.head_b1 = nn.Parameter(torch.zeros(cfg.dense_units))
        self.head_w2 = nn.Parameter(torch.zeros(cfg.dense_units, cfg.num_classes))
        self.head_b2 = nn.Parameter(torch.zeros(cfg.num_classes))

    def forward(self, x, with_stats=False, data_group=None, model_group=None):
        """x [B, n_mels, T, 1] -> logits [B, num_classes]; with
        ``with_stats``, (logits, stats): per block {"bn1": {"mean", "var"},
        "bn2": ...} of the batch in train mode (None in eval mode).

        The sharded training step (parallel/train.py) passes its process
        groups: `data_group` makes train-mode BatchNorm normalise with the
        statistics of the whole batch its ranks hold; with `model_group`
        this rank holds a slice of the head (``HEAD_PLAN``), and the
        partial logits are summed over the group before ``head_b2``."""
        dt = _DTYPES[self.cfg.dtype]
        y = mag_transform(torch.clamp(x, min=0.0), self.mag_a).to(dt)
        y = torch.relu(L.conv2d(y, self.stem_w.to(dt), self.stem_b.to(dt), strides=(2, 2)))
        stats = []
        for blk in self.blocks:
            y, s = blk(y, dt, data_group)
            stats.append(s)
        y = L.global_avg_pool2d(y.float())
        if model_group is None:
            y = torch.relu(L.dense(y, self.head_w1, self.head_b1))
            logits = L.dense(y, self.head_w2, self.head_b2)
        else:
            from audio_analysis_torch.parallel.distributed import (
                copy_to_group,
                reduce_from_group,
            )

            y = torch.relu(L.dense(copy_to_group(y, model_group), self.head_w1, self.head_b1))
            logits = reduce_from_group(L.dense(y, self.head_w2), model_group) + self.head_b2
        return (logits, stats) if with_stats else logits

    @classmethod
    def init(cls, cfg: TuiNetConfig, generator: torch.Generator = None) -> "TuiNet":
        """Fresh weights drawn from `generator`, with the JAX package's
        ``init_params`` distributions: He-normal conv kernels over their
        fan-in and a He-normal first head layer, the second head layer
        normal over sqrt(1/dense_units), biases 0, BN gamma 1, beta 0,
        mean 0, var 1, mag_a -1. The draws are not ``jax.random``'s."""
        net = cls(cfg)

        def normal(p, std):
            with torch.no_grad():
                p.copy_(torch.randn(p.shape, generator=generator) * std)

        normal(net.stem_w, math.sqrt(2.0 / 9))
        for blk in net.blocks:
            for w in (blk.w1, blk.w2):
                normal(w, math.sqrt(2.0 / (9 * w.shape[1])))
        normal(net.head_w1, math.sqrt(2.0 / net.head_w1.shape[0]))
        normal(net.head_w2, math.sqrt(1.0 / cfg.dense_units))
        return net

    def to_jax_params(self) -> dict:
        """The JAX parameter tree as float32 numpy (conv kernels OIHW ->
        HWIO): what ``weights.npz`` holds, the inverse of
        ``from_jax_params``."""
        n = lambda t: np.ascontiguousarray(t.detach().float().cpu().numpy())
        hwio = lambda t: n(t.permute(2, 3, 1, 0))
        bn = lambda m: {k: n(getattr(m, k)) for k in ("gamma", "beta", "mean", "var")}
        return {
            "mag_a": n(self.mag_a),
            "stem": {"w": hwio(self.stem_w), "b": n(self.stem_b)},
            "blocks": [{"w1": hwio(b.w1), "bn1": bn(b.bn1), "w2": hwio(b.w2), "bn2": bn(b.bn2)}
                       for b in self.blocks],
            "head": {k: n(getattr(self, f"head_{k}")) for k in ("w1", "b1", "w2", "b2")},
        }

    @classmethod
    def from_jax_params(cls, params, cfg: TuiNetConfig) -> "TuiNet":
        """Build the module, in eval mode, from the JAX parameter tree
        (numpy arrays, as ``weights.npz`` holds them): conv kernels HWIO ->
        OIHW, everything else as it is."""
        net = cls(cfg)
        t = lambda a: torch.from_numpy(np.array(a, np.float32))
        hwio = lambda a: t(a).permute(3, 2, 0, 1).contiguous()
        state = {
            "mag_a": t(params["mag_a"]).reshape(1),
            "stem_w": hwio(params["stem"]["w"]),
            "stem_b": t(params["stem"]["b"]),
            "head_w1": t(params["head"]["w1"]),
            "head_b1": t(params["head"]["b1"]),
            "head_w2": t(params["head"]["w2"]),
            "head_b2": t(params["head"]["b2"]),
        }
        for i, blk in enumerate(params["blocks"]):
            state[f"blocks.{i}.w1"] = hwio(blk["w1"])
            state[f"blocks.{i}.w2"] = hwio(blk["w2"])
            for bn in ("bn1", "bn2"):
                for k in ("mean", "var", "gamma", "beta"):
                    state[f"blocks.{i}.{bn}.{k}"] = t(blk[bn][k])
        net.load_state_dict(state, strict=True)
        return net.eval()
