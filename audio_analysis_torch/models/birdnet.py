"""TuiNet: the framework's native bird classifier as an ``nn.Module``
(the JAX package's models/birdnet.py).

Input NHWC [B, n_mels, T, 1] mel windows -> logits [B, num_classes]:
MagTransform, a stride-2 3x3 stem conv, then per width in ``channels`` two
3x3 conv + BN + relu layers and a 2x2 SAME max-pool, global average pool
and a two-layer dense head. Compute runs in ``cfg.dtype`` (float32, or
bfloat16 with BN and the head in float32, as in the JAX package).
``from_jax_params`` carries the JAX parameter tree (weights.npz) across.
"""

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
    """Inference-mode BN (eps 1e-3) over the last (channel) axis."""

    def __init__(self, c):
        super().__init__()
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))
        self.gamma = nn.Parameter(torch.ones(c))
        self.beta = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return L.batch_norm(x, self.mean, self.var, self.gamma, self.beta, eps=1e-3)


class _Block(nn.Module):
    def __init__(self, c_in, c_out):
        super().__init__()
        self.w1 = nn.Parameter(torch.zeros(c_out, c_in, 3, 3))
        self.bn1 = _BatchNorm(c_out)
        self.w2 = nn.Parameter(torch.zeros(c_out, c_out, 3, 3))
        self.bn2 = _BatchNorm(c_out)

    def forward(self, y, dt):
        y = L.conv2d(y, self.w1.to(dt))
        y = torch.relu(self.bn1(y.float()).to(dt))
        y = L.conv2d(y, self.w2.to(dt))
        y = torch.relu(self.bn2(y.float()).to(dt))
        return L.max_pool2d(y, (2, 2), (2, 2), "SAME")


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

    def forward(self, x):
        dt = _DTYPES[self.cfg.dtype]
        y = mag_transform(torch.clamp(x, min=0.0), self.mag_a).to(dt)
        y = torch.relu(L.conv2d(y, self.stem_w.to(dt), self.stem_b.to(dt), strides=(2, 2)))
        for blk in self.blocks:
            y = blk(y, dt)
        y = L.global_avg_pool2d(y.float())
        y = torch.relu(L.dense(y, self.head_w1, self.head_b1))
        return L.dense(y, self.head_w2, self.head_b2)

    @classmethod
    def from_jax_params(cls, params, cfg: TuiNetConfig) -> "TuiNet":
        """Build the module from the JAX parameter tree (numpy arrays, as
        ``weights.npz`` holds them): conv kernels HWIO -> OIHW, everything
        else as it is."""
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
        return net
