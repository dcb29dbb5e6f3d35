"""Classifier loading: route a model path to its backend (the JAX
package's models/registry.py).

- a native checkpoint dir (metadata.txt with ``"architecture": "tuinet"``,
  or any dir with weights.npz): TuiNet;
- ``"architecture": "dense"``: a dense stack over flat vectors;
- a ``.keras`` archive: not ported yet (ROADMAP Queue 1, item 6).

Every returned model is an ``nn.Module`` in eval mode on the requested
device, mapping a [n_windows, ...] feature grid to probabilities.
"""

from pathlib import Path

import torch
from torch import nn

from audio_analysis_torch.io.checkpoint import load_checkpoint_params
from audio_analysis_torch.io.modelconfig import ModelConfig
from audio_analysis_torch.models.birdnet import TuiNet, TuiNetConfig

_MODEL_CACHE = {}

_ACTIVATIONS = {
    "softmax": lambda z: torch.softmax(z, dim=-1),
    "sigmoid": torch.sigmoid,
    "linear": lambda z: z,
}


class _WithActivation(nn.Module):
    def __init__(self, net, activation):
        super().__init__()
        self.net = net
        self.activation = activation

    def forward(self, x):
        return _ACTIVATIONS[self.activation](self.net(x))


class DenseStack(nn.Module):
    """Dense layers over flat vectors [N, D] (params: list of
    {kernel [in, out], bias}); relu between layers. Optional ``pool`` p
    first mean-pools [N, S] -> [N, S//p, p] -> mean over the middle axis."""

    def __init__(self, params, pool=None):
        super().__init__()
        self.pool = int(pool) if pool else None
        self.kernels = nn.ParameterList(torch.from_numpy(l["kernel"]).float() for l in params)
        self.biases = nn.ParameterList(torch.from_numpy(l["bias"]).float() for l in params)

    def forward(self, x):
        x = x.float()
        if self.pool:
            x = x.reshape(x.shape[0], -1, self.pool).mean(dim=1)
        for i, (k, b) in enumerate(zip(self.kernels, self.biases)):
            x = x @ k + b
            if i < len(self.kernels) - 1:
                x = torch.relu(x)
        return x


def load_classifier(model_path, cfg: ModelConfig, device):
    """Load (and cache per path + mtime + device) a classifier."""
    model_path = Path(model_path)
    try:
        stamp = (max(p.stat().st_mtime for p in model_path.rglob("*"))
                 if model_path.is_dir() else model_path.stat().st_mtime)
    except (OSError, ValueError):
        stamp = 0
    key = (str(model_path.resolve()), stamp, str(device))
    model = _MODEL_CACHE.get(key)
    if model is None:
        model = _load_uncached(model_path, cfg).to(device).eval().requires_grad_(False)
        _MODEL_CACHE[key] = model
    return model


def _load_uncached(model_path: Path, cfg: ModelConfig) -> nn.Module:
    raw = cfg.raw or {}
    arch = raw.get("architecture")
    activation = raw.get("output_activation", "softmax")
    if arch == "dense":
        net = DenseStack(load_checkpoint_params(model_path), raw.get("net_pool"))
        return _WithActivation(net, activation)
    if arch == "tuinet" or (model_path.is_dir() and (model_path / "weights.npz").exists()):
        net_cfg = TuiNetConfig(
            num_classes=len(cfg.labels) or int(raw.get("num_classes", 8)),
            n_mels=int(cfg.n_mels),
            channels=tuple(raw.get("net_channels", (64, 128, 256))),
            stem_channels=int(raw.get("net_stem_channels", 32)),
            dense_units=int(raw.get("net_dense_units", 256)),
            dtype=raw.get("net_dtype", "bfloat16"),
        )
        net = TuiNet.from_jax_params(load_checkpoint_params(model_path), net_cfg)
        return _WithActivation(net, activation)
    raise NotImplementedError(
        f"{model_path}: Keras archives need the Keras graph executor, which is "
        "not ported yet (ROADMAP Queue 1, item 6)"
    )
