"""Classifier loading: route a model path to its backend (the JAX
package's models/registry.py).

- a native checkpoint dir (metadata.txt with ``"architecture": "tuinet"``,
  or any dir with weights.npz): TuiNet;
- ``"architecture": "dense"``: a dense stack over flat vectors;
- ``"architecture": "ast"``: the Audio Spectrogram Transformer
  (``models/ast.py``) from a native checkpoint, its widths from the
  metadata (``io/modelconfig.py``), its token grid from ``n_mels`` and the
  window's frames;
- any other ``"architecture"`` value: a ``ValueError`` naming the known ones;
- a ``.keras`` archive (or a dir containing one): imported without
  TensorFlow or h5py into the ``KerasModel`` executor, in the compute dtype
  ``_resolved_compute_dtype`` picks.

Every returned model is an ``nn.Module`` in eval mode on the requested
device, mapping a [n_windows, ...] feature grid to probabilities.
"""

from pathlib import Path

import torch
from torch import nn

from audio_analysis_torch.io.checkpoint import load_checkpoint_params
from audio_analysis_torch.io.modelconfig import ModelConfig
from audio_analysis_torch.models.ast import AST, ASTConfig
from audio_analysis_torch.models.birdnet import TuiNet, TuiNetConfig
from audio_analysis_torch.models.keras_graph import KerasModel
from audio_analysis_torch.utils.profiling import span
from audio_analysis_torch.utils.runtime import env_flag, fast_mode

_MODEL_CACHE = {}
ARCHITECTURES = ("tuinet", "dense", "ast")
SR = 48000  # the rate every recording is analysed at (io/audio.py::load_recording)

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


def _resolved_compute_dtype(cfg: ModelConfig):
    """The compute dtype a Keras load would actually use: metadata
    net_dtype wins; otherwise AAT_KERAS_BF16 (explicit) or the AAT_FAST
    preset picks bf16. Cache-keying on the RESOLVED value (not the raw env)
    means a pinned net_dtype model — or A/B flips that resolve to the same
    dtype — shares one device-resident instance."""
    cdt = (cfg.raw or {}).get("net_dtype")
    if cdt is not None:
        return str(cdt)
    bf16 = env_flag("AAT_KERAS_BF16")
    if bf16 is None:
        bf16 = fast_mode()
    return "bfloat16" if bf16 else None


def load_classifier(model_path, cfg: ModelConfig, device):
    """Load (and cache per path + mtime + device + compute dtype) a
    classifier."""
    model_path = Path(model_path)
    try:
        stamp = (max(p.stat().st_mtime for p in model_path.rglob("*"))
                 if model_path.is_dir() else model_path.stat().st_mtime)
    except (OSError, ValueError):
        stamp = 0
    key = (str(model_path.resolve()), stamp, str(device), _resolved_compute_dtype(cfg))
    model = _MODEL_CACHE.get(key)
    if model is None:
        with span("models.build"):
            model = _load_uncached(model_path, cfg).to(device).eval().requires_grad_(False)
        _MODEL_CACHE[key] = model
    return model


def _load_uncached(model_path: Path, cfg: ModelConfig) -> nn.Module:
    raw = cfg.raw or {}
    arch = raw.get("architecture")
    activation = raw.get("output_activation", "softmax")
    if arch is not None and arch not in ARCHITECTURES:
        raise ValueError(f"unknown architecture {arch!r} in {model_path}: "
                         f"known are {', '.join(ARCHITECTURES)}")
    if arch == "ast":
        net_cfg = ASTConfig(
            num_classes=len(cfg.labels) or int(raw.get("num_classes", 8)),
            n_mels=int(cfg.n_mels),
            frames=1 + int(cfg.segment_length * SR) // int(cfg.hop_length),
            dim=int(cfg.net_dim), depth=int(cfg.net_depth), heads=int(cfg.net_heads),
            mlp=int(cfg.net_mlp), patch=int(cfg.net_patch), stride=int(cfg.net_patch_stride),
            norm_mean=float(cfg.norm_mean), norm_std=float(cfg.norm_std),
            dtype=raw.get("net_dtype", "bfloat16"),
        )
        net = AST.from_params(load_checkpoint_params(model_path), net_cfg)
        return _WithActivation(net, activation)
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
    # a Keras archive (file or dir containing one); its output layer gives
    # the probabilities
    return KerasModel.load(model_path, compute_dtype=_resolved_compute_dtype(cfg))
