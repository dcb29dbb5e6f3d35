"""The Audio Spectrogram Transformer as an ``nn.Module``: Gong, Chung and
Glass, "AST: Audio Spectrogram Transformer", Interspeech 2021
(arXiv:2104.01778), as github.com/YuanGongND/ast lays it out over timm's
DeiT-base, at the ViT-B/16 widths by default.

Classify features [N, n_mels, frames, 1] -> logits [N, num_classes]:

- the AST input normalisation (x - norm_mean) / (2 norm_std);
- transposed to [N, 1, n_mels, frames], a ``Conv2d(1, dim, patch,
  stride)`` (16 x 16 patches at stride 10: they overlap), flattened to
  frequency-major tokens (timm's ``flatten(2)``);
- a [CLS] and a [DIST] (DeiT distillation) token prepended, the learned
  position embedding added;
- ``depth`` pre-LayerNorm blocks (LayerNorm eps 1e-6):
  ``x += proj(SDPA(qkv(LN1 x)))`` with ``heads`` heads and a biased qkv,
  then ``x += fc2(GELU(fc1(LN2 x)))`` with the exact (erf) GELU;
- the final LayerNorm, the mean of the two special tokens' outputs, and
  ``mlp_head``: LayerNorm (eps 1e-5) and a dense layer.

The token grid is fixed by the window the model was built for:
((n_mels - patch) // stride + 1) x ((frames - patch) // stride + 1)
patches, one position each; a window of another size is refused.

Compute runs in ``cfg.dtype``: the matrix products' operands (the patch
convolution, the dense layers, attention through
``F.scaled_dot_product_attention``, whose flash or cuDNN backend runs
bfloat16 at head size 64 on an H100) in that dtype with float32
accumulation; the residual stream, the LayerNorms and the softmax's
statistics in float32. Logits come out in float32.

Departures from the paper: the features are the port's mel frontend
(``pipeline/frontend.py``, the model's metadata) in place of Kaldi's fbank,
so ``norm_mean`` and ``norm_std`` belong to that frontend; no dropout or
drop-path at inference; no Kaldi-fbank input layout ([N, frames, n_mels]):
the features come as every classifier of the port takes them.

Spans (``utils/profiling.py``), nested in the caller's ``infer.forward``:
``infer.embed`` (patches, special tokens, positions), ``infer.encoder``
(the blocks; with ``windows`` and ``tokens`` as its args) and
``infer.head``.
"""

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audio_analysis_torch.utils.profiling import span, span_args

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
LN_EPS, HEAD_LN_EPS = 1e-6, 1e-5


@dataclass(frozen=True)
class ASTConfig:
    num_classes: int = 8
    n_mels: int = 160
    frames: int = 769  # 10.24 s at 48 kHz / hop 640 -> 1 + 491520 // 640
    dim: int = 768
    depth: int = 12
    heads: int = 12
    mlp: int = 3072
    patch: int = 16
    stride: int = 10
    norm_mean: float = -4.2677  # AudioSet's, for Kaldi fbank features
    norm_std: float = 4.5690
    dtype: str = "bfloat16"  # compute dtype of the matrix products

    @property
    def grid(self):
        """(frequency patches, time patches) of one window."""
        return ((self.n_mels - self.patch) // self.stride + 1,
                (self.frames - self.patch) // self.stride + 1)

    @property
    def tokens(self):
        fg, tg = self.grid
        return fg * tg + 2


class _Linear(nn.Module):
    """A dense layer whose weight [out, in] and bias are held in the compute
    dtype."""

    def __init__(self, n_in, n_out, dt):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(n_out, n_in, dtype=dt))
        self.bias = nn.Parameter(torch.zeros(n_out, dtype=dt))

    def forward(self, x):
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)


class _Block(nn.Module):
    def __init__(self, cfg: ASTConfig, dt):
        super().__init__()
        d = cfg.dim
        self.heads = cfg.heads
        self.ln1, self.ln2 = nn.LayerNorm(d, eps=LN_EPS), nn.LayerNorm(d, eps=LN_EPS)
        self.qkv, self.proj = _Linear(d, 3 * d, dt), _Linear(d, d, dt)
        self.fc1, self.fc2 = _Linear(d, cfg.mlp, dt), _Linear(cfg.mlp, d, dt)

    def attention(self, h):
        n, t, d = h.shape
        qkv = self.qkv(h).view(n, t, 3, self.heads, d // self.heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v)
        return self.proj(o.transpose(1, 2).reshape(n, t, d))

    def mlp(self, h):
        return self.fc2(F.gelu(self.fc1(h), approximate="none"))

    def forward(self, x):
        x = x + self.attention(self.ln1(x)).float()
        return x + self.mlp(self.ln2(x)).float()


class AST(nn.Module):
    def __init__(self, cfg: ASTConfig):
        super().__init__()
        if cfg.dtype not in _DTYPES:
            raise ValueError(f"AST dtype {cfg.dtype!r} not in {sorted(_DTYPES)}")
        if cfg.dim % cfg.heads:
            raise ValueError(f"AST width {cfg.dim} is not a multiple of {cfg.heads} heads")
        self.cfg = cfg
        dt = _DTYPES[cfg.dtype]
        d = cfg.dim
        self.patch_w = nn.Parameter(torch.zeros(d, 1, cfg.patch, cfg.patch, dtype=dt))
        self.patch_b = nn.Parameter(torch.zeros(d, dtype=dt))
        self.special = nn.Parameter(torch.zeros(2, d))  # [CLS], [DIST]
        self.pos = nn.Parameter(torch.zeros(cfg.tokens, d))
        self.blocks = nn.ModuleList(_Block(cfg, dt) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(d, eps=LN_EPS)
        self.head_ln = nn.LayerNorm(d, eps=HEAD_LN_EPS)
        self.head = nn.Linear(d, cfg.num_classes)

    def _positions(self, fg, tg):
        """The position embedding, for the model's own [fg, tg] patch grid
        only."""
        if (fg, tg) != self.cfg.grid:
            raise ValueError(f"a [{fg}, {tg}] patch grid against the model's {self.cfg.grid}")
        return self.pos

    def forward(self, x):
        """x [N, n_mels, frames, 1] -> logits [N, num_classes] (float32)."""
        cfg = self.cfg
        with span("infer.embed"):
            x = (x[..., 0].float() - cfg.norm_mean) / (2.0 * cfg.norm_std)
            x = F.conv2d(x[:, None].to(self.patch_w.dtype), self.patch_w, self.patch_b,
                         stride=cfg.stride)
            fg, tg = x.shape[2], x.shape[3]
            x = self.tokens(x).float()
            special = self.special.expand(x.shape[0], 2, cfg.dim)
            x = torch.cat([special, x], dim=1) + self._positions(fg, tg)
        with span_args(windows=int(x.shape[0]), tokens=int(x.shape[1])), span("infer.encoder"):
            for blk in self.blocks:
                x = blk(x)
        with span("infer.head"):
            return self.head(self.head_ln(self.pooled(self.norm(x))))

    @staticmethod
    def tokens(x):
        """[N, dim, F', T'] patch embeddings -> [N, F' T', dim] tokens,
        frequency-major (all of one frequency row's times, then the next)."""
        return x.flatten(2).transpose(1, 2)

    @staticmethod
    def pooled(x):
        """The mean of the [CLS] and [DIST] tokens' outputs."""
        return (x[:, 0] + x[:, 1]) * 0.5

    @classmethod
    def from_params(cls, params, cfg: ASTConfig) -> "AST":
        """Build the module, in eval mode, from the parameter tree that
        ``weights.npz`` holds (numpy arrays): ``patch`` {w [patch, patch, 1,
        dim], b}, ``cls``, ``dist`` [dim], ``pos`` [tokens, dim], ``blocks``
        [{ln1, ln2: {gamma, beta}; qkv, proj, fc1, fc2: {w [in, out], b}}],
        ``norm`` {gamma, beta}, ``head`` {ln: {gamma, beta}, w, b}."""
        net = cls(cfg)
        t = lambda a: torch.from_numpy(np.array(a, np.float32))
        ln = lambda p: {"weight": t(p["gamma"]), "bias": t(p["beta"])}
        dense = lambda p: {"weight": t(p["w"]).t().contiguous(), "bias": t(p["b"])}
        state = {"patch_w": t(params["patch"]["w"]).permute(3, 2, 0, 1).contiguous(),
                 "patch_b": t(params["patch"]["b"]),
                 "special": torch.stack([t(params["cls"]), t(params["dist"])]),
                 "pos": t(params["pos"])}
        parts = {"norm": ln(params["norm"]), "head_ln": ln(params["head"]["ln"]),
                 "head": dense(params["head"])}
        if len(params["blocks"]) != cfg.depth:
            raise ValueError(f"{len(params['blocks'])} blocks in the checkpoint, "
                             f"{cfg.depth} in the metadata")
        for i, blk in enumerate(params["blocks"]):
            for name in ("ln1", "ln2"):
                parts[f"blocks.{i}.{name}"] = ln(blk[name])
            for name in ("qkv", "proj", "fc1", "fc2"):
                parts[f"blocks.{i}.{name}"] = dense(blk[name])
        for prefix, p in parts.items():
            state.update({f"{prefix}.{k}": v for k, v in p.items()})
        own = net.state_dict()
        for k, v in state.items():
            if k not in own or own[k].shape != v.shape:
                raise ValueError(f"AST parameter {k}: {tuple(v.shape)} where the metadata "
                                 f"gives {tuple(own[k].shape) if k in own else 'none'}")
            state[k] = v.to(own[k].dtype)
        net.load_state_dict(state, strict=True)
        return net.eval()

