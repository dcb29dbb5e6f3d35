"""The Audio Spectrogram Transformer (Gong, Chung and Glass, "AST: Audio
Spectrogram Transformer", Interspeech 2021, arXiv:2104.01778; the layout of
github.com/YuanGongND/ast over timm's DeiT-base) in plain PyTorch, inference
mode, float32 with TF32 off:

- the input normalisation (x - mean) / (2 std) of the log-mel window;
- 16 x 16 patches at stride 10 on both axes (overlapping), taken by an
  explicit unfold and one matrix product, ordered frequency-major (timm's
  ``flatten(2)`` of the [F', T'] grid);
- a [CLS] and a [DIST] token prepended, a learned position embedding added;
- pre-LayerNorm blocks (LayerNorm eps 1e-6): x += proj(attn(qkv(LN1 x))),
  attention written out as softmax(q k^T / sqrt(head dim)) v over every
  token, then x += fc2(GELU(fc1(LN2 x))) with the exact (erf) GELU;
- the final LayerNorm, the mean of the two special tokens' outputs, and the
  head: LayerNorm (eps 1e-5), a dense layer and softmax (the fine-tuned
  single-label form).

The window's patch grid has to be the one the position embedding was drawn
for. Dropout is inactive at inference. Weights are float32 tensors keyed as
``weights.npz`` keys them (dense kernels [in, out], the patch kernel [16, 16, 1, dim]), and
``heads``, ``stride``, ``mean`` and ``std`` are numbers in the same dict.
Windows are computed in blocks of ``BLOCK``, so that the attention matrices
of a recording's windows fit on the card.
"""

import math

import torch
import torch.nn.functional as F

from benchref.dsp import fp8_round
from benchref.effnet import cnn_precision

LN_EPS, HEAD_LN_EPS = 1e-6, 1e-5
BLOCK = 8


def grid(n_mels, frames, patch, stride):
    """(frequency patches, time patches) of an [n_mels, frames] window."""
    return (n_mels - patch) // stride + 1, (frames - patch) // stride + 1


class AST:
    """forward(x [N, n_mels, frames, 1]) -> softmax probabilities [N, labels].
    ``mode``: "float32" (TF32 off), "tf32" or "fp8" (the operands of every
    matrix product rounded to float8_e4m3fn, float32 accumulation).
    ``calibrate`` is accepted for the interface the architectures share;
    nothing here is calibrated from a forward."""

    def __init__(self, w, mode="float32"):
        self.w = w
        self.mode = mode

    def mm(self, a, b):
        if self.mode == "fp8":
            a, b = fp8_round(a), fp8_round(b)
        return a @ b

    def dense(self, x, name):
        return self.mm(x, self.w[name + "/w"]) + self.w[name + "/b"]

    def ln(self, x, name, eps=LN_EPS):
        return F.layer_norm(x, x.shape[-1:], self.w[name + "/gamma"], self.w[name + "/beta"], eps)

    def depth(self):
        i = 0
        while f"blocks/{i}/qkv/w" in self.w:
            i += 1
        return i

    def embed(self, x):
        w = self.w
        kernel = w["patch/w"]
        patch, dim = kernel.shape[0], kernel.shape[-1]
        x = (x[..., 0] - w["mean"]) / (2.0 * w["std"])
        fg, tg = grid(x.shape[1], x.shape[2], patch, w["stride"])
        cols = F.unfold(x[:, None], patch, stride=w["stride"]).transpose(1, 2)
        tokens = self.mm(cols, kernel.reshape(patch * patch, dim)) + w["patch/b"]
        pos = w["pos"]
        if fg * tg + 2 != pos.shape[0]:
            raise ValueError(f"a [{fg}, {tg}] patch grid against {pos.shape[0]} positions")
        special = torch.stack([w["cls"], w["dist"]]).expand(x.shape[0], 2, dim)
        return torch.cat([special, tokens], dim=1) + pos

    def block(self, x, i):
        p = f"blocks/{i}/"
        n, t, dim = x.shape
        heads = self.w["heads"]
        hd = dim // heads
        qkv = self.dense(self.ln(x, p + "ln1"), p + "qkv").reshape(n, t, 3, heads, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        a = torch.softmax(self.mm(q, k.transpose(-1, -2)) / math.sqrt(hd), dim=-1)
        o = self.mm(a, v).transpose(1, 2).reshape(n, t, dim)
        x = x + self.dense(o, p + "proj")
        h = F.gelu(self.dense(self.ln(x, p + "ln2"), p + "fc1"), approximate="none")
        return x + self.dense(h, p + "fc2")

    def forward(self, x):
        x = self.embed(x)
        for i in range(self.depth()):
            x = self.block(x, i)
        x = self.ln(x, "norm")
        x = self.ln((x[:, 0] + x[:, 1]) / 2.0, "head/ln", HEAD_LN_EPS)
        return torch.softmax(self.dense(x, "head"), dim=-1)

    def __call__(self, x, calibrate=None):
        with cnn_precision(self.mode):
            return torch.cat([self.forward(x[i : i + BLOCK]) for i in range(0, len(x), BLOCK)])


def macs(n_mels, frames, dim, depth, heads, mlp, patch, stride, n_labels):
    """Multiply-accumulates of one forward over an [n_mels, frames, 1]
    window, from the layer shapes: the patch product, per block qkv, the
    two attention products (q k^T and a v, over every head), proj and the
    MLP, and the head. ``heads`` splits the attention products without
    changing their count."""
    fg, tg = grid(n_mels, frames, patch, stride)
    t = fg * tg + 2
    block = t * dim * 3 * dim + 2 * t * t * dim + t * dim * dim + 2 * t * dim * mlp
    return fg * tg * patch * patch * dim + depth * block + dim * n_labels
