"""EfficientNetB0 in plain PyTorch, from the published architecture (Tan &
Le, arXiv:1905.11946, table 1) as ``keras.applications.EfficientNetB0``
lays it out: a rescaling by 1/255 and a per-channel normalisation, a
stride-2 3x3 stem of 32, seven stages of MBConv blocks with
squeeze-and-excitation (ratio 0.25 of the block's input width), a 1x1 top
convolution to 1280, global average pooling and a dense softmax head.
Stride-2 depthwise convolutions take Keras' ``correct_pad`` zero padding
and VALID convolution; the others SAME. Dropout and drop-connect are
inactive at inference. Weights are keyed by the Keras layer names
(``stem_conv``, ``block2a_dwconv``, ...) in Keras' layouts (HWIO kernels,
(h, w, C, 1) depthwise kernels, [in, out] dense kernels).
"""

import contextlib

import torch
import torch.nn.functional as F

from benchref.dsp import fp8_round

# (repeats, kernel, stride, expand ratio, input width, output width)
STAGES = (
    (1, 3, 1, 1, 32, 16),
    (2, 3, 2, 6, 16, 24),
    (2, 5, 2, 6, 24, 40),
    (3, 3, 2, 6, 40, 80),
    (3, 5, 1, 6, 80, 112),
    (4, 5, 2, 6, 112, 192),
    (1, 3, 1, 6, 192, 320),
)
SE_RATIO = 0.25
STEM, TOP = 32, 1280
BN_EPS = 1e-3


def blocks():
    """(name, kernel, stride, expand, c_in, c_out) of every MBConv block."""
    out = []
    for s, (reps, k, stride, expand, c_in, c_out) in enumerate(STAGES):
        for r in range(reps):
            out.append((f"block{s + 1}{chr(ord('a') + r)}", k, stride if r == 0 else 1, expand,
                        c_in if r == 0 else c_out, c_out))
    return out


def weight_shapes(n_labels):
    """{layer name: [variable shapes]} of every layer that holds weights."""
    bn = lambda c: [(c,)] * 4
    shapes = {"normalization": [(3,), (3,), ()], "stem_conv": [(3, 3, 3, STEM)],
              "stem_bn": bn(STEM)}
    for name, k, _, expand, c_in, c_out in blocks():
        c_exp = c_in * expand
        if expand != 1:
            shapes[f"{name}_expand_conv"] = [(1, 1, c_in, c_exp)]
            shapes[f"{name}_expand_bn"] = bn(c_exp)
        rd = max(1, int(c_in * SE_RATIO))
        shapes[f"{name}_dwconv"] = [(k, k, c_exp, 1)]
        shapes[f"{name}_bn"] = bn(c_exp)
        shapes[f"{name}_se_reduce"] = [(1, 1, c_exp, rd), (rd,)]
        shapes[f"{name}_se_expand"] = [(1, 1, rd, c_exp), (c_exp,)]
        shapes[f"{name}_project_conv"] = [(1, 1, c_exp, c_out)]
        shapes[f"{name}_project_bn"] = bn(c_out)
    shapes["top_conv"] = [(1, 1, STAGES[-1][5], TOP)]
    shapes["top_bn"] = bn(TOP)
    shapes["predictions"] = [(TOP, n_labels), (n_labels,)]
    return shapes


def correct_pad(h, w, k):
    """Keras' correct_pad as F.pad's (left, right, top, bottom)."""
    ah, aw = 1 - h % 2, 1 - w % 2
    c = k // 2
    return (c - aw, c, c - ah, c)


@contextlib.contextmanager
def cnn_precision(mode):
    """TF32 on only for mode "tf32"; restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    on = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class EfficientNetB0:
    """forward(x [N, H, W, 3] float32) -> softmax probabilities [N, labels].
    ``weights``: {layer name: [tensors]} on the input's device. With
    ``calibrate`` (a dict), each BatchNormalization normalises with its own
    input's batch statistics (biased variance over N, H, W) and stores
    them in ``calibrate[name]`` as (moving mean, moving variance)."""

    def __init__(self, weights, mode="float32"):
        self.w = weights
        self.mode = mode

    def _q(self, t):
        return fp8_round(t) if self.mode == "fp8" else t

    def conv(self, x, name, stride=1, pad=None, groups=1, depthwise=False):
        vs = self.w[name]
        k = vs[0].permute(2, 3, 0, 1) if depthwise else vs[0].permute(3, 2, 0, 1)
        if pad is not None:
            x = F.pad(x, pad)
            padding = 0
        else:
            padding = k.shape[-1] // 2
        bias = vs[1] if len(vs) > 1 else None
        return F.conv2d(self._q(x), self._q(k.contiguous()), bias, stride=stride,
                        padding=padding, groups=groups)

    def bn(self, x, name, calibrate):
        gamma, beta, mean, var = self.w[name]
        if calibrate is not None:
            mean, var = x.mean(dim=(0, 2, 3)), x.var(dim=(0, 2, 3), unbiased=False)
            calibrate[name] = (mean, var)
        shape = (1, -1, 1, 1)
        return ((x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + BN_EPS)
                * gamma.reshape(shape) + beta.reshape(shape))

    def block(self, x, name, k, stride, expand, c_in, c_out, calibrate):
        inputs = x
        if expand != 1:
            x = F.silu(self.bn(self.conv(x, f"{name}_expand_conv"), f"{name}_expand_bn",
                               calibrate))
        if stride == 2:
            x = self.conv(x, f"{name}_dwconv", 2, correct_pad(x.shape[2], x.shape[3], k),
                          groups=x.shape[1], depthwise=True)
        else:
            x = self.conv(x, f"{name}_dwconv", groups=x.shape[1], depthwise=True)
        x = F.silu(self.bn(x, f"{name}_bn", calibrate))
        se = x.mean(dim=(2, 3), keepdim=True)
        se = F.silu(self.conv(se, f"{name}_se_reduce"))
        se = torch.sigmoid(self.conv(se, f"{name}_se_expand"))
        x = self.bn(self.conv(x * se, f"{name}_project_conv"), f"{name}_project_bn", calibrate)
        if stride == 1 and c_in == c_out:
            x = x + inputs
        return x

    def __call__(self, x, calibrate=None):
        with cnn_precision(self.mode):
            mean, var = self.w["normalization"][:2]
            x = (x * (1.0 / 255.0) - mean) / torch.clamp(torch.sqrt(var), min=1e-7)
            x = x.permute(0, 3, 1, 2)
            x = self.conv(x, "stem_conv", 2, correct_pad(x.shape[2], x.shape[3], 3))
            x = F.silu(self.bn(x, "stem_bn", calibrate))
            for spec in blocks():
                x = self.block(x, *spec, calibrate)
            x = F.silu(self.bn(self.conv(x, "top_conv"), "top_bn", calibrate))
            x = x.mean(dim=(2, 3))
            kernel, bias = self.w["predictions"]
            return torch.softmax(self._q(x) @ self._q(kernel) + bias, dim=-1)


def macs(h, w, n_labels):
    """Multiply-accumulates of one forward over an [h, w, 3] input, counted
    from the layer shapes: convolutions (SE included) and the dense head."""
    out = lambda size, stride: -(-size // stride)
    h, w = out(h, 2), out(w, 2)
    total = h * w * 3 * 3 * 3 * STEM
    for _, k, stride, expand, c_in, c_out in blocks():
        c_exp = c_in * expand
        if expand != 1:
            total += h * w * c_in * c_exp
        h, w = out(h, stride), out(w, stride)
        rd = max(1, int(c_in * SE_RATIO))
        total += h * w * c_exp * k * k + 2 * c_exp * rd + h * w * c_exp * c_out
    total += h * w * STAGES[-1][5] * TOP + TOP * n_labels
    return total
