"""Layer ops with Keras/TF semantics, NHWC at the function boundary
(the JAX package's models/layers.py: conv2d, batch_norm, max_pool2d,
global_avg_pool2d, dense).

Inside, tensors are permuted to NCHW views for PyTorch's operators. TF
"SAME" padding is asymmetric where the total is odd (the extra row or
column goes after): a stride-2, 3x3 conv on 160 rows pads 0 above and 1
below, and a 2x2/2 SAME max-pool on 113 columns pads 1 on the right.
"""

import math

import torch
import torch.nn.functional as F


def same_pads(size: int, k: int, stride: int, dilation: int = 1):
    """(before, after) TF SAME padding of one spatial axis."""
    out = math.ceil(size / stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def _pad_same(x_nchw, kh, kw, stride, dilation=(1, 1), value=0.0):
    pt, pb = same_pads(x_nchw.shape[-2], kh, stride[0], dilation[0])
    pl, pr = same_pads(x_nchw.shape[-1], kw, stride[1], dilation[1])
    if pt or pb or pl or pr:
        x_nchw = F.pad(x_nchw, (pl, pr, pt, pb), value=value)
    return x_nchw


def conv2d(x, weight, bias=None, strides=(1, 1), padding="SAME"):
    """Keras Conv2D: x NHWC, weight OIHW (PyTorch layout)."""
    xc = x.permute(0, 3, 1, 2)
    if padding.upper() == "SAME":
        xc = _pad_same(xc, weight.shape[-2], weight.shape[-1], tuple(strides))
    y = F.conv2d(xc, weight, bias, stride=tuple(strides))
    return y.permute(0, 2, 3, 1)


def batch_norm(x, mean, var, gamma=None, beta=None, eps=1e-3):
    """Inference-mode BatchNormalization over the last axis (Keras eps
    default 1e-3)."""
    y = (x - mean) * torch.rsqrt(var + eps)
    if gamma is not None:
        y = y * gamma
    if beta is not None:
        y = y + beta
    return y


def max_pool2d(x, pool_size=(2, 2), strides=None, padding="VALID"):
    """Keras MaxPooling2D on NHWC; SAME pads with -inf."""
    strides = tuple(strides or pool_size)
    xc = x.permute(0, 3, 1, 2)
    if padding.upper() == "SAME":
        xc = _pad_same(xc, pool_size[0], pool_size[1], strides, value=float("-inf"))
    y = F.max_pool2d(xc, tuple(pool_size), stride=strides)
    return y.permute(0, 2, 3, 1)


def global_avg_pool2d(x):
    return x.mean(dim=(1, 2))


def dense(x, kernel, bias=None):
    """Keras Dense: kernel [in, out]."""
    y = x @ kernel
    if bias is not None:
        y = y + bias
    return y
