"""Layer ops with Keras/TF semantics, NHWC (NWC for 1-D) at the function
boundary (the JAX package's models/layers.py).

Inside, tensors are permuted to NCHW views for PyTorch's operators (a
permuted NHWC tensor is channels-last memory, which cuDNN takes without a
copy). Weights come in PyTorch's layouts; ``torch_kernel`` converts a Keras
kernel once, at load. TF "SAME" padding is asymmetric where the total is
odd (the extra row or column goes after): a stride-2, 3x3 conv on 160 rows
pads 0 above and 1 below, and a 2x2/2 SAME max-pool on 113 columns pads 1
on the right. Symmetric padding is left to the operator; asymmetric padding
is applied first.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# activations (Keras names)
# ---------------------------------------------------------------------------


def _hard_sigmoid_k2(x):
    # Keras 2 (tf_keras) semantics: clip(0.2x + 0.5, 0, 1). Keras 3 changed
    # the definition to relu6(x + 3)/6 — archives must be executed with the
    # semantics of the Keras that SAVED them.
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def activation(name, keras2=False):
    """Resolve a Keras activation string. ``keras2`` selects Keras-2
    semantics where the two generations disagree (hard_sigmoid, and
    everything derived from it)."""
    if name is None or name == "linear":
        return lambda x: x
    hard_sig = _hard_sigmoid_k2 if keras2 else F.hardsigmoid
    table = {
        "relu": torch.relu,
        "relu6": lambda x: torch.clamp(x, 0, 6),
        "sigmoid": torch.sigmoid,
        "tanh": torch.tanh,
        "softmax": lambda x: torch.softmax(x, dim=-1),
        "swish": F.silu,
        "silu": F.silu,
        # keras.activations.gelu is the exact erf form in both generations
        "gelu": lambda x: F.gelu(x, approximate="none"),
        "elu": F.elu,
        "selu": torch.selu,
        "softplus": F.softplus,
        "exponential": torch.exp,
        "hard_sigmoid": hard_sig,
        "hard_swish": lambda x: x * hard_sig(x),
        "hard_silu": lambda x: x * hard_sig(x),
        "leaky_relu": lambda x: F.leaky_relu(x, 0.3),  # Keras alpha default
        "mish": lambda x: x * torch.tanh(F.softplus(x)),
    }
    if name not in table:
        raise ValueError(f"unsupported activation {name!r}")
    return table[name]


# ---------------------------------------------------------------------------
# padding
# ---------------------------------------------------------------------------


def same_pads(size: int, k: int, stride: int, dilation: int = 1):
    """(before, after) TF SAME padding of one spatial axis."""
    out = math.ceil(size / stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def _pad(xc, ksize, strides, dilation, padding, value=0.0, limit=None):
    """Channels-first `xc` (an NCHW or NCW view) padded for a window op:
    returns (input, the symmetric padding left to the operator). Asymmetric
    SAME padding (or symmetric padding above `limit`, a pool's k // 2) is
    applied here; F.pad keeps the view's memory format (channels-last stays
    channels-last)."""
    n = len(ksize)
    if padding.upper() != "SAME":
        return xc, (0,) * n
    pads = [same_pads(xc.shape[2 + i], ksize[i], strides[i], dilation[i]) for i in range(n)]
    if all(a == b and (limit is None or a <= limit[i]) for i, (a, b) in enumerate(pads)):
        return xc, tuple(a for a, _ in pads)
    flat = [p for a, b in reversed(pads) for p in (a, b)]
    return F.pad(xc, flat, value=value), (0,) * n


# ---------------------------------------------------------------------------
# kernel layouts (converted once, at load)
# ---------------------------------------------------------------------------


def torch_kernel(kernel, kind):
    """A Keras kernel (numpy or tensor) in PyTorch's layout:

    - ``conv``: HWIO / WIO -> OIHW / OIW;
    - ``depthwise``: (h, w, C, mult) / (w, C, mult) -> (C*mult, 1, h, w) /
      (C*mult, 1, w), output channel c*mult + m;
    - ``transpose``: (h, w, out, in) / (w, out, in) -> (in, out, h, w) /
      (in, out, w);
    - ``dense``: [in, out] -> [out, in]."""
    k = torch.as_tensor(np.asarray(kernel)) if not isinstance(kernel, torch.Tensor) else kernel
    nd = k.ndim - 2
    spatial = tuple(range(nd))
    if kind == "conv":
        k = k.permute(nd + 1, nd, *spatial)
    elif kind == "depthwise":
        c, mult = k.shape[-2], k.shape[-1]
        k = k.permute(nd, nd + 1, *spatial).reshape(c * mult, 1, *k.shape[:nd])
    elif kind == "transpose":
        k = k.permute(nd + 1, nd, *spatial)
    elif kind == "dense":
        k = k.t()
    else:
        raise ValueError(f"unknown kernel kind {kind!r}")
    return k.contiguous()


# ---------------------------------------------------------------------------
# conv / dense
# ---------------------------------------------------------------------------


def conv2d(x, weight, bias=None, strides=(1, 1), padding="SAME", dilation=(1, 1), groups=1):
    """Keras Conv2D: x NHWC, weight OIHW."""
    xc, pad = _pad(x.permute(0, 3, 1, 2), weight.shape[-2:], tuple(strides), tuple(dilation),
                   padding)
    y = F.conv2d(xc, weight, bias, stride=tuple(strides), padding=pad,
                 dilation=tuple(dilation), groups=groups)
    return y.permute(0, 2, 3, 1)


def depthwise_conv2d(x, weight, bias=None, strides=(1, 1), padding="SAME", dilation=(1, 1)):
    """Keras DepthwiseConv2D: weight (C*mult, 1, h, w) -> grouped conv."""
    return conv2d(x, weight, bias, strides, padding, dilation, groups=x.shape[-1])


def conv1d(x, weight, bias=None, strides=1, padding="SAME", dilation=1, groups=1):
    """Keras Conv1D: x NWC, weight OIW. ``padding='causal'`` left-pads by
    dilation*(k-1) (TF semantics) then runs VALID."""
    xc = x.permute(0, 2, 1)
    if padding.lower() == "causal":
        xc = F.pad(xc, (int(dilation) * (weight.shape[-1] - 1), 0))
        padding = "VALID"
    xc, pad = _pad(xc, weight.shape[-1:], (int(strides),), (int(dilation),), padding)
    y = F.conv1d(xc, weight, bias, stride=int(strides), padding=pad, dilation=int(dilation),
                 groups=groups)
    return y.permute(0, 2, 1)


def depthwise_conv1d(x, weight, bias=None, strides=1, padding="SAME", dilation=1):
    """Keras DepthwiseConv1D: weight (C*mult, 1, w) -> grouped conv."""
    return conv1d(x, weight, bias, strides, padding, dilation, groups=x.shape[-1])


def _transpose_pads(k, s, padding):
    """(before, after) padding of the stride-dilated input of a transposed
    conv (lax.conv_transpose's rule; `k` is the dilated kernel size)."""
    if padding.upper() == "SAME":
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else int(math.ceil(pad_len / 2))
    else:
        pad_len = k + s - 2 + max(k - s, 0)
        pad_a = k - 1
    return pad_a, pad_len - pad_a


def _conv_transpose(xc, weight, bias, strides, padding, dilation):
    """The full transposed conv, cropped or extended to lax.conv_transpose's
    padding (the full output pads the dilated input by k-1 on each side)."""
    nd = weight.ndim - 2
    adjust = []  # F.pad order: last spatial axis first; negative crops
    for i in reversed(range(nd)):
        k = (weight.shape[2 + i] - 1) * dilation[i] + 1
        a, b = _transpose_pads(k, strides[i], padding)
        adjust += [a - (k - 1), b - (k - 1)]
    # rows past the full output (stride above the kernel, VALID) see no
    # input: they hold the bias alone, so it is added after the padding
    late_bias = bias is not None and max(adjust) > 0
    op = F.conv_transpose2d if nd == 2 else F.conv_transpose1d
    y = op(xc, weight, None if late_bias else bias, stride=strides, dilation=dilation)
    if any(adjust):
        y = F.pad(y, adjust)
    if late_bias:
        y = y + bias.reshape((1, -1) + (1,) * nd)
    return y


def conv2d_transpose(x, weight, bias=None, strides=(2, 2), padding="SAME", dilation=(1, 1)):
    """Keras Conv2DTranspose: weight (in, out, h, w) (``torch_kernel``'s
    ``transpose`` of TF's (h, w, out, in)); the TF gradient-of-conv
    semantics that lax.conv_transpose(transpose_kernel=True) computes."""
    y = _conv_transpose(x.permute(0, 3, 1, 2), weight, bias, tuple(strides), padding,
                        tuple(dilation))
    return y.permute(0, 2, 3, 1)


def conv1d_transpose(x, weight, bias=None, strides=2, padding="SAME", dilation=1):
    """Keras Conv1DTranspose: weight (in, out, w)."""
    y = _conv_transpose(x.permute(0, 2, 1), weight, bias, (int(strides),), padding,
                        (int(dilation),))
    return y.permute(0, 2, 1)


def dense(x, kernel, bias=None):
    """Keras Dense: kernel [in, out]."""
    y = x @ kernel
    if bias is not None:
        y = y + bias
    return y


def batch_norm(x, mean, var, gamma=None, beta=None, eps=1e-3, axis=-1):
    """Inference-mode BatchNormalization over `axis` (Keras eps default
    1e-3)."""
    shape = [1] * x.ndim
    shape[axis] = x.shape[axis]
    y = (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + eps)
    if gamma is not None:
        y = y * gamma.reshape(shape)
    if beta is not None:
        y = y + beta.reshape(shape)
    return y


def batch_moments(x, dims, group=None):
    """Training BatchNorm's statistics: the mean and the centred biased
    variance of `x` over `dims` (two passes, as jnp.var takes them). With a
    process `group`, whose ranks hold equal parts of one batch, they are
    the whole batch's: each pass's sums are all-reduced over the group, and
    gradients flow through the reduction to every rank's rows."""
    shape = [1 if d in dims else s for d, s in enumerate(x.shape)]
    if group is None:
        mean = x.mean(dims)
        return mean, torch.square(x - mean.reshape(shape)).mean(dims)
    import torch.distributed as dist
    from torch.distributed.nn.functional import all_reduce

    count = math.prod(x.shape[d] for d in dims) * dist.get_world_size(group)
    mean = all_reduce(x.sum(dims), group=group) / count
    return mean, all_reduce(torch.square(x - mean.reshape(shape)).sum(dims), group=group) / count


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------


def max_pool2d(x, pool_size=(2, 2), strides=None, padding="VALID"):
    """Keras MaxPooling2D on NHWC; SAME pads with -inf."""
    pool_size = tuple(pool_size)
    strides = tuple(strides or pool_size)
    xc, pad = _pad(x.permute(0, 3, 1, 2), pool_size, strides, (1, 1), padding,
                   value=float("-inf"), limit=[k // 2 for k in pool_size])
    y = F.max_pool2d(xc, pool_size, stride=strides, padding=pad)
    return y.permute(0, 2, 3, 1)


def avg_pool2d(x, pool_size=(2, 2), strides=None, padding="VALID"):
    """TF semantics: SAME padding excludes padded cells from the mean."""
    pool_size = tuple(pool_size)
    strides = tuple(strides or pool_size)
    xc = x.permute(0, 3, 1, 2)
    if padding.upper() != "SAME":
        return F.avg_pool2d(xc, pool_size, stride=strides).permute(0, 2, 3, 1)
    xp, _ = _pad(xc, pool_size, strides, (1, 1), "SAME", limit=[-1, -1])
    ones, _ = _pad(torch.ones((1, 1) + tuple(xc.shape[2:]), dtype=x.dtype, device=x.device),
                   pool_size, strides, (1, 1), "SAME", limit=[-1, -1])
    s = F.avg_pool2d(xp, pool_size, stride=strides, divisor_override=1)
    counts = F.avg_pool2d(ones, pool_size, stride=strides, divisor_override=1)
    return (s / counts).permute(0, 2, 3, 1)


def max_pool1d(x, pool_size=2, strides=None, padding="VALID"):
    strides = int(strides or pool_size)
    return max_pool2d(x[:, None], (1, int(pool_size)), (1, strides), padding)[:, 0]


def avg_pool1d(x, pool_size=2, strides=None, padding="VALID"):
    """TF semantics: SAME padding excludes padded cells from the mean."""
    strides = int(strides or pool_size)
    return avg_pool2d(x[:, None], (1, int(pool_size)), (1, strides), padding)[:, 0]


def global_avg_pool2d(x, keepdims=False):
    return x.mean(dim=(1, 2), keepdim=keepdims)


def global_max_pool2d(x, keepdims=False):
    return x.amax(dim=(1, 2), keepdim=keepdims)


# ---------------------------------------------------------------------------
# shape ops
# ---------------------------------------------------------------------------


def zero_padding2d(x, padding=((1, 1), (1, 1))):
    (pt, pb), (pl, pr) = padding
    return F.pad(x, (0, 0, pl, pr, pt, pb))


def cropping2d(x, cropping=((0, 0), (0, 0))):
    (ct, cb), (cl, cr) = cropping
    h, w = x.shape[1], x.shape[2]
    return x[:, ct : h - cb or None, cl : w - cr or None, :]


_RESIZE_KERNELS = {
    "linear": lambda x: np.maximum(0, 1 - np.abs(x)),
    "cubic": lambda x: np.where(
        x >= 2.0, 0.0,
        np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, ((1.5 * x - 2.5) * x) * x + 1.0)),
    "lanczos3": lambda x: _lanczos(3.0, x),
    "lanczos5": lambda x: _lanczos(5.0, x),
}
_RESIZE_NAMES = {"linear": "linear", "bilinear": "linear", "trilinear": "linear",
                 "triangle": "linear", "cubic": "cubic", "bicubic": "cubic",
                 "tricubic": "cubic", "lanczos3": "lanczos3", "lanczos5": "lanczos5"}


def _lanczos(radius, x):
    y = radius * np.sin(np.pi * x) * np.sin(np.pi * x / radius)
    out = np.where(x > 1e-3, y / np.where(x != 0, np.pi ** 2 * x ** 2, 1), 1)
    return np.where(x > radius, 0.0, out)


def resize_weights(in_size, out_size, method, antialias=True):
    """[in, out] float32 interpolation weights of one axis, as
    jax.image.resize computes them (half-pixel centres, weights normalised
    over the input's extent, the kernel widened when downsampling)."""
    if method not in _RESIZE_NAMES:
        raise ValueError(f"unsupported resize method {method!r}")
    kernel = _RESIZE_KERNELS[_RESIZE_NAMES[method]]
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0)) if antialias else f32(1.0)
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    w = kernel(np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale)
    w = w.astype(f32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).astype(f32)


def resize(x, height, width, method):
    """jax.image.resize of NHWC `x` to [height, width] (antialiased), in
    float32 (integers promote, as there)."""
    x = x if x.is_floating_point() else x.float()
    for axis, size in ((1, height), (2, width)):
        if x.shape[axis] != size:
            w = torch.from_numpy(resize_weights(x.shape[axis], size, method)).to(x.device, x.dtype)
            x = torch.movedim(torch.tensordot(torch.movedim(x, axis, -1), w, dims=1), -1, axis)
    return x


def up_sampling2d(x, size=(2, 2), interpolation="nearest"):
    _, h, w, _ = x.shape
    if interpolation == "nearest":
        return x.repeat_interleave(size[0], dim=1).repeat_interleave(size[1], dim=2)
    return resize(x, h * size[0], w * size[1], interpolation)


def resize_with_pad(x, target_h, target_w):
    """tf.image.resize_with_pad semantics (used by the reference's MFCC
    concat, src/identify_tracks.py:279): scale preserving aspect ratio then
    centre-pad with zeros."""
    h, w = x.shape[-3], x.shape[-2]
    scale = min(target_h / h, target_w / w)
    new_h = max(1, int(h * scale))
    new_w = max(1, int(w * scale))
    lead = x.shape[:-3]
    y = resize(x.reshape((-1,) + tuple(x.shape[-3:])), new_h, new_w, "bilinear")
    y = y.reshape(tuple(lead) + tuple(y.shape[1:]))
    pad_top = (target_h - new_h) // 2
    pad_left = (target_w - new_w) // 2
    return F.pad(y, (0, 0, pad_left, target_w - new_w - pad_left,
                     pad_top, target_h - new_h - pad_top))
