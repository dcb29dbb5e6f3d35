"""The port's layer ops (``audio_analysis_torch.models.layers``) against the
JAX package's ``models/layers.py`` on the same seeded inputs: every
activation in both Keras generations, convolutions (strided, dilated,
grouped, depthwise, causal, transposed), batch norm on any axis, pooling
with TF's SAME padding, and the shape and resize ops, at odd sizes. Keras
kernels go through ``torch_kernel`` as the executor converts them at load.

Tolerance: rtol 1e-5, atol 1e-5 (float32 on both sides; convolutions and
resizes sum in another order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_analysis_tpu.models import layers as J

from audio_analysis_torch.models import layers as L

ACTIVATIONS = ["linear", "relu", "relu6", "sigmoid", "tanh", "softmax", "swish", "silu",
               "gelu", "elu", "selu", "softplus", "exponential", "hard_sigmoid",
               "hard_swish", "hard_silu", "leaky_relu", "mish"]


def _x(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _kernel(rng, *shape):
    return (rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _conv2d(rng, strides, padding, dilation, groups):
    x, k, b = _x(rng, 2, 11, 13, 6), _kernel(rng, 3, 2, 6 // groups, 6), _x(rng, 6)
    ref = J.conv2d(x, k, b, strides=strides, padding=padding, dilation=dilation, groups=groups)
    got = L.conv2d(_t(x), L.torch_kernel(k, "conv"), _t(b), strides, padding, dilation, groups)
    return ref, got


def _depthwise2d(rng, strides, padding, dilation):
    x, k, b = _x(rng, 2, 9, 12, 3), _kernel(rng, 3, 3, 3, 2), _x(rng, 6)
    ref = J.depthwise_conv2d(x, k, b, strides=strides, padding=padding, dilation=dilation)
    got = L.depthwise_conv2d(_t(x), L.torch_kernel(k, "depthwise"), _t(b), strides, padding,
                             dilation)
    return ref, got


def _conv1d(rng, strides, padding, dilation, groups):
    x, k, b = _x(rng, 2, 17, 4), _kernel(rng, 3, 4 // groups, 6), _x(rng, 6)
    ref = J.conv1d(x, k, b, strides=strides, padding=padding, dilation=dilation, groups=groups)
    got = L.conv1d(_t(x), L.torch_kernel(k, "conv"), _t(b), strides, padding, dilation, groups)
    return ref, got


def _depthwise1d(rng, strides, padding, dilation):
    x, k = _x(rng, 2, 15, 3), _kernel(rng, 3, 3, 2)
    ref = J.depthwise_conv1d(x, k, None, strides=strides, padding=padding, dilation=dilation)
    got = L.depthwise_conv1d(_t(x), L.torch_kernel(k, "depthwise"), None, strides, padding,
                             dilation)
    return ref, got


def _transpose2d(rng, k, strides, padding, dilation):
    x, w, b = _x(rng, 2, 5, 7, 3), _kernel(rng, k[0], k[1], 4, 3), _x(rng, 4)
    ref = J.conv2d_transpose(x, w, b, strides=strides, padding=padding, dilation=dilation)
    got = L.conv2d_transpose(_t(x), L.torch_kernel(w, "transpose"), _t(b), strides, padding,
                             dilation)
    return ref, got


def _transpose1d(rng, k, strides, padding, dilation):
    x, w, b = _x(rng, 2, 9, 3), _kernel(rng, k, 5, 3), _x(rng, 5)
    ref = J.conv1d_transpose(x, w, b, strides=strides, padding=padding, dilation=dilation)
    got = L.conv1d_transpose(_t(x), L.torch_kernel(w, "transpose"), _t(b), strides, padding,
                             dilation)
    return ref, got


def _batch_norm(rng, axis):
    x = _x(rng, 2, 5, 7, 3)
    c = x.shape[axis]
    mean, var, gamma, beta = _x(rng, c), np.abs(_x(rng, c)) + 0.5, _x(rng, c), _x(rng, c)
    ref = J.batch_norm(x, mean, var, gamma, beta, eps=1e-3, axis=axis)
    got = L.batch_norm(_t(x), _t(mean), _t(var), _t(gamma), _t(beta), eps=1e-3, axis=axis)
    return ref, got


def _pool(rng, op, pool, strides, padding):
    if op.endswith("1d"):
        x = _x(rng, 2, 13, 3)
    else:
        x = _x(rng, 2, 11, 13, 3)
    ref = getattr(J, op)(x, pool, strides, padding)
    return ref, getattr(L, op)(_t(x), pool, strides, padding)


def _resize_with_pad(rng, h, w):
    x = _x(rng, 2, 9, 14, 3)
    return J.resize_with_pad(x, h, w), L.resize_with_pad(_t(x), h, w)


CASES = {
    "conv2d-same-s2": lambda r: _conv2d(r, (2, 2), "same", (1, 1), 1),
    "conv2d-valid-s21": lambda r: _conv2d(r, (2, 1), "valid", (1, 1), 1),
    "conv2d-same-dil2": lambda r: _conv2d(r, (1, 1), "same", (2, 2), 1),
    "conv2d-valid-dil2-groups2": lambda r: _conv2d(r, (1, 1), "valid", (2, 1), 2),
    "conv2d-same-groups3": lambda r: _conv2d(r, (1, 1), "same", (1, 1), 3),
    "depthwise2d-same-s2": lambda r: _depthwise2d(r, (2, 2), "same", (1, 1)),
    "depthwise2d-valid": lambda r: _depthwise2d(r, (1, 1), "valid", (1, 1)),
    "depthwise2d-same-dil2": lambda r: _depthwise2d(r, (1, 1), "same", (2, 2)),
    "conv1d-same-s2": lambda r: _conv1d(r, 2, "same", 1, 1),
    "conv1d-causal-dil2": lambda r: _conv1d(r, 1, "causal", 2, 1),
    "conv1d-valid-groups2": lambda r: _conv1d(r, 1, "valid", 1, 2),
    "depthwise1d-same-s2": lambda r: _depthwise1d(r, 2, "same", 1),
    "depthwise1d-valid-dil2": lambda r: _depthwise1d(r, 1, "valid", 2),
    "transpose2d-same-s2": lambda r: _transpose2d(r, (3, 3), (2, 2), "same", (1, 1)),
    "transpose2d-valid-s21": lambda r: _transpose2d(r, (3, 2), (2, 1), "valid", (1, 1)),
    "transpose2d-valid-s3-k2": lambda r: _transpose2d(r, (2, 2), (3, 3), "valid", (1, 1)),
    "transpose2d-same-s3-k2": lambda r: _transpose2d(r, (2, 2), (3, 3), "same", (1, 1)),
    "transpose2d-same-dil2": lambda r: _transpose2d(r, (3, 3), (1, 1), "same", (2, 2)),
    "transpose1d-same-s2": lambda r: _transpose1d(r, 3, 2, "same", 1),
    "transpose1d-valid-s3-k2": lambda r: _transpose1d(r, 2, 3, "valid", 1),
    "batch_norm-last": lambda r: _batch_norm(r, -1),
    "batch_norm-axis1": lambda r: _batch_norm(r, 1),
    "max_pool2d-same-3s2": lambda r: _pool(r, "max_pool2d", (3, 3), (2, 2), "same"),
    "max_pool2d-valid-2": lambda r: _pool(r, "max_pool2d", (2, 2), None, "valid"),
    "avg_pool2d-same-3s2": lambda r: _pool(r, "avg_pool2d", (3, 3), (2, 2), "same"),
    "avg_pool2d-same-2": lambda r: _pool(r, "avg_pool2d", (2, 2), None, "same"),
    "avg_pool2d-valid-32": lambda r: _pool(r, "avg_pool2d", (3, 2), (1, 2), "valid"),
    "max_pool1d-same-3s2": lambda r: _pool(r, "max_pool1d", 3, 2, "same"),
    "avg_pool1d-same-3s2": lambda r: _pool(r, "avg_pool1d", 3, 2, "same"),
    "avg_pool1d-valid-2": lambda r: _pool(r, "avg_pool1d", 2, None, "valid"),
    "global_avg_pool2d": lambda r: (lambda x: (J.global_avg_pool2d(x, True),
                                               L.global_avg_pool2d(_t(x), True)))(_x(r, 2, 5, 7, 3)),
    "global_max_pool2d": lambda r: (lambda x: (J.global_max_pool2d(x),
                                               L.global_max_pool2d(_t(x))))(_x(r, 2, 5, 7, 3)),
    "zero_padding2d": lambda r: (lambda x: (J.zero_padding2d(x, ((1, 2), (0, 3))),
                                            L.zero_padding2d(_t(x), ((1, 2), (0, 3)))))(
                                                _x(r, 2, 5, 7, 3)),
    "cropping2d": lambda r: (lambda x: (J.cropping2d(x, ((1, 0), (2, 1))),
                                        L.cropping2d(_t(x), ((1, 0), (2, 1)))))(_x(r, 2, 5, 7, 3)),
    "up_sampling2d-nearest": lambda r: (lambda x: (J.up_sampling2d(x, (2, 3)),
                                                   L.up_sampling2d(_t(x), (2, 3))))(
                                                       _x(r, 2, 5, 7, 3)),
    "up_sampling2d-bilinear": lambda r: (lambda x: (J.up_sampling2d(x, (2, 3), "bilinear"),
                                                    L.up_sampling2d(_t(x), (2, 3), "bilinear")))(
                                                        _x(r, 2, 5, 7, 3)),
    "up_sampling2d-bicubic": lambda r: (lambda x: (J.up_sampling2d(x, (3, 2), "bicubic"),
                                                   L.up_sampling2d(_t(x), (3, 2), "bicubic")))(
                                                       _x(r, 2, 5, 7, 3)),
    "up_sampling2d-lanczos3": lambda r: (lambda x: (J.up_sampling2d(x, (2, 2), "lanczos3"),
                                                    L.up_sampling2d(_t(x), (2, 2), "lanczos3")))(
                                                        _x(r, 2, 5, 7, 3)),
    "resize_with_pad-down": lambda r: _resize_with_pad(r, 5, 5),
    "resize_with_pad-up": lambda r: _resize_with_pad(r, 20, 17),
}


@pytest.mark.parametrize("case", list(CASES))
def test_layer_op_matches_jax(case, rng):
    ref, got = CASES[case](rng)
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("keras2", [False, True])
@pytest.mark.parametrize("name", ACTIVATIONS)
def test_activation_matches_jax(name, keras2, rng):
    """Every Keras activation name, with each generation's hard_sigmoid;
    gelu is the exact erf form."""
    x = _x(rng, 4, 33) * 4
    ref = np.asarray(J.activation(name, keras2=keras2)(jnp.asarray(x)))
    got = L.activation(name, keras2=keras2)(_t(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_activation_refuses_unknown_names():
    with pytest.raises(ValueError, match="unsupported activation"):
        L.activation("swishy")
