"""The port's Keras graph executor (``audio_analysis_torch.models.KerasModel``)
against the JAX package's ``KerasModel`` run eagerly, on archives saved by
the installed Keras: every architecture of tests/test_keras_import.py and
tests/test_keras_zoo_ext.py, a seed slice of tools/keras_arch_fuzz.py in
both flavours (also against tf), the Keras-2 conventions, lambdas, and the
full EfficientNetB0 of the committed fixture in float32 and bfloat16.

Tolerances: float32 rtol 1e-4, atol 1e-5 (tests/test_keras_import.py's);
bfloat16 atol 0.03 on a small graph (test_bf16_compute_parity's bound), and
on EfficientNetB0 the bound its test states."""

import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

import jax.numpy as jnp  # noqa: E402
import keras  # noqa: E402
from keras import layers as kl  # noqa: E402

from audio_analysis_tpu.models import KerasModel as JaxKerasModel  # noqa: E402

from audio_analysis_torch.models import KerasModel  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (the EfficientNetB0 fixture)


def _run_both(path, x, compute_dtype=None):
    """(JAX output, port output) as numpy, lists for multi-output graphs."""
    ref = JaxKerasModel.load(str(path), compute_dtype=compute_dtype)
    got = KerasModel.load(path, compute_dtype=compute_dtype)
    multi = isinstance(x, list)
    r = ref([jnp.asarray(a) for a in x] if multi else jnp.asarray(x))
    with torch.inference_mode():
        g = got([torch.from_numpy(a) for a in x] if multi else torch.from_numpy(x))
    if isinstance(r, (list, tuple)):
        return [np.asarray(a) for a in r], [a.numpy() for a in g]
    return np.asarray(r), g.numpy()


def _save(model, tmp_path, keras2=False):
    p = tmp_path / "m.keras"
    if keras2:
        model.save(str(p), save_format="keras")
    else:
        model.save(str(p))
    return p


@functools.cache
def _magtransform(v1=False):
    """The reference's MagTransform layer (v1: scalar `a` init 0; v2: [1],
    init -1), registered once per process."""
    name = "MagTransformV1Port" if v1 else "MagTransformPort"

    @keras.utils.register_keras_serializable(package="PortLayers", name=name)
    class MagTransform(kl.Layer):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.a = self.add_weight(
                initializer=keras.initializers.Constant(value=0.0 if v1 else -1.0),
                name="a-power", dtype="float32", shape=() if v1 else [1], trainable=True,
            )

        def call(self, inputs):
            return tf.math.pow(inputs, tf.math.sigmoid(self.a))

    return MagTransform


# Each function returns (model, input, saved by tf_keras); the architectures
# of tests/test_keras_import.py and tests/test_keras_zoo_ext.py.


def _cacophony_cnn(rng):
    inp = keras.Input((48, 32, 1))
    x = _magtransform()()(inp)
    x = kl.Conv2D(8, 3, strides=2, padding="same", activation="relu")(x)
    x = kl.BatchNormalization()(x)
    x = kl.Conv2D(16, 3, padding="valid")(x)
    x = kl.ReLU(max_value=6.0)(x)
    x = kl.MaxPooling2D()(x)
    x = kl.GlobalAveragePooling2D()(x)
    x = kl.Dropout(0.2)(x)
    out = kl.Dense(5, activation="softmax")(x)
    return keras.Model(inp, out), np.abs(rng.randn(4, 48, 32, 1)).astype(np.float32), False


def _efficientnet_block(rng):
    inp = keras.Input((16, 16, 8))
    x = kl.Rescaling(scale=2.0, offset=0.1)(inp)
    x = kl.ZeroPadding2D(((0, 1), (0, 1)))(x)
    x = kl.DepthwiseConv2D(3, strides=2, padding="valid", use_bias=False)(x)
    x = kl.BatchNormalization()(x)
    x = kl.Activation("swish")(x)
    se = kl.GlobalAveragePooling2D(keepdims=True)(x)
    se = kl.Conv2D(2, 1, activation="swish")(se)
    se = kl.Conv2D(8, 1, activation="sigmoid")(se)
    x = kl.Multiply()([x, se])
    y = kl.Conv2D(8, 1, use_bias=False)(x)
    y = kl.BatchNormalization()(y)
    z = kl.AveragePooling2D(pool_size=2, strides=2, padding="same")(inp)
    out = kl.Add()([y, z])
    out = kl.Flatten()(out)
    out = kl.Dense(3)(out)
    return keras.Model(inp, out), rng.randn(2, 16, 16, 8).astype(np.float32), False


def _separable_concat(rng):
    inp = keras.Input((12, 12, 4))
    a = kl.SeparableConv2D(6, 3, padding="same", activation="relu")(inp)
    b = kl.Conv2D(6, 1)(inp)
    x = kl.Concatenate()([a, b])
    x = kl.GlobalMaxPooling2D()(x)
    out = kl.Dense(2, activation="sigmoid")(x)
    return keras.Model(inp, out), rng.randn(3, 12, 12, 4).astype(np.float32), False


def _sequential(rng):
    model = keras.Sequential([keras.Input((10,)), kl.Dense(16, activation="relu"),
                              kl.Dense(4, activation="softmax")])
    return model, rng.randn(5, 10).astype(np.float32), False


def _names_and_nesting(rng):
    sub_in = keras.Input((8, 8, 2))
    sub = keras.Model(sub_in, kl.Conv2D(4, 1, name="inner_conv")(sub_in), name="subnet")
    inp = keras.Input((8, 8, 2))
    o = kl.Conv2D(2, 1, name="outer_conv")(sub(inp))
    o = kl.Flatten()(o)
    model = keras.Model(inp, kl.Dense(3, name="classifier")(o))
    return model, rng.randn(2, 8, 8, 2).astype(np.float32), False


def _magtransform_v1(rng):
    inp = keras.Input((6, 6, 1))
    out = kl.Flatten()(_magtransform(v1=True)()(inp))
    return keras.Model(inp, out), np.abs(rng.randn(2, 6, 6, 1)).astype(np.float32), False


def _conv1d_family(rng):
    inp = keras.Input((32, 6))
    x = kl.Conv1D(8, 3, strides=2, padding="same", activation="relu")(inp)
    x = kl.Conv1D(8, 3, padding="causal", dilation_rate=2)(x)
    x = kl.DepthwiseConv1D(3, padding="same", depth_multiplier=2)(x)
    x = kl.SeparableConv1D(10, 3, padding="valid", activation="elu")(x)
    x = kl.MaxPooling1D(2, padding="same")(x)
    x = kl.AveragePooling1D(3, strides=2, padding="valid")(x)
    x = kl.ZeroPadding1D((2, 1))(x)
    x = kl.Cropping1D((1, 2))(x)
    x = kl.UpSampling1D(2)(x)
    x = kl.Conv1DTranspose(4, 3, strides=2, padding="same")(x)
    x = kl.GlobalAveragePooling1D()(x)
    return keras.Model(inp, kl.Dense(3)(x)), rng.randn(2, 32, 6).astype(np.float32), False


def _norms_and_minimum(rng):
    inp = keras.Input((8, 8, 4))
    a = kl.PReLU(shared_axes=[1, 2])(kl.Conv2D(6, 3, padding="same")(inp))
    b = kl.ELU(alpha=0.7)(kl.Conv2D(6, 1)(inp))
    x = kl.Minimum()([a, b])
    x = kl.LayerNormalization(axis=[1, 2, 3], epsilon=1e-4)(x)
    x = kl.UnitNormalization()(x)
    x = kl.Flatten()(x)
    return keras.Model(inp, kl.Dense(2)(x)), rng.randn(2, 8, 8, 4).astype(np.float32), False


def _prelu_full_alpha(rng):
    inp = keras.Input((5, 7, 3))
    model = keras.Model(inp, kl.Flatten()(kl.PReLU()(inp)))
    model.layers[1].alpha.assign(rng.randn(5, 7, 3).astype(np.float32))
    return model, rng.randn(2, 5, 7, 3).astype(np.float32), False


def _conv2d_transpose(rng):
    inp = keras.Input((7, 9, 3))
    x = kl.Conv2DTranspose(5, 3, strides=2, padding="same")(inp)
    x = kl.Conv2DTranspose(4, (3, 2), strides=(2, 1), padding="valid", activation="relu")(x)
    x = kl.Conv2DTranspose(3, 2, strides=3, padding="valid")(x)  # stride above the kernel
    model = keras.Model(inp, kl.GlobalAveragePooling2D()(x))
    return model, rng.randn(2, 7, 9, 3).astype(np.float32), False


def _k3_ops_and_getitem(rng):
    inp = keras.Input((16, 4))
    x = inp * 2.0 + 1.0
    x = keras.ops.relu(x)
    x = x[:, 2:12, :]
    x = keras.ops.mean(x, axis=1, keepdims=True)
    x = keras.ops.clip(x, -3.0, 3.0)
    lam = kl.Lambda(lambda t: t * 0.5 + 2.0)(x)
    x = keras.ops.concatenate([x, lam], axis=-1)
    return keras.Model(inp, x), rng.randn(3, 16, 4).astype(np.float32), False


def _op_layers_interleaved(rng):
    inp = keras.Input((6, 6, 2))
    x = kl.Conv2D(4, 3, padding="same", name="c1")(inp)
    x = x * 0.3
    x = kl.Conv2D(4, 3, padding="same", name="c2")(x)
    x = keras.ops.maximum(x, 0.0)
    x = kl.Flatten()(x)
    return keras.Model(inp, kl.Dense(2)(x)), rng.randn(2, 6, 6, 2).astype(np.float32), False


def _embedding(rng):
    inp = keras.Input((10,), dtype="int32")
    x = kl.GlobalAveragePooling1D()(kl.Embedding(20, 8)(inp))
    return keras.Model(inp, kl.Dense(3)(x)), rng.randint(0, 20, (4, 10)).astype(np.int32), False


def _gelu(rng):
    inp = keras.Input((16,))
    model = keras.Model(inp, kl.Dense(16, activation="gelu")(inp))
    return model, rng.randn(4, 16).astype(np.float32) * 2, False


def _pools_pads_upsampling(rng):
    inp = keras.Input((9, 11, 3))
    a = kl.AveragePooling2D(3, strides=2, padding="same")(inp)
    b = kl.MaxPooling2D(3, strides=2, padding="same")(inp)
    x = kl.Average()([a, b])
    x = kl.Cropping2D(((1, 0), (0, 2)))(x)
    x = kl.UpSampling2D((2, 3), interpolation="bilinear")(x)
    x = kl.Conv2D(4, 3, dilation_rate=2, padding="same")(x)
    x = kl.Conv2D(4, 3, groups=2, padding="same")(x)
    x = kl.Maximum()([x, kl.Subtract()([x, x])])
    x = kl.Permute((2, 1, 3))(x)
    x = kl.Reshape((-1, 4))(x)
    x = kl.Softmax(axis=1)(kl.LeakyReLU(negative_slope=0.2)(x))
    return keras.Model(inp, x), rng.randn(2, 9, 11, 3).astype(np.float32), False


def _tfoplambda_keras2(rng):
    import tf_keras as tk

    inp = tk.Input((16, 8))
    x = tk.layers.Conv1D(6, 3, padding="same")(inp)
    x = x * 2.0
    x = tf.nn.relu6(x)
    x = x + tf.math.reduce_mean(x, axis=1, keepdims=True)
    y = tf.clip_by_value(x[:, 2:10, :], -2.0, 5.0)
    y = tf.math.reduce_max(y, axis=1)
    return tk.Model(inp, y), rng.randn(3, 16, 8).astype(np.float32), True


def _keras2_hard_sigmoid(rng):
    import tf_keras as tk

    tk.utils.set_random_seed(3)
    inp = tk.Input((8, 8, 2))
    x = tk.layers.Conv2D(4, 3, padding="same", activation="hard_sigmoid")(inp)
    x = tk.layers.Activation("hard_sigmoid")(x)
    model = tk.Model(inp, tk.layers.GlobalAveragePooling2D()(x))
    return model, rng.randn(3, 8, 8, 2).astype(np.float32) * 3.0, True


def _keras3_hard_swish(rng):
    keras.utils.set_random_seed(3)
    inp = keras.Input((8, 8, 2))
    y = kl.Conv2D(4, 3, padding="same", activation="hard_sigmoid")(inp)
    y = kl.Activation("hard_swish")(y)
    model = keras.Model(inp, kl.GlobalAveragePooling2D()(y))
    return model, rng.randn(3, 8, 8, 2).astype(np.float32) * 3.0, False


def _keras2_nested_offset(rng):
    import tf_keras as tk

    tk.utils.set_random_seed(4)
    inner_in = tk.Input((8, 3))
    inner = tk.Model(inner_in, tk.layers.Conv1D(3, 3, padding="same")(inner_in))
    seq = tk.Sequential([tk.layers.Dense(6), tk.layers.Dense(3)])
    inp = tk.Input((8, 3))
    c = seq(inner(inner(inp)))
    model = tk.Model(inp, tk.layers.GlobalAveragePooling1D()(c))
    return model, rng.randn(2, 8, 3).astype(np.float32), True


def _keras2_scalar_kwarg(rng):
    import tf_keras as tk

    tk.utils.set_random_seed(5)
    inp = tk.Input((6,))
    x = tf.math.pow(tf.math.minimum(tf.math.maximum(inp, 0.1), 0.9), 2.0)
    return tk.Model(inp, x), rng.randn(3, 6).astype(np.float32), True


def _multi_input_output(rng):
    a, b = keras.Input((6,)), keras.Input((6,))
    h = kl.Concatenate()([kl.Dense(4, activation="tanh")(a), b])
    model = keras.Model([a, b], [kl.Dense(2)(h), kl.Dense(3, activation="softplus")(h)])
    return model, [rng.randn(3, 6).astype(np.float32), rng.randn(3, 6).astype(np.float32)], False


ARCHS = {
    "cacophony_cnn": _cacophony_cnn,
    "efficientnet_block": _efficientnet_block,
    "separable_concat": _separable_concat,
    "sequential": _sequential,
    "names_and_nesting": _names_and_nesting,
    "magtransform_v1": _magtransform_v1,
    "conv1d_family": _conv1d_family,
    "norms_and_minimum": _norms_and_minimum,
    "prelu_full_alpha": _prelu_full_alpha,
    "conv2d_transpose": _conv2d_transpose,
    "k3_ops_and_getitem": _k3_ops_and_getitem,
    "op_layers_interleaved": _op_layers_interleaved,
    "embedding": _embedding,
    "gelu": _gelu,
    "pools_pads_upsampling": _pools_pads_upsampling,
    "tfoplambda_keras2": _tfoplambda_keras2,
    "keras2_hard_sigmoid": _keras2_hard_sigmoid,
    "keras3_hard_swish": _keras3_hard_swish,
    "keras2_nested_offset": _keras2_nested_offset,
    "keras2_scalar_kwarg": _keras2_scalar_kwarg,
    "multi_input_output": _multi_input_output,
}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_architecture_matches_jax(arch, tmp_path, rng, monkeypatch):
    monkeypatch.setenv("AAT_UNSAFE_LAMBDA", "1")
    model, x, keras2 = ARCHS[arch](rng)
    p = _save(model, tmp_path, keras2)
    ref, got = _run_both(p, x)
    tf_out = model.predict(x, verbose=0)
    as_list = lambda o: o if isinstance(o, list) else [o]  # noqa: E731
    for r, g, t in zip(as_list(ref), as_list(got), as_list(tf_out)):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(g, np.asarray(t), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("ctor", ["MobileNetV2", "ResNet50", "EfficientNetV2B0"])
def test_application_zoo_matches_jax(ctor, tmp_path, rng):
    """tests/test_keras_import.py's zoo (EfficientNetV2B0's Normalization
    statistics live in the layer config)."""
    tf.keras.utils.set_random_seed(5)
    model = getattr(tf.keras.applications, ctor)(weights=None, input_shape=(96, 96, 3),
                                                  classes=7)
    ref, got = _run_both(_save(model, tmp_path), rng.rand(2, 96, 96, 3).astype(np.float32))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_bf16_compute_parity(tmp_path, rng):
    """tests/test_keras_import.py::test_bf16_compute_parity on the port, and
    the port's bfloat16 against the JAX package's bfloat16 (same bound)."""
    inp = keras.Input((32, 24, 1))
    x = _magtransform()()(inp)
    x = kl.Conv2D(8, 3, strides=2, padding="same")(x)
    x = kl.BatchNormalization()(x)
    x = kl.ReLU()(x)
    x = kl.DepthwiseConv2D(3, padding="same")(x)
    x = kl.BatchNormalization()(x)
    x = kl.GlobalAveragePooling2D()(x)
    model = keras.Model(inp, kl.Dense(5, activation="softmax")(x))
    p = _save(model, tmp_path)
    data = np.abs(rng.randn(8, 32, 24, 1)).astype(np.float32)
    _, f32 = _run_both(p, data)
    ref, bf16 = _run_both(p, data, compute_dtype="bfloat16")
    assert bf16.dtype == np.float32  # cast back at the boundary
    assert (bf16.argmax(-1) == f32.argmax(-1)).all()
    np.testing.assert_allclose(bf16, f32, atol=0.03)
    np.testing.assert_allclose(bf16, ref, atol=0.03)
    km = KerasModel.load(p, compute_dtype="bfloat16")
    # conv kernels are cast once, at load
    assert all(b.dtype == torch.bfloat16 for b in km.buffers() if b.dim() == 4)


@pytest.mark.parametrize("flavor,seed", [(f, s) for f in ("k3", "k2") for s in range(6)])
def test_arch_fuzz_slice_matches_jax(flavor, seed, tmp_path):
    """tools/keras_arch_fuzz.py's seeded random graphs: the port against
    the JAX executor and tf, at the tool's tolerance (2e-4 of the output's
    magnitude)."""
    from tools.keras_arch_fuzz import REL_TOL, _Gen

    gen = _Gen(seed, flavor=flavor)
    gen.keras.utils.set_random_seed(seed)
    model, shape = gen.build()
    x = np.random.RandomState(seed + 1).randn(3, *shape).astype(np.float32)
    ref_tf = np.asarray(model.predict(x, verbose=0))
    ref, got = _run_both(_save(model, tmp_path, keras2=flavor == "k2"), x)
    scale = max(1.0, float(np.max(np.abs(ref))))
    assert float(np.max(np.abs(got - ref))) <= REL_TOL * scale
    if np.all(np.isfinite(ref_tf)):
        assert float(np.max(np.abs(got - ref_tf))) <= REL_TOL * scale


def test_lambda_needs_opt_in(tmp_path, monkeypatch):
    """Marshalled-bytecode Lambdas are refused at the forward without
    AAT_UNSAFE_LAMBDA=1 (as Keras's safe_mode), and run with it."""
    inp = keras.Input((4,))
    p = _save(keras.Model(inp, kl.Lambda(lambda t: t * 2.0 + 1.0)(inp)), tmp_path)
    monkeypatch.delenv("AAT_UNSAFE_LAMBDA", raising=False)
    km = KerasModel.load(p)
    with pytest.raises(ValueError, match="AAT_UNSAFE_LAMBDA"):
        km(torch.zeros(1, 4))
    monkeypatch.setenv("AAT_UNSAFE_LAMBDA", "1")
    torch.testing.assert_close(km(torch.ones(1, 4)), torch.full((1, 4), 3.0))


def test_unsupported_configs_fail_at_the_forward(tmp_path):
    """tests/test_keras_zoo_ext.py's fail-loudly cases: transposed convs
    with output_padding (in the inference and the training forward), an
    unknown TFOpLambda function."""
    import tf_keras as tk

    from audio_analysis_torch.models.keras_graph import _tf_op

    inp = tk.Input((7, 7, 3))
    x = tk.layers.Conv2DTranspose(4, 3, strides=2, padding="valid", output_padding=1)(inp)
    km = KerasModel.load(_save(tk.Model(inp, x), tmp_path, keras2=True))
    with pytest.raises(ValueError, match="output_padding"):
        km(torch.zeros(1, 7, 7, 3))
    with pytest.raises(ValueError, match="unsupported TFOpLambda function"):
        _tf_op("linalg.matmul", "t")
    params = {k: [torch.from_numpy(a) for a in vs] for k, vs in km.params.items()}
    with pytest.raises(ValueError, match="output_padding"):
        km.apply_train(params, torch.zeros(1, 7, 7, 3), torch.Generator())


def test_k3_op_layer_tolerates_unknown_config_key(tmp_path, rng):
    """Config keys an op's signature does not name are dropped."""
    import json
    import zipfile

    inp = keras.Input((8,))
    p = _save(keras.Model(inp, keras.ops.relu(inp * 2.0)), tmp_path)
    with zipfile.ZipFile(p) as z:
        files = {n: z.read(n) for n in z.namelist()}
    cfg = json.loads(files["config.json"])
    for layer in cfg["config"]["layers"]:
        if (layer.get("module") or "").startswith(("keras.src.ops", "keras.ops")):
            layer["config"].update(dtype="float32", future_knob=7)
    files["config.json"] = json.dumps(cfg).encode()
    p2 = tmp_path / "tampered.keras"
    with zipfile.ZipFile(p2, "w") as z:
        for n, data in files.items():
            z.writestr(n, data)
    x = rng.randn(2, 8).astype(np.float32)
    ref, got = _run_both(p2, x)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_walk_layers_matches_jax(tmp_path, rng):
    model, _, _ = _names_and_nesting(rng)
    p = _save(model, tmp_path)
    want = [(k, c) for k, c, _ in JaxKerasModel.load(str(p)).walk_layers()]
    assert [(k, c) for k, c, _ in KerasModel.load(p).walk_layers()] == want
    assert ("functional/layers/conv2d", "Conv2D") in want  # the h5 key, not "subnet"


@pytest.fixture(scope="module")
def efficientnet(tmp_path_factory):
    """The seeded full-width EfficientNetB0, two windows of real mel
    features (the 4th and 5th of a calibration recording) and the JAX
    package's float32 probabilities on them."""
    d = chip_smoke.efficientnet_fixture(tmp_path_factory.mktemp("effb0") / "m", seed=0)
    path, x = d / "audioModel.keras", chip_smoke.calibration_grid(1)[3:5].numpy()
    return path, x, np.asarray(JaxKerasModel.load(str(path))(jnp.asarray(x)))


def test_efficientnet_b0_float32_matches_jax(efficientnet):
    """bench.py's flagship at [2, 160, 226, 3], float32: rtol 1e-4, atol
    1e-5 (about 22 s on one CPU worker with the module fixture, most of it
    the JAX package's eager forward)."""
    path, x, ref = efficientnet
    with torch.inference_mode():
        got = KerasModel.load(path)(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 8)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_efficientnet_b0_bfloat16_matches_jax(efficientnet):
    """bfloat16 (about 28 s): the port and the JAX package each within max
    0.15 and mean 0.02 of the JAX float32 probabilities, and of each other.
    Not the small graph's 0.03: through 16 blocks bfloat16 moves this
    network's probabilities by up to 0.112 (mean 0.0063) in the JAX
    package's own bfloat16 mode, on 30 windows of the fixture."""
    path, x, f32 = efficientnet
    ref, got = _run_both(path, x, compute_dtype="bfloat16")
    for a, b in ((ref, f32), (got, f32), (got, ref)):
        assert np.abs(a - b).max() <= 0.15 and np.abs(a - b).mean() <= 0.02
