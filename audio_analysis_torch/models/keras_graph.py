"""Execute imported Keras functional graphs as an ``nn.Module`` (the JAX
package's models/keras_graph.py).

``KerasModel.load(path)`` parses a ``.keras`` archive (io.keras_import) and
builds the graph once: the execution order (the JAX executor's per-node
readiness walk, run at construction), each node's argument references as
slots of a value list, and each layer as a callable over weights that were
converted to PyTorch's layouts (and to the compute dtype) at load, held as
buffers. ``forward`` is then a plain walk over that list. Tensors stay NHWC
between layers, as in Keras: Flatten, Reshape, Permute, Concatenate and
BatchNormalization's axis depend on it.

``apply_train(params, x, generator)`` is the training forward over the
Keras-layout leaves ``params`` ({weight key: [tensors]}, ``KerasModel.params``
as read): each weight getter then builds its layer's weight from the live
leaves with the same layout change and cast as at load, BatchNormalization
normalises with the batch's statistics and returns them, and Dropout,
SpatialDropout2D, GaussianNoise and GaussianDropout draw their masks from
``generator``. The inference forward is unchanged by it.

Covered layer set: everything the Cacophony classifier family and
keras.applications EfficientNet need (Conv/DepthwiseConv/SeparableConv,
BatchNorm, Dense, poolings, activations, merges, shape ops, Rescaling,
Normalization, Dropout, MagTransform v1/v2), 1-D and transposed convs,
LayerNormalization, Embedding, Keras-3 op-layers, Keras-2 TFOpLambda /
SlicingOpLambda, and Lambda behind ``AAT_UNSAFE_LAMBDA``.
"""

import base64
import functools
import inspect
import marshal
import math
import operator
import os
import re
import types

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audio_analysis_torch.io.keras_import import read_keras_archive
from audio_analysis_torch.models import layers as L
from audio_analysis_torch.models.magtransform import mag_transform


def _to_snake_case(name: str) -> str:
    """Keras's to_snake_case (keras/src/utils/naming.py semantics)."""
    name = re.sub(r"\W+", "", name)
    name = re.sub(r"(.)([A-Z][a-z]+)", r"\1_\2", name)
    name = re.sub(r"([a-z])([A-Z])", r"\1_\2", name).lower()
    return name


def _layer_name(layer: dict) -> str:
    # Functional configs carry a top-level "name"; Sequential ones only have
    # it inside config.
    return layer.get("name") or layer["config"].get("name")


def _pair(v):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v), int(v))


def _one(v):
    if isinstance(v, (list, tuple)):
        return int(v[0])
    return int(v)


def _norm_pad2d(p):
    """Keras ZeroPadding2D/Cropping2D padding normalisation."""
    if isinstance(p, int):
        return ((p, p), (p, p))
    a, b = p
    if isinstance(a, int):
        return ((a, a), (b, b))
    return (tuple(a), tuple(b))


# ---------------------------------------------------------------------------
# TFOpLambda / Lambda support
# ---------------------------------------------------------------------------


def _reduce(op):
    def fn(x, axis=None, keepdims=False, **kw):
        if isinstance(axis, list):
            axis = tuple(axis)
        if axis == ():
            return x
        dims = tuple(range(x.ndim)) if axis is None else axis
        return op(x, dim=dims, keepdim=keepdims)

    return fn


def _binary(op):
    """A torch binary op that, like jnp's, takes a Python scalar on either
    side (promoted as a weak type)."""

    def fn(x, y):
        like = x if isinstance(x, torch.Tensor) else y
        dt = torch.result_type(x, y)
        x = torch.as_tensor(x, device=like.device).to(dt)
        y = torch.as_tensor(y, device=like.device).to(dt)
        return op(x, y)

    return fn


_maximum, _minimum = _binary(torch.maximum), _binary(torch.minimum)


def _dtype(name):
    return getattr(torch, str(name))


def _split(value, num_or_size_splits, axis=0):
    if isinstance(num_or_size_splits, int):
        return list(torch.tensor_split(value, num_or_size_splits, dim=axis))
    return list(torch.split(value, list(num_or_size_splits), dim=axis))


def _squeeze(x, axis):
    if axis is None:
        return torch.squeeze(x)
    return torch.squeeze(x, tuple(axis) if isinstance(axis, list) else axis)


def _transpose(x, perm):
    return x.permute(tuple(perm) if perm is not None else tuple(reversed(range(x.ndim))))


# tf.* function paths as serialized by Keras-2 TFOpLambda configs
# (tf_keras emits these for raw-TF-op calls inside functional models, e.g.
# the hard-swish blocks of keras.applications MobileNetV3). Each entry maps
# the dotted path in config["function"] to a torch implementation with the
# same call signature.
_TF_OPS = {
    "__operators__.add": lambda x, y: x + y,
    "math.add": lambda x, y: x + y,
    "math.subtract": lambda x, y: x - y,
    "math.multiply": lambda x, y: x * y,
    "math.truediv": lambda x, y: x / y,
    "math.divide": lambda x, y: x / y,
    # parameter names mirror the tf.* API: a scalar second operand
    # serializes into node kwargs under the TF argument name (e.g.
    # tf.math.maximum(x, 0.1) -> kwargs {"y": 0.1})
    "math.pow": lambda x, y: torch.pow(x, y),
    "math.abs": lambda x: torch.abs(x),
    "math.exp": lambda x: torch.exp(x),
    "math.log": lambda x: torch.log(x),
    "math.sqrt": lambda x: torch.sqrt(x),
    "math.rsqrt": lambda x: torch.rsqrt(x),
    "math.square": lambda x: torch.square(x),
    "math.sigmoid": lambda x: torch.sigmoid(x),
    "math.tanh": lambda x: torch.tanh(x),
    "math.maximum": lambda x, y: _maximum(x, y),
    "math.minimum": lambda x, y: _minimum(x, y),
    "math.reduce_mean": _reduce(torch.mean),
    "math.reduce_max": _reduce(torch.amax),
    "math.reduce_min": _reduce(torch.amin),
    "math.reduce_sum": _reduce(torch.sum),
    "nn.relu": lambda features: torch.relu(features),
    "nn.relu6": lambda features: torch.clamp(features, 0, 6),
    "nn.silu": lambda features, beta=1.0: features * torch.sigmoid(beta * features),
    "nn.swish": lambda features: F.silu(features),
    "nn.gelu": lambda features, approximate=False: F.gelu(
        features, approximate="tanh" if approximate else "none"
    ),
    "nn.elu": lambda features: F.elu(features),
    "nn.softmax": lambda logits, axis=-1: torch.softmax(logits, dim=axis),
    "nn.sigmoid": lambda x: torch.sigmoid(x),
    "nn.tanh": lambda x: torch.tanh(x),
    "clip_by_value": lambda t, clip_value_min, clip_value_max: torch.clamp(
        t, clip_value_min, clip_value_max
    ),
    "reshape": lambda tensor, shape: torch.reshape(tensor, [int(s) for s in shape]),
    "transpose": lambda a, perm=None, conjugate=False: _transpose(a, perm),
    "concat": lambda values, axis: torch.cat(values, dim=axis),
    "expand_dims": lambda input, axis: torch.unsqueeze(input, axis),
    "squeeze": lambda input, axis=None: _squeeze(input, axis),
    "stack": lambda values, axis=0: torch.stack(values, dim=axis),
    "split": lambda value, num_or_size_splits, axis=0: _split(value, num_or_size_splits, axis),
    "identity": lambda input: input,
    "stop_gradient": lambda input: input.detach(),
    "cast": lambda x, dtype: x.to(_dtype(dtype)),
    "compat.v1.squeeze": lambda input, axis=None, squeeze_dims=None: _squeeze(
        input, axis if axis is not None else squeeze_dims
    ),
}


# Keras-3 op-layers: raw keras.ops/operator use on KerasTensors serializes
# as layers from module "keras.src.ops.*" whose constructor args (axis,
# keepdims, x_min, ...) live in the layer CONFIG (the node only carries the
# tensors). Class names here may shadow keras.layers merge classes (Add,
# Multiply, Concatenate) — dispatch keys on the module prefix first. Every
# entry is a Python function, so its signature can filter config keys.
_K3_OPS = {
    "Add": lambda x, y: x + y,
    "Subtract": lambda x, y: x - y,
    "Multiply": lambda x, y: x * y,
    "TrueDivide": lambda x, y: x / y,
    "Divide": lambda x, y: x / y,
    "FloorDivide": lambda x, y: torch.floor_divide(x, y),
    "Power": lambda x, y: torch.pow(x, y),
    "Absolute": lambda x: torch.abs(x),
    "Abs": lambda x: torch.abs(x),
    "Negative": lambda x: torch.neg(x),
    "Exp": lambda x: torch.exp(x),
    "Log": lambda x: torch.log(x),
    "Sqrt": lambda x: torch.sqrt(x),
    "Square": lambda x: torch.square(x),
    "Tanh": lambda x: torch.tanh(x),
    "Maximum": lambda x, y: _maximum(x, y),
    "Minimum": lambda x, y: _minimum(x, y),
    "Mean": _reduce(torch.mean),
    "Max": _reduce(torch.amax),
    "Min": _reduce(torch.amin),
    "Sum": _reduce(torch.sum),
    "Reshape": lambda x, newshape: torch.reshape(x, tuple(int(s) for s in newshape)),
    "Transpose": lambda x, axes=None: _transpose(x, axes),
    "ExpandDims": lambda x, axis: torch.unsqueeze(x, axis),
    "Squeeze": lambda x, axis=None: _squeeze(x, axis),
    "Clip": lambda x, x_min, x_max: torch.clamp(x, x_min, x_max),
    "GetItem": lambda x, key: x[tuple(key) if isinstance(key, list) else key],
    "Stack": lambda xs, axis=0: torch.stack(xs, dim=axis),
    "Concatenate": lambda xs, axis=0: torch.cat(xs, dim=axis),
    "Relu": lambda x: torch.relu(x),
    "Relu6": lambda x: torch.clamp(x, 0, 6),
    "Silu": lambda x: F.silu(x),
    "Gelu": lambda x, approximate=True: F.gelu(x, approximate="tanh" if approximate else "none"),
    "Sigmoid": lambda x: torch.sigmoid(x),
    "Softmax": lambda x, axis=-1: torch.softmax(x, dim=axis),
    "LogSoftmax": lambda x, axis=-1: torch.log_softmax(x, dim=axis),
    "Elu": lambda x, alpha=1.0: F.elu(x, alpha),
    "Selu": lambda x: torch.selu(x),
    "Softplus": lambda x: F.softplus(x),
    "Softsign": lambda x: F.softsign(x),
    "HardSigmoid": lambda x: F.hardsigmoid(x),
    "HardSilu": lambda x: x * F.hardsigmoid(x),
    "LeakyRelu": lambda x, negative_slope=0.2: F.leaky_relu(x, negative_slope),
    "Rsqrt": lambda x: torch.rsqrt(x),
    "Erf": lambda x: torch.erf(x),
}


def _tf_op(fname, name):
    fn = _TF_OPS.get(fname)
    if fn is None:
        raise ValueError(
            f"unsupported TFOpLambda function {fname!r} ({name}); supported: "
            + ", ".join(sorted(_TF_OPS))
        )
    return fn


def _getitem_slice_spec(x, slice_spec):
    """SlicingOpLambda (`tensor[...]` in a Keras-2 functional model):
    slice_spec is a list of {"start","stop","step"} dicts and/or bare ints."""
    idx = []
    for s in slice_spec:
        if isinstance(s, dict):
            idx.append(slice(s.get("start"), s.get("stop"), s.get("step")))
        elif s is None:
            idx.append(None)
        elif s is Ellipsis or s == "ellipsis":
            idx.append(Ellipsis)
        else:
            idx.append(int(s))
    return x[tuple(idx)]


def _load_lambda(cfg, layer_name):
    """Deserialize a Keras-3 Lambda layer's function.

    Keras serializes the lambda as marshalled CPython bytecode
    (``{"class_name": "__lambda__", "config": {"code": ...}}``) and refuses
    to load it unless ``safe_mode=False`` — running it IS arbitrary code
    execution. We mirror that contract: set ``AAT_UNSAFE_LAMBDA=1`` to allow
    it. The function body runs on torch tensors, so only operator/torch-style
    lambdas execute correctly; `np`/`numpy` globals are aliased to torch."""
    fn_spec = cfg.get("function")
    if isinstance(fn_spec, str):
        # registered/builtin function saved by name, e.g. "abs"
        try:
            return L.activation(fn_spec)
        except ValueError:
            raise ValueError(
                f"Lambda layer {layer_name}: unknown named function {fn_spec!r}"
            )
    if not (isinstance(fn_spec, dict) and fn_spec.get("class_name") == "__lambda__"):
        raise ValueError(f"Lambda layer {layer_name}: unsupported function spec")
    if os.environ.get("AAT_UNSAFE_LAMBDA", "0") != "1":
        raise ValueError(
            f"Lambda layer {layer_name} contains marshalled Python bytecode; "
            "executing it is arbitrary code execution (Keras requires "
            "safe_mode=False for the same reason). Set AAT_UNSAFE_LAMBDA=1 "
            "to allow it."
        )
    spec = fn_spec["config"]
    code = spec["code"]
    raw = base64.decodebytes(code.encode("ascii") if isinstance(code, str) else code)
    code_obj = marshal.loads(raw)
    defaults = spec.get("defaults")
    closure = spec.get("closure")
    if closure is not None:
        def _cell(v):
            return (lambda: v).__closure__[0]

        closure = tuple(_cell(v) for v in closure)
    glb = {
        "np": torch,
        "numpy": torch,
        "torch": torch,
        "__builtins__": __builtins__,
    }
    return types.FunctionType(
        code_obj,
        glb,
        name=code_obj.co_name,
        argdefs=tuple(defaults) if defaults else None,
        closure=closure,
    )


def _fails(msg):
    """A layer callable that raises `msg` when run: an unsupported layer or
    config fails where the JAX executor fails, at the forward, not at
    load."""

    def run(args, kwargs):
        raise ValueError(msg)

    return run


# classes whose config names an activation applied to their output
_ACTIVATED = ("Conv2D", "DepthwiseConv2D", "SeparableConv2D", "Conv1D", "DepthwiseConv1D",
              "SeparableConv1D", "Conv2DTranspose", "Conv1DTranspose", "Dense", "Activation")
_NOISE_LAYERS = ("Dropout", "SpatialDropout2D", "GaussianNoise", "GaussianDropout",
                 "Identity", "ActivityRegularization")


class _TrainContext:
    """One training forward's state, shared with nested models: the live
    leaves, the mask generator, the batch statistics collected and, in a
    data-parallel step, the data shard (group, first row, global rows)."""

    def __init__(self, params, generator, data_shard=None):
        self.params, self.generator, self.stats = params, generator, {}
        self.group, self.row0, self.rows = data_shard or (None, 0, None)

    def draw(self, sample, shape, per_row):
        """``sample(shape)`` from the generator; in a data shard, a noise
        tensor with one entry a row (`per_row`) is this rank's rows of the
        global batch's draw, so that every rank's masks are those that one
        process would draw for the whole batch."""
        if self.rows is None or not per_row:
            return sample(shape)
        return sample([self.rows] + list(shape[1:]))[self.row0 : self.row0 + shape[0]]


class KerasModel(nn.Module):
    """An imported Keras model: ``model(x)`` maps the input (one tensor, or
    a list for multi-input graphs) to the output.

    ``compute_dtype="bfloat16"`` runs the graph in bfloat16: the weights are
    cast once at load, BatchNorm's scale and shift are folded in float32
    from the stored statistics and then cast, Dense accumulates and returns
    float32, and the output is cast back to float32. Off by default —
    float32 keeps strict reference parity.

    ``params`` holds the archive's variables ({weight key: [numpy arrays]},
    shared with nested models) in Keras's layouts: fine-tuning starts from
    them, and ``replace_head`` changes them and rebuilds the layer."""

    def __init__(self, config, weights, name_prefix="", compute_dtype=None,
                 keras2=False):
        super().__init__()
        self.config = config
        cfg = config["config"] if "config" in config else config
        self.name = cfg.get("name", "model")
        self._layers = cfg["layers"]
        self._by_name = {_layer_name(l): l for l in self._layers}
        self._prefix = name_prefix
        self.keras2 = bool(keras2)
        if self.keras2:
            # Keras-2 graph refs to NESTED-MODEL layers are offset +1 (the
            # model's internal construction node is node 0; external calls
            # start at 1) — shift them onto the enumerated external-call
            # index once, in place (idempotent via the marker).
            _shift_k2_model_refs(cfg)
        # The weights.h5 keys are NOT the config layer names: Keras
        # regenerates them at save time as snake_case(class_name) with a
        # fresh per-model, per-base counter (explicit layer names are
        # ignored).
        counts = {}
        self._h5key = {}
        for l in self._layers:
            base = _to_snake_case(l["class_name"])
            n = counts.get(base, 0)
            counts[base] = n + 1
            self._h5key[_layer_name(l)] = base if n == 0 else f"{base}_{n}"
        if isinstance(compute_dtype, torch.dtype):
            compute_dtype = str(compute_dtype).replace("torch.", "")
        self.compute_dtype = (
            _dtype(compute_dtype) if compute_dtype not in (None, "float32") else None
        )
        self._class = config.get("class_name", "Functional")
        self.params = weights
        self._train_ctx = None
        self._subs = {}
        self._fns = {}
        for l in self._layers:
            if l["class_name"] != "InputLayer":
                self._fns[_layer_name(l)] = self._build_layer(l)
        self._output_spec = None
        if self._class == "Sequential":
            self._seq = [self._fns[_layer_name(l)] for l in self._layers
                         if l["class_name"] != "InputLayer"]
        else:
            self._plan(cfg, self._fns)

    # -- construction -------------------------------------------------------

    @classmethod
    def load(cls, path, compute_dtype=None) -> "KerasModel":
        config, weights, meta = read_keras_archive(path)
        keras2 = str(meta.get("keras_version", "3")).startswith("2")
        return cls(config, weights, compute_dtype=compute_dtype, keras2=keras2).eval()

    def _plan(self, cfg, fns):
        """The JAX executor's per-node readiness walk, run once: the order
        of the nodes, their arguments as value slots, and the slots freed
        after each node."""

        # Keras stores a single input/output as one flat [name, node,
        # tensor] triple, multiple as a list of triples.
        def norm(spec):
            if spec and isinstance(spec[0], str):
                return [spec]
            return spec

        output_spec = [tuple(o[:3]) for o in norm(cfg["output_layers"])]
        self._output_spec = output_spec
        input_names = [i[0] for i in norm(cfg["input_layers"])]
        slots = {}

        def slot(key):
            return slots.setdefault(tuple(key), len(slots))

        self._input_slots = [slot((name, 0, 0)) for name in input_names]
        ready = {(name, 0) for name in input_names}
        # per-NODE readiness, not per-layer: a shared layer's later call can
        # consume its own earlier call's output (e.g. a nested model chained
        # onto itself), so nodes of one layer must be runnable independently
        remaining = [
            (l, node_idx, _normalize_node(node))
            for l in self._layers
            if l["class_name"] != "InputLayer"
            for node_idx, node in enumerate(l.get("inbound_nodes", []))
        ]
        order = []
        progress = True
        while remaining and progress:
            progress = False
            still = []
            for layer, node_idx, node in remaining:
                refs = _collect_history(node)
                if not all((r[0], r[1]) in ready for r in refs):
                    still.append((layer, node_idx, node))
                    continue
                order.append((layer, node_idx, node, refs))
                ready.add((layer["name"], node_idx))
                progress = True
            remaining = still
        self._unresolved = sorted({l["name"] for l, _, _ in remaining})

        steps, uses = [], {}
        for i, (layer, node_idx, node, refs) in enumerate(order):
            for r in refs:
                uses[slot(r)] = i
            args = _compile_refs(node.get("args", []), slot)
            kwargs = {
                k: v for k, v in node.get("kwargs", {}).items()
                if k not in ("name", "training", "mask") and v is not None
            }
            steps.append([fns[_layer_name(layer)], args, _compile_refs(kwargs, slot),
                          (layer["name"], node_idx)])
        self._output_slots = [slot(o) for o in output_spec]
        for s in self._output_slots:
            uses[s] = len(steps)
        # each step's outputs that something reads, and the slots whose
        # last reader it is (freed, so dead activations are released)
        for i, step in enumerate(steps):
            name, node_idx = step[3]
            step[3] = [(key[2], s) for key, s in slots.items()
                       if key[:2] == (name, node_idx)]
            step.append([s for s, last in uses.items() if last == i])
        self._steps = [tuple(s) for s in steps]
        self._n_slots = len(slots)

    def walk_layers(self):
        """Yield (weight_key, class_name, config) for every real layer,
        recursing through nested Functional/Sequential submodels in
        execution order — the introspection surface for fine-tuning."""
        for layer in self._layers:
            cls = layer["class_name"]
            if cls == "InputLayer":
                continue
            name = _layer_name(layer)
            if cls in ("Functional", "Sequential"):
                yield from self._subs[name].walk_layers()
            else:
                yield self._prefix + self._h5key[name], cls, layer["config"]

    # -- execution ----------------------------------------------------------

    def apply_train(self, params, x, generator, data_shard=None):
        """Training-mode forward over the leaves `params` ({weight key:
        [tensors]}, ``self.params``'s layout): BatchNormalization normalises
        with the batch statistics (mean and centered biased variance over
        every axis but its own, in float32) and Dropout, SpatialDropout2D
        (one mask per batch and channel), GaussianNoise and GaussianDropout
        are live, their draws taken in turn from `generator` (a
        ``torch.Generator`` on x's device). Returns (y, batch_stats), where
        batch_stats maps each BatchNormalization weight key to its
        (batch_mean, batch_var), detached.

        `data_shard`: (process group, first row, global rows) when `x` is
        this rank's rows of a global batch (parallel/finetune.py): the
        statistics are the global batch's, and each noise draw is this
        rank's rows of the global draw."""
        ctx = _TrainContext(params, generator, data_shard)
        models = [m for m in self.modules() if isinstance(m, KerasModel)]
        for m in models:
            m._train_ctx = ctx
        try:
            y = self(x)
        finally:
            for m in models:
                m._train_ctx = None
        return y, ctx.stats

    def rebuild_layer(self, key) -> bool:
        """Rebuild the callable (and buffers) of the layer whose weight key
        is `key` from ``params`` and its config, in this model or a nested
        one; False when no layer has that key."""
        for layer in self._layers:
            cls, name = layer["class_name"], _layer_name(layer)
            if cls in ("Functional", "Sequential"):
                if self._subs[name].rebuild_layer(key):
                    return True
            elif cls != "InputLayer" and self._prefix + self._h5key[name] == key:
                old = self._fns[name]
                new = self._fns[name] = self._build_layer(layer)
                if self._class == "Sequential":
                    self._seq = [new if fn is old else fn for fn in self._seq]
                else:
                    self._steps = [(new,) + s[1:] if s[0] is old else s for s in self._steps]
                return True
        return False

    def _cast_in(self, x):
        cdt = self.compute_dtype
        if cdt is None or not isinstance(x, torch.Tensor):
            return x
        return x.to(cdt) if x.is_floating_point() else x

    def _cast_out(self, y):
        if self.compute_dtype is None:
            return y
        if isinstance(y, (list, tuple)):
            return type(y)(self._cast_out(o) for o in y)
        return y.float() if y.is_floating_point() else y

    def forward(self, x):
        """Run the graph. `x` is one input tensor (or list for multi-input)."""
        if self._class == "Sequential":
            y = self._cast_in(x)
            for fn in self._seq:
                y = fn([y], {})
            return self._cast_out(y)
        if self._unresolved:
            raise ValueError(f"could not resolve layers: {self._unresolved}")
        inputs = x if isinstance(x, (list, tuple)) else [x]
        values = [None] * self._n_slots
        for s, inp in zip(self._input_slots, inputs):
            values[s] = self._cast_in(inp)
        for fn, args, kwargs, outs, free in self._steps:
            out = fn(args(values), kwargs(values))
            if isinstance(out, (list, tuple)):
                for ti, s in outs:
                    values[s] = out[ti]
            else:
                for ti, s in outs:
                    if ti == 0:
                        values[s] = out
            for s in free:
                values[s] = None
        outs = [values[s] for s in self._output_slots]
        return self._cast_out(outs[0] if len(outs) == 1 else outs)

    # -- per-layer construction ---------------------------------------------

    def _act(self, name):
        """Activation with the semantics of the Keras that SAVED the
        archive (Keras-2 hard_sigmoid differs — see layers.activation)."""
        return L.activation(name, keras2=self.keras2)

    def _vars(self, layer_name):
        """The layer's variables as float32 (or stored-dtype) tensors."""
        key = self._prefix + self._h5key[layer_name]
        return [torch.from_numpy(np.array(a)) for a in self.params.get(key, [])]

    def _cast_w(self, t):
        """A weight in the compute dtype (cast once, here)."""
        cdt = self.compute_dtype
        return t.to(cdt) if cdt is not None and t.is_floating_point() else t

    def _buffer(self, t):
        """Register `t` as a buffer of the layer being built (so it follows
        .to(device); a rebuild overwrites it); returns a getter the layer
        callables read it through at run time."""
        if t is None:
            return lambda: None
        name = f"{self._building}__{self._n_buffers}"
        self._n_buffers += 1
        self.register_buffer(name, t)
        bufs = self._buffers
        return lambda: bufs[name]

    def _param(self, key, vf, idx, fn):
        """The weight ``fn(*vf[idx])`` (a layout change, a cast) of the layer
        with weight key `key`, held as a buffer; returns its getter, which
        in a training forward builds it from the live leaves
        ``params[key][idx]`` instead, so gradients reach them."""
        idx = (idx,) if isinstance(idx, int) else tuple(idx)
        get = self._buffer(fn(*(vf[i] for i in idx)))

        def weight():
            ctx = self._train_ctx
            if ctx is None:
                return get()
            leaves = ctx.params[key]
            return fn(*(leaves[i] for i in idx))

        return weight

    def _build_layer(self, layer):
        """The callable ``fn(args, kwargs)`` of one layer (the JAX
        executor's ``_run_layer`` branch for its class), weights converted
        once."""
        cls = layer["class_name"]
        cfg = layer["config"]
        name = _layer_name(layer)
        key = self._prefix + self._h5key[name]
        self._building, self._n_buffers = self._h5key[name], 0
        vf = self._vars(name)  # float32 statistics, uncast
        cast = self._cast_w

        def param(idx, fn=cast):
            return self._param(key, vf, idx, fn)

        mod = layer.get("module") or ""
        if (mod.startswith("keras.src.ops") or mod.startswith("keras.ops")) and cls in _K3_OPS:
            op = _K3_OPS[cls]
            opkw = {k: w for k, w in cfg.items() if k != "name" and w is not None}
            # config keys a newer Keras serializes that the op doesn't take
            # (e.g. dtype) must degrade gracefully, not TypeError — keep
            # only keys the op's signature names
            ps = inspect.signature(op).parameters.values()
            if not any(p.kind == p.VAR_KEYWORD for p in ps):
                known = {p.name for p in ps
                         if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)}
                opkw = {k: w for k, w in opkw.items() if k in known}
            return lambda args, kwargs: op(*args, **{**opkw, **kwargs})

        def unary(f):
            return lambda args, kwargs: f(args[0])

        if cls in _NOISE_LAYERS:
            return unary(self._noise(cls, cfg))
        if "MagTransform" in cls or "MagTransform" in (layer.get("registered_name") or ""):
            a = param(0)
            return unary(lambda x: mag_transform(x, a()))

        act = self._act(cfg.get("activation")) if cls in _ACTIVATED else None
        use_bias = cfg.get("use_bias", True)

        def kernel(kind):
            def layout(k):
                w = L.torch_kernel(cast(k), kind)
                return w.contiguous(memory_format=torch.channels_last) if w.ndim == 4 else w

            return layout

        def bias_at(i):
            return param(i) if use_bias and len(vf) > i else (lambda: None)

        def conv_weights(kind):
            return param(0, kernel(kind)), bias_at(1)

        if cls in ("Conv2D", "DepthwiseConv2D", "SeparableConv2D"):
            strides = _pair(cfg.get("strides", 1))
            padding = cfg.get("padding", "valid")
            dilation = _pair(cfg.get("dilation_rate", 1))
            if cls == "Conv2D":
                w, b = conv_weights("conv")
                groups = int(cfg.get("groups", 1))
                return unary(lambda x: act(L.conv2d(x, w(), b(), strides, padding, dilation,
                                                    groups)))
            if cls == "DepthwiseConv2D":
                w, b = conv_weights("depthwise")
                return unary(lambda x: act(L.depthwise_conv2d(x, w(), b(), strides, padding,
                                                              dilation)))
            dw = param(0, lambda k: L.torch_kernel(cast(k), "depthwise"))
            pw = param(1, lambda k: L.torch_kernel(cast(k), "conv"))
            b = bias_at(2)
            return unary(lambda x: act(L.conv2d(
                L.depthwise_conv2d(x, dw(), None, strides, padding, dilation),
                pw(), b(), (1, 1), "VALID")))
        if cls in ("Conv1D", "DepthwiseConv1D", "SeparableConv1D"):
            strides = _one(cfg.get("strides", 1))
            padding = cfg.get("padding", "valid")
            dilation = _one(cfg.get("dilation_rate", 1))
            if cls == "Conv1D":
                w, b = conv_weights("conv")
                groups = int(cfg.get("groups", 1))
                return unary(lambda x: act(L.conv1d(x, w(), b(), strides, padding, dilation,
                                                    groups)))
            if cls == "DepthwiseConv1D":
                w, b = conv_weights("depthwise")
                return unary(lambda x: act(L.depthwise_conv1d(x, w(), b(), strides, padding,
                                                              dilation)))
            dw = param(0, lambda k: L.torch_kernel(cast(k), "depthwise"))
            pw = param(1, lambda k: L.torch_kernel(cast(k), "conv"))
            b = bias_at(2)
            return unary(lambda x: act(L.conv1d(
                L.depthwise_conv1d(x, dw(), None, strides, padding, dilation),
                pw(), b(), 1, "VALID")))
        if cls in ("Conv2DTranspose", "Conv1DTranspose"):
            # fail loudly instead of importing with a silently different
            # output shape/values
            if cfg.get("output_padding") is not None:
                return _fails(f"unsupported Keras layer config: {cls} with "
                              f"output_padding={cfg['output_padding']!r}")
            if cfg.get("groups", 1) != 1:
                return _fails(f"unsupported Keras layer config: {cls} with "
                              f"groups={cfg['groups']!r}")
            w, b = conv_weights("transpose")
            padding = cfg.get("padding", "valid")
            if cls == "Conv2DTranspose":
                strides, dilation = _pair(cfg.get("strides", 1)), _pair(cfg.get("dilation_rate", 1))
                return unary(lambda x: act(L.conv2d_transpose(x, w(), b(), strides, padding,
                                                              dilation)))
            strides, dilation = _one(cfg.get("strides", 1)), _one(cfg.get("dilation_rate", 1))
            return unary(lambda x: act(L.conv1d_transpose(x, w(), b(), strides, padding,
                                                          dilation)))
        if cls == "Dense":
            # the JAX dense accumulates in float32 and returns float32
            # (preferred_element_type): with bf16 operands the products are
            # exact in float32, so the bf16-rounded weights are kept as
            # float32 and the input is widened
            w = param(0, lambda k: L.torch_kernel(cast(k), "dense").float())
            b = param(1, lambda t: cast(t).float()) if use_bias and len(vf) > 1 else (lambda: None)
            return unary(lambda x: act(F.linear(x.float(), w(), b())))
        if cls == "BatchNormalization":
            scale, center = cfg.get("scale", True), cfg.get("center", True)
            i = 0
            gamma = vf[i] if scale else None
            i += 1 if scale else 0
            beta = vf[i] if center else None
            i += 1 if center else 0
            mean, var = vf[i], vf[i + 1]
            eps = cfg.get("epsilon", 1e-3)
            axis = cfg.get("axis", -1)
            if isinstance(axis, list):
                axis = axis[0]
            # fold to scale/shift in float32 (rsqrt of a bf16 variance would
            # lose ~3 digits), then apply in the compute dtype: one pass
            inv = torch.rsqrt(var.float() + eps)
            a = inv if gamma is None else gamma * inv
            sh = -mean * a if beta is None else beta - mean * a
            a, sh = self._buffer(cast(a)), self._buffer(cast(sh))

            def bn_train(x, ctx):
                # the batch's statistics (Keras training semantics), in
                # float32, from the live gamma and beta; the moving
                # statistics are the EMA's (parallel/finetune.py)
                leaves = ctx.params[key]
                g = leaves[0] if scale else None
                bt = leaves[1 if scale else 0] if center else None
                ax = axis % x.ndim
                red = tuple(d for d in range(x.ndim) if d != ax)
                shape = [1] * x.ndim
                shape[ax] = x.shape[ax]
                xf = x.float()
                # the centered moment, not E[x^2] - E[x]^2, which cancels
                # catastrophically for large-mean activations
                bm, bv = L.batch_moments(xf, red, ctx.group)
                ctx.stats[key] = (bm.detach(), bv.detach())
                inv_b = torch.rsqrt(bv + eps)
                ab = inv_b if g is None else g * inv_b
                sb = -bm * ab if bt is None else bt - bm * ab
                return (xf * ab.reshape(shape) + sb.reshape(shape)).to(x.dtype)

            def bn(x):
                ctx = self._train_ctx
                if ctx is not None:
                    return bn_train(x, ctx)
                if axis in (-1, x.ndim - 1):
                    return torch.addcmul(sh(), x, a())
                shape = [1] * x.ndim
                shape[axis] = x.shape[axis]
                return torch.addcmul(sh().reshape(shape), x, a().reshape(shape))

            return unary(bn)
        if cls == "Activation":
            return unary(act)
        if cls == "ReLU":
            slope = cfg.get("negative_slope", 0.0)
            mx = cfg.get("max_value")
            thr = cfg.get("threshold", 0.0)

            def relu(x):
                y = torch.where(x < 0, slope * x, x)
                if mx is not None:
                    y = torch.clamp(y, max=mx)
                if thr:
                    y = torch.where(x < thr, 0.0, y)
                return y

            return unary(relu)
        if cls == "LeakyReLU":
            slope = cfg.get("negative_slope", cfg.get("alpha", 0.3))
            return unary(lambda x: F.leaky_relu(x, slope))
        if cls == "ELU":
            alpha = cfg.get("alpha", 1.0)
            return unary(lambda x: F.elu(x, alpha))
        if cls == "PReLU":
            # alpha is shaped like input[1:] with shared axes at 1 — it
            # broadcasts against x directly
            alpha = param(0)
            return unary(lambda x: torch.relu(x) - alpha() * torch.relu(-x))
        if cls == "Softmax":
            axis = cfg.get("axis", -1)
            return unary(lambda x: torch.softmax(x, dim=axis))
        if cls in ("MaxPooling2D", "AveragePooling2D"):
            pool = _pair(cfg.get("pool_size", 2))
            strides = _pair(cfg.get("strides") or cfg.get("pool_size", 2))
            op = L.max_pool2d if cls == "MaxPooling2D" else L.avg_pool2d
            padding = cfg.get("padding", "valid")
            return unary(lambda x: op(x, pool, strides, padding))
        if cls in ("MaxPooling1D", "AveragePooling1D"):
            pool = _one(cfg.get("pool_size", 2))
            strides = _one(cfg.get("strides") or cfg.get("pool_size", 2))
            op = L.max_pool1d if cls == "MaxPooling1D" else L.avg_pool1d
            padding = cfg.get("padding", "valid")
            return unary(lambda x: op(x, pool, strides, padding))
        keepdims = cfg.get("keepdims", False)
        if cls == "GlobalAveragePooling2D":
            return unary(lambda x: L.global_avg_pool2d(x, keepdims))
        if cls == "GlobalMaxPooling2D":
            return unary(lambda x: L.global_max_pool2d(x, keepdims))
        if cls == "GlobalAveragePooling1D":
            return unary(lambda x: x.mean(dim=1, keepdim=keepdims))
        if cls == "GlobalMaxPooling1D":
            return unary(lambda x: x.amax(dim=1, keepdim=keepdims))
        if cls == "ZeroPadding1D":
            p = cfg.get("padding", 1)
            pl, pr = (p, p) if isinstance(p, int) else (int(p[0]), int(p[1]))
            return unary(lambda x: F.pad(x, (0, 0, pl, pr)))
        if cls == "Cropping1D":
            c = cfg.get("cropping", (1, 1))
            cl, cr = (c, c) if isinstance(c, int) else (int(c[0]), int(c[1]))
            return unary(lambda x: x[:, cl : x.shape[1] - cr or None, :])
        if cls == "UpSampling1D":
            size = int(cfg.get("size", 2))
            return unary(lambda x: x.repeat_interleave(size, dim=1))
        if cls == "LayerNormalization":
            return unary(self._layer_norm(cfg, vf, param))
        if cls == "UnitNormalization":
            axes = cfg.get("axis", -1)
            axes = tuple(axes) if isinstance(axes, (list, tuple)) else (axes,)
            return unary(lambda x: x / torch.clamp(
                torch.sqrt(torch.sum(torch.square(x), axes, keepdim=True)), min=1e-12))
        if cls == "Embedding":
            table = param(0)
            return unary(lambda x: table()[x.long()])
        if cls == "Flatten":
            return unary(lambda x: x.reshape(x.shape[0], -1))
        if cls == "Reshape":
            target = tuple(cfg["target_shape"])
            return unary(lambda x: x.reshape((x.shape[0],) + target))
        if cls == "Permute":
            dims = (0,) + tuple(cfg["dims"])
            return unary(lambda x: x.permute(dims))
        if cls == "ZeroPadding2D":
            pads = _norm_pad2d(cfg.get("padding", 1))
            return unary(lambda x: L.zero_padding2d(x, pads))
        if cls == "Cropping2D":
            crops = _norm_pad2d(cfg.get("cropping", 0))
            return unary(lambda x: L.cropping2d(x, crops))
        if cls == "UpSampling2D":
            size = _pair(cfg.get("size", 2))
            interp = cfg.get("interpolation", "nearest")
            return unary(lambda x: L.up_sampling2d(x, size, interp))
        if cls == "Rescaling":
            # a per-channel scale or offset (a list) is a float32 buffer;
            # a scalar stays a Python number, which keeps x's dtype
            s, o = (self._buffer(torch.tensor(c, dtype=torch.float32)) if isinstance(c, list)
                    else (lambda c=c: c)
                    for c in (cfg.get("scale", 1.0), cfg.get("offset", 0.0)))
            return unary(lambda x: x * s() + o())
        if cls == "Normalization":
            return unary(self._normalization(cfg, vf, param))
        if cls in ("Add", "Subtract", "Multiply", "Average", "Maximum", "Minimum",
                   "Concatenate"):
            merge = {
                "Add": lambda a: functools.reduce(operator.add, a),
                "Subtract": lambda a: a[0] - a[1],
                "Multiply": lambda a: functools.reduce(operator.mul, a),
                "Average": lambda a: functools.reduce(operator.add, a) / len(a),
                "Maximum": lambda a: functools.reduce(torch.maximum, a),
                "Minimum": lambda a: functools.reduce(torch.minimum, a),
                "Concatenate": functools.partial(torch.cat, dim=cfg.get("axis", -1)),
            }[cls]
            return lambda args, kwargs: merge(args[0] if isinstance(args[0], list) else args)
        if cls == "Lambda":
            def run_lambda(args, kwargs):
                fn = _load_lambda(cfg, name)
                extra = dict(cfg.get("arguments") or {})
                extra.update(kwargs)
                return fn(*args, **extra)

            return run_lambda
        if cls == "TFOpLambda":
            fname = cfg.get("function")

            def run_tf_op(args, kwargs):
                return _tf_op(fname, name)(*args, **kwargs)

            return run_tf_op
        if cls == "SlicingOpLambda":
            def run_slice(args, kwargs):
                spec = kwargs.get("slice_spec")
                if cfg.get("function") != "__operators__.getitem" or spec is None:
                    raise ValueError(f"unsupported SlicingOpLambda {name}")
                return _getitem_slice_spec(args[0], spec)

            return run_slice
        if cls in ("Functional", "Sequential"):
            sub = KerasModel(
                layer,
                self.params,
                name_prefix=self._prefix + self._h5key[name] + "/layers/",
                compute_dtype=self.compute_dtype,
                keras2=self.keras2,
            )
            self._subs[name] = sub
            self.add_module(f"sub{len(self._subs)}", sub)
            return lambda args, kwargs: sub(args[0] if len(args) == 1 else args)
        return _fails(f"unsupported Keras layer {cls} ({name})")

    def _noise(self, cls, cfg):
        """The regularisation layers: the identity, except in a training
        forward, where Dropout (``noise_shape`` broadcast, e.g.
        EfficientNet's stochastic depth), SpatialDropout2D (one mask per
        batch and channel), GaussianNoise and GaussianDropout draw from the
        context's generator."""
        rate = float(cfg.get("rate", 0.0) or 0.0)
        stddev = float(cfg.get("stddev", 0.0) or 0.0)

        def noise(x):
            ctx = self._train_ctx
            if ctx is None:
                return x
            gen = ctx.generator
            if cls in ("Dropout", "SpatialDropout2D") and rate > 0:
                shape, per_row = list(x.shape), True
                if cls == "SpatialDropout2D":
                    shape[1] = shape[2] = 1
                elif cfg.get("noise_shape"):
                    # None dims follow the input, fixed dims broadcast
                    shape = [x.shape[d] if n is None else int(n)
                             for d, n in enumerate(cfg["noise_shape"])]
                    per_row = cfg["noise_shape"][0] is None
                u = ctx.draw(lambda s: torch.rand(s, generator=gen, device=x.device), shape,
                             per_row)
                return torch.where(u < 1.0 - rate, x / (1.0 - rate), 0.0).to(x.dtype)
            normal = lambda s: torch.randn(s, generator=gen, device=x.device, dtype=x.dtype)
            if cls == "GaussianNoise" and stddev:
                return x + stddev * ctx.draw(normal, x.shape, True)
            if cls == "GaussianDropout" and rate > 0:
                std = math.sqrt(rate / (1.0 - rate))
                return x * (1.0 + std * ctx.draw(normal, x.shape, True))
            return x

        return noise

    def _layer_norm(self, cfg, vf, param):
        axes = cfg.get("axis", -1)
        axes = tuple(axes) if isinstance(axes, (list, tuple)) else (axes,)
        eps = cfg.get("epsilon", 1e-3)
        i = 0
        # float32 statistics path: gamma and beta uncast
        gamma = param(i, lambda t: t) if cfg.get("scale", True) and len(vf) > i else (lambda: None)
        i += 1 if cfg.get("scale", True) else 0
        beta = param(i, lambda t: t) if cfg.get("center", True) and len(vf) > i else (lambda: None)
        rms = cfg.get("rms_scaling", False)

        def layer_norm(x):
            ax = tuple(a % x.ndim for a in axes)
            shape = [1] * x.ndim
            for a in ax:
                shape[a] = x.shape[a]
            g, b = gamma(), beta()
            xf = x.float()
            if rms:
                # deprecated Keras option: no centering, scale by rms
                y = xf * torch.rsqrt(torch.mean(torch.square(xf), ax, keepdim=True) + eps)
                if g is not None:
                    y = y * g.reshape(shape)
                return y.to(x.dtype)
            mean = torch.mean(xf, ax, keepdim=True)
            var = torch.mean(torch.square(xf - mean), ax, keepdim=True)
            y = (xf - mean) * torch.rsqrt(var + eps)
            if g is not None:
                y = y * g.reshape(shape)
            if b is not None:
                y = y + b.reshape(shape)
            return y.to(x.dtype)

        return layer_norm

    def _normalization(self, cfg, vf, param):
        cdt = self.compute_dtype
        invert = cfg.get("invert", False)
        if len(vf) >= 2:  # adapt()-ed stats are stored as weights
            def scale_shift(mean, var):
                mean, var = mean.float(), var.float()
                if invert:
                    return torch.sqrt(var), mean
                if cdt is not None:
                    a = torch.rsqrt(var)
                    return a.to(cdt), (-mean * a).to(cdt)
                return torch.sqrt(var), mean

            a = param((0, 1), lambda m, v: scale_shift(m, v)[0])
            b = param((0, 1), lambda m, v: scale_shift(m, v)[1])
            axis = None
        else:
            # constructor-supplied stats live in the CONFIG, not the weights
            # (e.g. EfficientNetV2's ImageNet mean/variance)
            mean, var = cfg.get("mean"), cfg.get("variance")
            if mean is None or var is None:
                return lambda x: x  # unbuilt/un-adapted layer: identity
            axis = cfg.get("axis", -1)
            if isinstance(axis, (list, tuple)):
                axis = axis[0] if axis else -1
            mean = torch.as_tensor(mean, dtype=torch.float32)
            var = torch.as_tensor(var, dtype=torch.float32)
            if not mean.ndim:
                axis = None
            if invert:
                a, b = torch.sqrt(var), mean
            elif cdt is not None:
                # no epsilon: Keras divides by sqrt(var) as stored
                a = torch.rsqrt(var)
                a, b = a.to(cdt), (-mean * a).to(cdt)
            else:
                a, b = torch.sqrt(var), mean
            a, b = self._buffer(a), self._buffer(b)
        kind = "invert" if invert else ("fold" if cdt is not None else "divide")

        def normalize(x):
            sa, sb = a(), b()
            if axis is not None:
                shape = [1] * x.ndim
                shape[axis] = sa.shape[0]
                sa, sb = sa.reshape(shape), sb.reshape(shape)
            if kind == "fold":
                return x * sa + sb
            y = x * sa + sb if kind == "invert" else (x - sb) / sa
            return y.to(cdt) if cdt is not None else y

        return normalize


# ---------------------------------------------------------------------------
# inbound-node resolution
# ---------------------------------------------------------------------------


def _shift_k2_model_refs(cfg):
    """Keras-2 ref-index normalisation, in place and idempotent.

    In Keras 2, a nested Model/Sequential layer's keras_history node indices
    count its INTERNAL construction node first: external calls enumerate as
    inbound_nodes[0..k] but are referenced as node 1..k+1 (a twice-called
    nested model serializes refs [1, 2] for calls [0, 1]). Shift every ref
    that targets a nested-model layer of THIS graph down by one so the
    (name, node, tensor) keys match the enumeration the walk uses."""
    if cfg.get("__aat_k2_shifted__"):
        return
    cfg["__aat_k2_shifted__"] = True
    layers = cfg.get("layers", [])
    model_names = {
        _layer_name(l)
        for l in layers
        if l.get("class_name") in ("Functional", "Sequential")
    }
    if not model_names:
        return

    def fix_triple(trip):
        nm, idx, t = trip[0], trip[1], trip[2]
        if nm in model_names and isinstance(idx, int) and idx > 0:
            idx -= 1
        return [nm, idx, t] + list(trip[3:])

    def walk(obj):
        if (
            isinstance(obj, list)
            and len(obj) in (3, 4)
            and isinstance(obj[0], str)
            and isinstance(obj[1], int)
            and isinstance(obj[2], int)
            and (len(obj) == 3 or isinstance(obj[3], dict))
        ):
            out = fix_triple(obj)
            if len(out) == 4:
                out[3] = walk(out[3])
            return out
        if isinstance(obj, dict):
            if obj.get("class_name") == "__keras_tensor__":
                h = obj["config"]["keras_history"]
                return {
                    **obj,
                    "config": {**obj["config"], "keras_history": fix_triple(h)},
                }
            return {k: walk(v) for k, v in obj.items()}
        if isinstance(obj, list):
            return [walk(v) for v in obj]
        return obj

    for l in layers:
        if "inbound_nodes" in l:
            l["inbound_nodes"] = walk(l["inbound_nodes"])
    for key in ("output_layers", "input_layers"):
        if key in cfg:
            cfg[key] = walk(cfg[key])


def _normalize_node(node):
    """Normalise an inbound_nodes entry to the Keras-3 dict form.

    Keras 3 writes ``{"args": [...__keras_tensor__ refs...], "kwargs": {}}``;
    legacy Keras 2 archives (e.g. tf_keras re-saves of the reference's TF1
    morepork SavedModels) write a list of
    ``[layer_name, node_index, tensor_index, call_kwargs]`` entries."""
    if isinstance(node, dict):
        return node
    if node and isinstance(node[0], str):
        # tf_keras writes TFOpLambda/SlicingOpLambda nodes FLAT:
        # ["layer", n, t, {kwargs}] rather than a list of such entries
        node = [node]
    refs = [
        {
            "class_name": "__keras_tensor__",
            "config": {"keras_history": [e[0], e[1], e[2]]},
        }
        for e in node
    ]
    kwargs = {}
    if node and len(node[0]) > 3 and isinstance(node[0][3], dict):
        kwargs = _legacy_kwarg_refs(node[0][3])
    # multi-input layers (Add/Concatenate/...) take one list argument in
    # Keras 3 call signatures; single-input layers take the bare tensor
    args = refs if len(refs) == 1 else [refs]
    return {"args": args, "kwargs": kwargs}


def _legacy_kwarg_refs(obj):
    """Keras-2 node kwargs embed tensor references as bare
    ``[layer_name, node_idx, tensor_idx]`` lists (e.g. the ``y`` operand of
    a TFOpLambda ``__operators__.add``) — rewrite them to the Keras-3
    ``__keras_tensor__`` dict form so the resolvers see them."""
    if (
        isinstance(obj, list)
        and len(obj) in (3, 4)
        and isinstance(obj[0], str)
        and isinstance(obj[1], int)
        and isinstance(obj[2], int)
        and (len(obj) == 3 or isinstance(obj[3], dict))
    ):
        return {
            "class_name": "__keras_tensor__",
            "config": {"keras_history": [obj[0], obj[1], obj[2]]},
        }
    if isinstance(obj, dict):
        return {k: _legacy_kwarg_refs(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_legacy_kwarg_refs(v) for v in obj]
    return obj


def _collect_history(node):
    node = _normalize_node(node)
    refs = []

    def rec(obj):
        if isinstance(obj, dict):
            if obj.get("class_name") == "__keras_tensor__":
                h = obj["config"]["keras_history"]
                refs.append((h[0], h[1], h[2]))
            else:
                for vv in obj.values():
                    rec(vv)
        elif isinstance(obj, (list, tuple)):
            for vv in obj:
                rec(vv)

    rec(node.get("args", []))
    rec(node.get("kwargs", {}))
    return refs


def _compile_refs(obj, slot):
    """A resolver ``values -> obj`` with every tensor reference replaced by
    its value slot (``slot(key)`` numbers the keys), slices and ellipses
    decoded; built once, so the forward does no parsing."""
    if isinstance(obj, dict):
        cn = obj.get("class_name")
        if cn == "__keras_tensor__":
            h = obj["config"]["keras_history"]
            s = slot((h[0], h[1], h[2]))
            return lambda values: values[s]
        if cn == "__slice__":
            c = obj.get("config", {})
            const = slice(c.get("start"), c.get("stop"), c.get("step"))
            return lambda values: const
        if cn == "__ellipsis__":
            return lambda values: Ellipsis
        items = [(k, _compile_refs(vv, slot)) for k, vv in obj.items()]
        return lambda values: {k: f(values) for k, f in items}
    if isinstance(obj, (list, tuple)):
        fs = [_compile_refs(vv, slot) for vv in obj]
        if isinstance(obj, tuple):
            return lambda values: tuple(f(values) for f in fs)
        return lambda values: [f(values) for f in fs]
    return lambda values: obj
