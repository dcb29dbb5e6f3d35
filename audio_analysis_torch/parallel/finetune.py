"""Fine-tune imported ``.keras`` classifiers (the JAX package's
parallel/finetune.py).

The leaves are ``KerasModel.params`` as tensors in Keras's layouts; a step
runs ``KerasModel.apply_train`` (batch-statistics BatchNorm, live dropout),
the NLL, backward, AdamW with the decay on trainable kernels only, and the
BatchNorm EMA. Frozen leaves (BatchNorm's moving statistics, Normalization's
statistics, whose gradients are not zero) and integer leaves (Normalization's
``count``) stay out of the optimizer, so their only update is the EMA. The
tuned leaves go back into a ``.keras`` archive with
io/keras_export.py::write_keras_archive.

Over a mesh (``build_finetune(km, mesh=)``) the step is data-parallel, as
the JAX package's is: each rank takes its rows of the global batch,
BatchNorm's statistics are the global batch's, each dropout mask is the
rank's rows of the mask one process would draw for the global batch (the
ranks' generators in the same state), and the gradients are summed over
'data'; the leaves replicate.
"""

import logging

import numpy as np
import torch

from audio_analysis_torch.device import resolve_device
from audio_analysis_torch.models.keras_graph import _collect_history
from audio_analysis_torch.parallel.distributed import all_reduce_tensors

BN_MOMENTUM = 0.99  # Keras BatchNormalization default


def non_trainable_mask(km):
    """{weight_key: [bool per var]}, True for leaves that must not train:
    BatchNorm's moving mean and variance (its last two vars) and every
    Normalization statistic."""
    frozen_rules = {}
    for key, cls, _ in km.walk_layers():
        if cls == "BatchNormalization":
            frozen_rules[key] = "bn"
        elif cls == "Normalization":
            frozen_rules[key] = "all"
    mask = {}
    for key, vs in km.params.items():
        rule = frozen_rules.get(key)
        if rule == "all":
            mask[key] = [True] * len(vs)
        elif rule == "bn":
            mask[key] = [False] * (len(vs) - 2) + [True, True]
        else:
            mask[key] = [False] * len(vs)
    return mask


def decay_mask(km):
    """Weight decay on trainable kernels (ndim >= 2) only: never biases,
    gamma, beta or the frozen statistics."""
    frozen = non_trainable_mask(km)
    return {
        key: [(np.ndim(v) >= 2) and not fz for v, fz in zip(vs, frozen[key])]
        for key, vs in km.params.items()
    }


# layers that pass their single input through unchanged shape-wise: safe to
# trace through when walking back from the output spec to the head Dense
_PASS_THROUGH = {"Activation", "Softmax", "Dropout", "AlphaDropout", "Reshape",
                 "Flatten", "Identity"}


def _head_from_output(km):
    """The classification head, traced from the model's output spec back
    through pass-through layers to a Dense: (weight_key, layer config), or
    None when the graph is not one that can be followed (multi-output,
    Sequential, a tail that is not Dense)."""
    spec = km._output_spec
    if not spec or len(spec) != 1:
        return None
    name = spec[0][0]
    for _ in range(8):
        layer = km._by_name.get(name)
        if layer is None:
            return None
        cls = layer["class_name"]
        if cls == "Dense":
            return km._prefix + km._h5key[name], layer["config"]
        if cls not in _PASS_THROUGH:
            return None
        nodes = layer.get("inbound_nodes", [])
        if len(nodes) != 1:
            return None
        refs = _collect_history(nodes[0])
        if len(refs) != 1:
            return None
        name = refs[0][0]
    return None


def replace_head(km, num_classes, seed=0):
    """Re-initialise the head Dense for a new label space: a Glorot-uniform
    kernel [in, num_classes] drawn from ``np.random.RandomState(seed)`` and
    a zero bias. Changes ``km.params``, the layer's config (``units``, so an
    exported archive carries a consistent graph) and the layer's callable.
    Returns the head's weight key.

    The head is the Dense feeding the output spec; where that cannot be
    traced, the last Dense in config order (with a warning when there are
    several)."""
    head = _head_from_output(km)
    if head is None:
        denses = [(key, cfg) for key, cls, cfg in km.walk_layers() if cls == "Dense"]
        if not denses:
            raise ValueError("model has no Dense layer to act as the head")
        if len(denses) > 1:
            logging.warning(
                "could not trace the output head; %d Dense layers found, "
                "replacing the last in config order (%s)", len(denses), denses[-1][0],
            )
        head = denses[-1]
    key, cfg = head
    vs = km.params[key]
    fan_in = vs[0].shape[0]
    limit = float(np.sqrt(6.0 / (fan_in + num_classes)))
    rng = np.random.RandomState(seed)
    new = [rng.uniform(-limit, limit, (fan_in, num_classes)).astype(np.float32)]
    if len(vs) > 1:  # use_bias
        new.append(np.zeros((num_classes,), np.float32))
    km.params[key] = new
    cfg["units"] = int(num_classes)
    km.rebuild_layer(key)
    return key


def build_finetune(km, device=None, lr=1e-4, weight_decay=1e-4, bn_momentum=BN_MOMENTUM,
                   outputs="probs", mesh=None):
    """(params, optimizer, step) for fine-tuning `km` on `device` (None:
    the card; the model is moved there), or data-parallel on this rank's
    device of `mesh` (then `device` stays None).

    ``step(params, optimizer, feats, labels, generator) -> (loss, acc)``
    updates `params` and `optimizer` in place. `feats` is the model-input
    feature grid (e.g. [B, n_mels, T, C] mel windows from
    ``classify.features_for_config``; over a mesh, this rank's rows of the
    global batch), `generator` a ``torch.Generator`` on the device for the
    dropout masks. `outputs`: "probs" when the model ends in softmax (every
    released classifier: log(clip(p, 1e-9, 1))), "logits" otherwise
    (log-softmax). The loss and accuracy are the global batch's."""
    group, n_data, d = None, 1, 0
    if mesh is not None:
        from audio_analysis_torch.parallel.mesh import data_group, data_index, rank_device

        if device is not None:
            raise ValueError("pass a mesh or a device: the mesh decides the device")
        device, group, n_data, d = rank_device(mesh), data_group(mesh), mesh.size(0), \
            data_index(mesh)
    dev = resolve_device(device)
    km.to(dev)
    frozen, decay = non_trainable_mask(km), decay_mask(km)
    params, groups = {}, {True: [], False: []}
    for key, vs in km.params.items():
        leaves = []
        for a, fz, dc in zip(vs, frozen[key], decay[key]):
            t = torch.tensor(np.asarray(a), device=dev)
            if t.is_floating_point() and not fz:
                groups[dc].append(t.requires_grad_(True))
            leaves.append(t)
        params[key] = leaves
    optimizer = torch.optim.AdamW(
        [{"params": ps, "weight_decay": weight_decay if dc else 0.0}
         for dc, ps in groups.items() if ps],
        lr=lr, betas=(0.9, 0.999), eps=1e-8,
    )

    trainable = [t for ts in groups.values() for t in ts]

    def step(params, optimizer, feats, labels, generator):
        optimizer.zero_grad(set_to_none=True)
        b = feats.shape[0]
        shard = None if group is None else (group, d * b, n_data * b)
        out, bn_stats = km.apply_train(params, feats, generator, data_shard=shard)
        if outputs == "probs":
            logp = torch.log(torch.clamp(out, 1e-9, 1.0))
        else:
            logp = torch.log_softmax(out, dim=1)
        labels = labels.long()
        nll = -logp.gather(1, labels[:, None]).sum() / (n_data * b)
        acc = (logp.argmax(dim=1) == labels).float().sum() / (n_data * b)
        nll.backward()
        totals = torch.stack([nll.detach(), acc])
        if group is not None:
            all_reduce_tensors([t.grad for t in trainable if t.grad is not None] + [totals],
                               group)
        optimizer.step()
        with torch.no_grad():
            for key, (bm, bv) in bn_stats.items():
                vs = params[key]
                vs[-2].copy_(bn_momentum * vs[-2] + (1.0 - bn_momentum) * bm)
                vs[-1].copy_(bn_momentum * vs[-1] + (1.0 - bn_momentum) * bv)
        return totals[0], totals[1]

    return params, optimizer, step
