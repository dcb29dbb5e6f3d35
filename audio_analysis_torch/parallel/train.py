"""Training for the native classifier (the JAX package's parallel/train.py).

One step: the frontend over the PCM windows at the classify settings (the
``stft_mel`` kernel at the exact level, ``stft_mel_bf16`` under AAT_FAST),
TuiNet's training forward (BatchNorm on the batch's statistics), log-softmax
NLL, backward, AdamW with the weight decay on the conv and dense kernels
only, the batch statistics' EMA into the running mean and variance (Keras
momentum 0.99), and MagTransform v2's constraint on ``mag_a``.

``build_train`` runs it on one device, or over a ('data', 'model') mesh of
ranks (parallel/mesh.py) as the JAX package's one sharded program does:
each rank takes its rows of the global batch (DP over windows); BatchNorm's
statistics are the global batch's (its sums all-reduced over 'data', as
XLA's psum makes them in the JAX step; a per-rank statistic would train
another model); the dense head is split along 'model' by ``HEAD_PLAN``
(``param_shardings``' TP plan) and the partial logits are summed over
'model'; the loss and accuracy are the global batch's, and the gradients
are summed over 'data'. AdamW, the EMA and the constraint then run on each
rank's own slice, as in one process. Without a mesh every group is None
and the step is the single-device one.
"""

import numpy as np
import torch
from torch import nn

from audio_analysis_torch.device import resolve_device
from audio_analysis_torch.models.birdnet import TuiNet, TuiNetConfig
from audio_analysis_torch.models.magtransform import mag_transform_apply_constraint
from audio_analysis_torch.pipeline.frontend import spectrogram_grid

BN_MOMENTUM = 0.99  # Keras BatchNormalization default


def features(pcm, n_mels, sr, hop_length, level=None):
    """The training frontend over [B, samples] PCM windows -> [B, n_mels,
    frames, 1], at the JAX trainer's fixed settings (n_fft 4096, htk mel
    with break 1750 Hz, power 2, dB, min-max normalised windows). No
    gradient flows into it: the PCM is data."""
    with torch.no_grad():
        return spectrogram_grid(
            pcm, sr=sr, hop_length=hop_length, n_fft=4096, n_mels=n_mels,
            mel_break=1750.0, htk=True, power=2.0, db_scale=True, normalize=True,
            level=level,
        )


def loss_fn(net: TuiNet, pcm, labels, sr: int, hop_length: int, mesh=None):
    """(nll, (accuracy, batch statistics)) of one batch; `net` in train
    mode normalises with the batch statistics. Over a `mesh`, `pcm` and
    `labels` are this rank's rows of a global batch of that many rows a
    data index, the statistics are the global batch's, and nll and
    accuracy are this rank's share of the global ones (its sums over the
    global rows): summed over 'data' they are the global mean."""
    from audio_analysis_torch.parallel.mesh import data_group, model_group

    feats = features(pcm, net.cfg.n_mels, sr, hop_length)
    logits, bn_stats = net(feats, with_stats=True, data_group=data_group(mesh),
                           model_group=model_group(mesh))
    labels = labels.long()
    rows = labels.shape[0] * (1 if mesh is None else mesh.size(0))
    nll = -torch.log_softmax(logits, dim=1).gather(1, labels[:, None]).sum() / rows
    acc = (logits.argmax(dim=1) == labels).float().sum() / rows
    return nll, (acc, bn_stats)


def _jax_path(name):
    """The JAX tree path of a TuiNet parameter ('stem_w' -> 'stem/w',
    'blocks.0.bn1.gamma' -> 'blocks/0/bn1/gamma')."""
    name = name.replace(".", "/")
    for top in ("stem", "head"):
        if name.startswith(top + "_"):
            return f"{top}/{name[len(top) + 1:]}"
    return name


def _decay_mask(net: TuiNet) -> dict:
    """{parameter name: decayed}: the conv and dense kernels (leaves named
    w, w1, w2 outside BatchNorm) only, never biases, gamma, beta or mag_a.
    The running statistics are buffers, outside the optimizer."""
    mask = {}
    for name, _ in net.named_parameters():
        path = _jax_path(name)
        mask[name] = path.rsplit("/", 1)[-1] in ("w", "w1", "w2") and "bn" not in path
    return mask


def make_optimizer(net: TuiNet, lr=1e-3, weight_decay=1e-4):
    """AdamW (optax.adamw's defaults: betas 0.9/0.999, eps 1e-8) with the
    decay masked by ``_decay_mask``."""
    mask = _decay_mask(net)
    params = dict(net.named_parameters())
    groups = [
        {"params": [p for n, p in params.items() if mask[n]], "weight_decay": weight_decay},
        {"params": [p for n, p in params.items() if not mask[n]], "weight_decay": 0.0},
    ]
    return torch.optim.AdamW(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8)


@torch.no_grad()
def _ema_bn_stats(net: TuiNet, bn_stats, momentum=BN_MOMENTUM):
    """EMA the batch statistics into the running mean and var."""
    for blk, stats in zip(net.blocks, bn_stats):
        for key in ("bn1", "bn2"):
            bn, s = getattr(blk, key), stats[key]
            bn.mean.copy_(momentum * bn.mean + (1.0 - momentum) * s["mean"])
            bn.var.copy_(momentum * bn.var + (1.0 - momentum) * s["var"])


@torch.no_grad()
def _apply_constraint(net: TuiNet):
    """MagTransform v2's MinMaxNorm on mag_a (reference magtransformv2.py)."""
    net.mag_a.copy_(mag_transform_apply_constraint(net.mag_a))


def make_train_step(sr=48000, hop_length=640, bn_momentum=BN_MOMENTUM, mesh=None):
    """step(net, optimizer, pcm [B, samples], labels [B]) -> (loss,
    accuracy), 0-d tensors; updates `net` and `optimizer` in place and
    leaves the step's gradients in ``.grad``. Over a `mesh`, `pcm` and
    `labels` are this rank's rows, and the loss, accuracy and gradients
    are the global batch's."""
    from audio_analysis_torch.parallel.distributed import all_reduce_tensors
    from audio_analysis_torch.parallel.mesh import data_group

    group = data_group(mesh)

    def train_step(net, optimizer, pcm, labels):
        net.train()
        optimizer.zero_grad(set_to_none=True)
        loss, (acc, bn_stats) = loss_fn(net, pcm, labels, sr, hop_length, mesh)
        loss.backward()
        totals = torch.stack([loss.detach(), acc])
        if group is not None:
            all_reduce_tensors([p.grad for p in net.parameters()] + [totals], group)
        optimizer.step()
        _ema_bn_stats(net, bn_stats, momentum=bn_momentum)
        _apply_constraint(net)
        return totals[0], totals[1]

    return train_step


def build_train(cfg: TuiNetConfig, device=None, sr=48000, hop_length=640, lr=1e-3, seed=0,
                bn_momentum=BN_MOMENTUM, mesh=None):
    """(net, optimizer, step) on `device` (None: the card), or on this
    rank's device of `mesh` (then `device` stays None) with this rank's
    slice of the head (``shard_params``): the JAX package's
    ``build_sharded_train``. The net is drawn from
    ``torch.Generator().manual_seed(seed)``, the same on every rank."""
    net = TuiNet.init(cfg, torch.Generator().manual_seed(seed))
    if mesh is not None:
        from audio_analysis_torch.parallel.mesh import rank_device

        if device is not None:
            raise ValueError("pass a mesh or a device: the mesh decides the device")
        device = rank_device(mesh)
        net = shard_params(net, mesh)
    net = net.to(resolve_device(device)).train()
    optimizer = make_optimizer(net, lr)
    return net, optimizer, make_train_step(sr=sr, hop_length=hop_length,
                                           bn_momentum=bn_momentum, mesh=mesh)


# -- over a mesh ------------------------------------------------------------

# the TP plan (the JAX package's param_shardings): the dimension of each
# dense-head leaf that is split along 'model'; every other leaf replicates
HEAD_PLAN = {"head_w1": 1, "head_b1": 0, "head_w2": 0}


def shard_params(net: TuiNet, mesh):
    """Keep only this rank's slice of each ``HEAD_PLAN`` leaf, in place:
    the model index's contiguous block of ``dense_units``."""
    from audio_analysis_torch.parallel.mesh import model_index

    m, n = model_index(mesh), mesh.size(1)
    units = net.cfg.dense_units
    if units % n:
        raise ValueError(f"dense_units={units} not divisible by the mesh's model={n}")
    with torch.no_grad():
        for name, dim in HEAD_PLAN.items():
            full = getattr(net, name)
            setattr(net, name, nn.Parameter(full.narrow(dim, m * units // n, units // n).clone()))
    return net


def gather_head(named: dict, mesh) -> dict:
    """{name: numpy array} of `named` ({parameter name: tensor}, e.g. the
    parameters or their gradients), each ``HEAD_PLAN`` leaf gathered whole
    over 'model' (every rank of the mesh calls it; the collective runs on
    each; without a mesh, the leaves as they are)."""
    import torch.distributed as dist

    from audio_analysis_torch.parallel.mesh import model_group

    out = {n: t.detach().float().cpu().numpy() for n, t in named.items()}
    group = model_group(mesh)
    if group is not None:
        for name, dim in HEAD_PLAN.items():
            parts = [None] * mesh.size(1)
            dist.all_gather_object(parts, out[name], group=group)
            out[name] = np.concatenate(parts, axis=dim)
    return out


def full_jax_params(net: TuiNet, mesh) -> dict:
    """``net.to_jax_params()`` with the head gathered whole over 'model'
    (every rank of the mesh calls it)."""
    tree = net.to_jax_params()
    head = gather_head({n: getattr(net, n) for n in HEAD_PLAN}, mesh)
    tree["head"].update({n[len("head_"):]: a for n, a in head.items()})
    return tree
