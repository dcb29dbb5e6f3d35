"""Training for the native classifier (the JAX package's parallel/train.py,
on one device).

One step: the frontend over the PCM windows at the classify settings (the
``stft_mel`` kernel at the exact level, ``stft_mel_bf16`` under AAT_FAST),
TuiNet's training forward (BatchNorm on the batch's statistics), log-softmax
NLL, backward, AdamW with the weight decay on the conv and dense kernels
only, the batch statistics' EMA into the running mean and variance (Keras
momentum 0.99), and MagTransform v2's constraint on ``mag_a``.
"""

import torch

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


def loss_fn(net: TuiNet, pcm, labels, sr: int, hop_length: int):
    """(nll, (accuracy, batch statistics)) of one batch; `net` in train
    mode normalises with the batch statistics."""
    feats = features(pcm, net.cfg.n_mels, sr, hop_length)
    logits, bn_stats = net(feats, with_stats=True)
    labels = labels.long()
    nll = -torch.log_softmax(logits, dim=1).gather(1, labels[:, None]).mean()
    acc = (logits.argmax(dim=1) == labels).float().mean()
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


def make_train_step(sr=48000, hop_length=640, bn_momentum=BN_MOMENTUM):
    """step(net, optimizer, pcm [B, samples], labels [B]) -> (loss,
    accuracy), 0-d tensors; updates `net` and `optimizer` in place."""

    def train_step(net, optimizer, pcm, labels):
        net.train()
        optimizer.zero_grad(set_to_none=True)
        loss, (acc, bn_stats) = loss_fn(net, pcm, labels, sr, hop_length)
        loss.backward()
        optimizer.step()
        _ema_bn_stats(net, bn_stats, momentum=bn_momentum)
        _apply_constraint(net)
        return loss.detach(), acc

    return train_step


def build_train(cfg: TuiNetConfig, device=None, sr=48000, hop_length=640, lr=1e-3, seed=0,
                bn_momentum=BN_MOMENTUM):
    """(net, optimizer, step) on `device` (None: the card), the net drawn
    from ``torch.Generator().manual_seed(seed)``. The single-device
    counterpart of the JAX package's ``build_sharded_train``."""
    dev = resolve_device(device)
    net = TuiNet.init(cfg, torch.Generator().manual_seed(seed)).to(dev).train()
    optimizer = make_optimizer(net, lr)
    return net, optimizer, make_train_step(sr=sr, hop_length=hop_length, bn_momentum=bn_momentum)
