"""MagTransform: learnable magnitude compression ``y = x ** sigmoid(a)``
(the JAX package's models/magtransform.py; reference src/magtransform.py:9-19,
src/magtransformv2.py:8-21)."""

import torch


def mag_transform(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """x ** sigmoid(a); `a` is a scalar (v1) or shape-[1] (v2) parameter."""
    return torch.pow(x, torch.sigmoid(a))


def mag_transform_apply_constraint(a: torch.Tensor, min_value=-2.0, max_value=1.0) -> torch.Tensor:
    """Keras MinMaxNorm (v2's train-time constraint): w * (clip(norm) /
    (eps + norm)) along the last axis, eps 1e-7."""
    norms = torch.sqrt(torch.sum(torch.square(a), dim=-1, keepdim=True))
    desired = torch.clamp(norms, min_value, max_value)
    return a * (desired / (1e-7 + norms))
