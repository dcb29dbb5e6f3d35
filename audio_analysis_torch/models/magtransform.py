"""MagTransform: learnable magnitude compression ``y = x ** sigmoid(a)``
(the JAX package's models/magtransform.py; reference src/magtransform.py:9-19,
src/magtransformv2.py:8-21)."""

import torch


def mag_transform(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """x ** sigmoid(a); `a` is a scalar (v1) or shape-[1] (v2) parameter."""
    return torch.pow(x, torch.sigmoid(a))
