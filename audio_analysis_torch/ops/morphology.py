"""Binary morphology with OpenCV's semantics (the JAX package's
ops/morphology.py; reference: src/identify_tracks.py:669-684).

- a (kh, kw) all-ones kernel anchored at (kh//2, kw//2): the window of
  output i covers inputs [i - k//2, i + k - 1 - k//2] on each axis, which
  is asymmetric for even k;
- borders are the operation's identity (erode pads 1, dilate pads 0).

Masks are float tensors of 0/1 over the last two axes; the rectangle is
separable, so each operation is a max-pool over rows then over columns.
"""

import torch
import torch.nn.functional as F


def _max1d(x: torch.Tensor, k: int, dim: int, fill: float) -> torch.Tensor:
    if k <= 1:
        return x
    lead, trail = k // 2, k - 1 - k // 2
    x4 = x.reshape((-1, 1) + x.shape[-2:])
    if dim == -1:
        x4 = F.pad(x4, (lead, trail), value=fill)
        y = F.max_pool2d(x4, (1, k), stride=1)
    else:
        x4 = F.pad(x4, (0, 0, lead, trail), value=fill)
        y = F.max_pool2d(x4, (k, 1), stride=1)
    return y.reshape(x.shape)


def dilate(x: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """cv2.dilate with an all-ones (kh, kw) kernel over the last two axes."""
    return _max1d(_max1d(x, kh, -2, 0.0), kw, -1, 0.0)


def erode(x: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """cv2.erode with an all-ones (kh, kw) kernel over the last two axes."""
    return 1.0 - dilate(1.0 - x, kh, kw)
