"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
GPU present, asking for ``cuda`` (the default) raises instead of quietly
running on the CPU.

TF32 is switched off for both matmuls and cuDNN convolutions: the detection
mask flips bits at relative errors of about 5e-5 (the JAX package's
CLAUDE.md, "Mag exact1-vs-exact2 MEASURED OUT"), and TF32 keeps only about
three decimal digits, so every float32 product here stays full float32.

``to_device_async`` and ``to_host_async`` copy between the host and the card
without waiting for the card's queue, through pinned host memory;
``device_consts`` keeps host-built constants on a device once.
"""

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``. Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: --device cpu) "
            "to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    return dev


def to_device_async(x: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on ``device`` without waiting for the device's queue (a
    pageable copy to a CUDA device waits for the queue to drain): a CUDA
    copy is staged in pinned memory and queued. Pass a pinned ``x`` to skip
    the staging copy."""
    device = torch.device(device)
    if device.type != "cuda":
        return x.to(device)
    if not x.is_pinned():
        x = x.pin_memory()
    return x.to(device, non_blocking=True)


def to_host_async(x: torch.Tensor) -> torch.Tensor:
    """A device tensor's copy to pinned host memory, queued; valid once the
    device has passed the copy (wait on an event recorded after it)."""
    if x.device.type != "cuda":
        return x
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return out.copy_(x, non_blocking=True)


_DEVICE_CONSTS = {}


def device_consts(key, build, device, dtype=None):
    """Host-built constants (``build()``: a sequence of numpy arrays),
    uploaded once per device and `key` (converted to `dtype` on the host
    first, when given)."""
    k = (key, str(device))
    got = _DEVICE_CONSTS.get(k)
    if got is None:
        got = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dtype).to(device)
                    for a in build())
        _DEVICE_CONSTS[k] = got
    return got
