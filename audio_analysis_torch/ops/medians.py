"""Exact masked medians of a non-negative [B, bins, T] spectrogram.

``row_medians`` replaces the Pallas kernel
``ops/pallas/medians.py::_kernel_row_medians`` and ``col_medians`` replaces
``_kernel_col_medians`` (CUDA source: ``csrc/medians.cu``): the kernels run
the same 31-step rank search on int32 bit patterns with an upper-middle
successor pass, so they are bit-identical to ``np.median``. Each wrapper
launches its kernel for a CUDA tensor and uses the plain PyTorch version
(a sort) for a CPU tensor, and counts its launches in ``.launches``.
``torch.median`` is not a substitute: it returns the lower middle value.
"""

import torch

from audio_analysis_torch.ops import cuda


def _median_sorted(x, n_valid, dim):
    """np.median along `dim` over the first n_valid entries; `x` holds +inf
    in the others (they sort last). n_valid broadcasts against the result."""
    s = torch.sort(x, dim=dim).values
    shape = list(x.shape)
    shape[dim] = 1
    n_valid = torch.as_tensor(n_valid, device=x.device).expand(shape)
    lo = torch.gather(s, dim, (n_valid - 1) // 2)
    up = torch.gather(s, dim, n_valid // 2)
    return (lo + up) * 0.5


def row_medians_plain(spec, nvf):
    """[B, bins, T], nvf [B] -> [B, bins, 1]: rows over their first nvf[b]
    columns."""
    b, bins, t = spec.shape
    nvf = torch.as_tensor(nvf, device=spec.device).to(torch.int64).reshape(b, 1, 1)
    valid = torch.arange(t, device=spec.device)[None, None, :] < nvf
    x = torch.where(valid, spec, torch.full((), float("inf"), device=spec.device))
    return _median_sorted(x, nvf, -1)


def col_medians_plain(spec):
    """[B, bins, T] -> [B, 1, T]: columns over all rows."""
    return _median_sorted(spec, spec.shape[-2], -2)


def row_medians(spec, nvf):
    """np.median of each row of the [B, bins, T] float32 batch (>= 0) over
    the first nvf[b] columns -> [B, bins, 1]."""
    if spec.device.type == "cpu":
        return row_medians_plain(spec, nvf)
    cuda.require_cuda(spec, "row_medians")
    b, bins, t = spec.shape
    nvf = torch.as_tensor(nvf, device=spec.device).to(torch.int32).reshape(b).contiguous()
    out = torch.empty((b, bins, 1), dtype=torch.float32, device=spec.device)
    rc = cuda.library().aat_row_medians(
        spec.data_ptr(), nvf.data_ptr(), out.data_ptr(), b, bins, t, cuda.stream_of(spec)
    )
    cuda.check(rc, "row_medians")
    row_medians.launches += 1
    return out


row_medians.launches = 0


def col_medians(spec):
    """np.median of each column of the [B, bins, T] float32 batch (>= 0)
    over all rows -> [B, 1, T]."""
    if spec.device.type == "cpu":
        return col_medians_plain(spec)
    cuda.require_cuda(spec, "col_medians")
    b, bins, t = spec.shape
    out = torch.empty((b, 1, t), dtype=torch.float32, device=spec.device)
    rc = cuda.library().aat_col_medians(
        spec.data_ptr(), out.data_ptr(), b, bins, t, cuda.stream_of(spec)
    )
    cuda.check(rc, "col_medians")
    col_medians.launches += 1
    return out


col_medians.launches = 0


def masked_medians_rowcol(spec, nvf):
    """(row [B, bins, 1], col [B, 1, T]) medians, as the JAX package's
    ``pallas_masked_medians_rowcol``; column entries past nvf are computed
    over their (unmasked) values, and callers mask them."""
    return row_medians(spec, nvf), col_medians(spec)
