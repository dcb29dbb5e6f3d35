"""dB conversion and min-max normalisation (the JAX package's ops/scale.py).

``power_to_db`` is librosa's ``power_to_db(ref=np.max)``, with the reference
taken per window over ``ref_axes`` so a whole window grid scales in one op
(the reference calls librosa once per window, src/identify_tracks.py:266).
"""

import torch


def _amax(x, dims):
    return x.max() if dims is None else x.amax(dim=dims, keepdim=True)


def power_to_db(S: torch.Tensor, ref_axes=None, amin: float = 1e-10,
                top_db: float = 80.0) -> torch.Tensor:
    """10*log10(S) referenced to the max of S over `ref_axes` (whole array
    when None)."""
    ref = _amax(S, ref_axes)
    log_spec = 10.0 * torch.log10(torch.clamp(S, min=amin))
    log_spec = log_spec - 10.0 * torch.log10(torch.clamp(ref, min=amin))
    if top_db is not None:
        peak = _amax(log_spec, ref_axes)
        log_spec = torch.maximum(log_spec, peak - top_db)
    return log_spec


def normalize_minmax(x: torch.Tensor) -> torch.Tensor:
    """Min-max normalise along the last axis to about [-1, 1].

    The reference's ``normalize_data`` (src/identify_tracks.py:202-209) with
    its quirks: the 1e-6 epsilon is added AFTER the division (an all-zero
    window gives NaN there and here alike), then ``(x - 0.5) * 2``."""
    x = x - x.amin(dim=-1, keepdim=True)
    x = x / x.amax(dim=-1, keepdim=True) + 0.000001
    x = x - 0.5
    return x * 2.0
