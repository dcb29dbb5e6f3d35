"""Binary morphology with OpenCV's semantics (the JAX package's
ops/morphology.py; reference: src/identify_tracks.py:669-684).

- a (kh, kw) all-ones kernel anchored at (kh//2, kw//2): the window of
  output i covers inputs [i - k//2, i + k - 1 - k//2] on each axis, which
  is asymmetric for even k;
- borders are the operation's identity (erode pads 1, dilate pads 0).

Two forms of each operation over the last two axes:

- ``dilate``/``erode`` on float tensors of 0/1: the rectangle is separable,
  so each is a max-pool over rows then over columns. They are the plain
  version that the packed form is held to;
- ``packed_dilate``/``packed_erode`` on the mask packed into 32-bit words,
  most significant bit first (the JAX package's packed form, which
  detection runs): a k-wide window is a log2(k)-step doubling of shifts
  and OR/AND over words, at 1/32 of the float mask's bytes. Words are
  int32; torch's ``>>`` on int32 copies the sign bit, so every right shift
  is masked (``_srl``).
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


# -- packed-word binary morphology -------------------------------------------
#
# cv2 anchor semantics match dilate()/erode() above: window offsets
# [-(k//2), k-1-k//2]; shifted-in bits are the op identity (0 for dilate,
# 1 for erode: cv2's border-identity padding).


def _srl(u: torch.Tensor, b: int) -> torch.Tensor:
    """Logical right shift of int32 words by b (1..31)."""
    return (u >> b) & ((1 << (32 - b)) - 1)


def _fill(u: torch.Tensor, shape, fill_ones: bool) -> torch.Tensor:
    return torch.full(shape, -1 if fill_ones else 0, dtype=torch.int32, device=u.device)


def _shift_cols(u: torch.Tensor, d: int, fill_ones: bool) -> torch.Tensor:
    """S_d over bit columns of [..., R, W] int32 MSB-first words:
    out[col] = in[col - d] (either sign); shifted-in bits are `fill_ones`.
    Bits have no physical edge at W*32: callers mask pads."""
    if d == 0:
        return u
    w = u.shape[-1]
    q, b = divmod(abs(d), 32)

    def words_at(offset):  # word index j -> in word j - offset (fill outside)
        o = min(abs(offset), w)
        if o == 0:
            return u
        fill = _fill(u, u.shape[:-1] + (o,), fill_ones)
        if offset < 0:
            return torch.cat([u[..., o:], fill], -1)
        return torch.cat([fill, u[..., : w - o]], -1)

    if d > 0:
        base = words_at(q)
        if b == 0:
            return base
        return _srl(base, b) | (words_at(q + 1) << (32 - b))
    base = words_at(-q)
    if b == 0:
        return base
    return (base << b) | _srl(words_at(-q - 1), 32 - b)


def _shift_rows(u: torch.Tensor, d: int, fill_ones: bool) -> torch.Tensor:
    """S_d over the row axis (-2): out[r] = in[r - d], fill at the edges."""
    if d == 0:
        return u
    r = u.shape[-2]
    n = min(abs(d), r)
    pad = _fill(u, u.shape[:-2] + (n, u.shape[-1]), fill_ones)
    if d > 0:
        return torch.cat([pad, u[..., : r - n, :]], -2)
    return torch.cat([u[..., n:, :], pad], -2)


def _accumulate(u, k, shift, combine, fill_ones):
    """Suffix-window accumulation by doubling: y[i] = op(in[i-k+1 .. i]).
    Shifted-in values at the low edge are the op identity, which is what
    the accumulation over border indices is. The high edge is the
    caller's: it must pad before anchoring."""
    y, cover = u, 1
    while cover < k:
        step = min(cover, k - cover)
        y = combine(y, shift(y, step, fill_ones))
        cover += step
    return y


def _windowed_rows(u, k, combine, fill_ones):
    """op over the cv2-anchored row window [i-k//2, i+k-1-k//2]. The row
    axis is first padded by r = k-1-k//2 identity rows at the high end:
    anchoring a clamped-shift accumulation without the pad would read
    accumulated values past the end that were never computed."""
    if k <= 1:
        return u
    r = k - 1 - k // 2
    if r:
        u = torch.cat([u, _fill(u, u.shape[:-2] + (r, u.shape[-1]), fill_ones)], -2)
    y = _accumulate(u, k, _shift_rows, combine, fill_ones)
    return y[..., r:, :] if r else y


def _windowed_cols(u, k, combine, fill_ones):
    """Same over bit columns; the high end is padded by ceil(r/32) identity
    words, and the final anchor shift by -r happens on the padded array."""
    if k <= 1:
        return u
    r = k - 1 - k // 2
    w = u.shape[-1]
    p = -(-r // 32)
    if p:
        u = torch.cat([u, _fill(u, u.shape[:-1] + (p,), fill_ones)], -1)
    y = _accumulate(u, k, _shift_cols, combine, fill_ones)
    if r:
        y = _shift_cols(y, -r, fill_ones)
    return y[..., :w]


def packed_dilate(u: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """cv2.dilate on [..., R, W] packed int32 words (all-ones kh x kw).
    Pad bits beyond the logical width must be 0 (the dilate identity)."""
    u = _windowed_rows(u, kh, torch.bitwise_or, False)
    return _windowed_cols(u, kw, torch.bitwise_or, False)


def packed_erode(u: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """cv2.erode on packed words. Pad bits beyond the logical width must be
    set to 1 by the caller (they are inside the window of valid edge
    columns); the result's pad bits are unspecified: mask after."""
    u = _windowed_rows(u, kh, torch.bitwise_and, True)
    return _windowed_cols(u, kw, torch.bitwise_and, True)
