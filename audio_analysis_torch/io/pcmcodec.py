"""Lossless PCM wire codec (the JAX package's io/pcmcodec.py): the host packs
int16 recordings into per-block zigzag residuals at each block's own bit
width, the device unpacks and integrates them back. Decode is exact: bit for
bit the original samples.

The host half (``encode_pcm``, the native encoder ``native/pcmcodec.cpp``
and its numpy version, ``wire_bytes``, ``decode_pcm_np``) is the JAX
package's, unchanged, so an encode here is word for word the JAX package's.
The device half, ``decode_pcm``, is plain PyTorch in place of the JAX
package's jitted unpack, scatter and integrate programs: all tiers and
exceptions go to the device in one copy from one pinned buffer, each tier
unpacks with constant word indices and shifts (in int64: torch has no shifts
of uint32), scatters into a zigzag grid with one dummy row that the pad rows
target, the exceptions overwrite their samples, and ``order`` int32 cumsums
integrate the residuals.

Used by the single-recording path (``pipeline/classify.py``) and batch
serving (``pipeline/serve.py``) for int16 PCM when ``wire_codec_enabled()``.
"""

import os
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from audio_analysis_torch.device import to_device_async


def wire_codec_enabled():
    """AAT_WIRE_CODEC gates the lossless PCM wire codec: 0/off/false (any
    case) turn it off, any other value on, as in the JAX package.

    Unset, the codec is off on every device, where the JAX package turns it
    on when its native encoder loads (ROADMAP Queue 3). On an H100 80GB HBM3
    at 700 W (chip_smoke.py's upload phase) the native encode of an
    8 x 60 s batch takes 84 ms of host time and the decode 6.3 ms against a
    0.87 ms pinned copy of the raw int16 (wire ratio 0.656); the exact CLI's
    warm wall is 37.8 ms with it against 26.5 ms without, and a 24 x 60 s
    backlog runs at 2,534 against 5,179 audio-s/s. On the CPU no wire is
    crossed at all. The results are the same either way."""
    v = os.environ.get("AAT_WIRE_CODEC")
    return v is not None and v.lower() not in ("0", "off", "false")


BLOCK = 256  # samples per block; a width-w block is exactly (BLOCK/32)*w words.
# 256 measured 3.7% less wire than 512 on the bench batch (finer width
# adaptation beats the extra per-block position word); 128 reverses it
_WPB = BLOCK // 32  # words per block per bit of width
# Tier palette: exact block widths 0..20 (an order<=3 zigzag residual of
# int16 fits 20 bits; 32 is an unreachable defensive escape). Exact widths
# became affordable when decode moved to one small program per tier (see
# decode_pcm): a tier's compile profile is its own (width, rows-bucket)
# pair, so a free width range no longer multiplies a joint profile space.
# The old coarse palette (0,4,6,...,20,32) measured 2.7% extra wire on the
# bench batch. 0 = digital silence (implicit: scatter target starts zeroed).
_WIDTHS = tuple(range(21)) + (32,)


class EncodedPCM(NamedTuple):
    """Host-side encoded batch. `tiers` maps width -> (positions, words):
    positions int32 [n_padded] (block index into the [B*T/BLOCK] grid; pads
    point one past the end), words int32 [n_padded, BLOCK//32*w].

    `exceptions` is the patched-FOR stream: (flat_positions int32 [n_pad],
    zigzag_values int32 [n_pad]) for samples wider than their block's
    lowered width (pads aim at the decode grid's dummy row), or None. With
    exceptions a block's width is the words-cost argmin of
    8*w + 2*count(need > w), not the block max — outliers no longer inflate
    a whole block's width (bench batch: wire ratio 0.745 -> 0.722)."""

    shape: tuple  # (B, T) original int16 shape, T % BLOCK == 0 after pad
    n_valid: int  # T before padding (per row)
    order: int  # predictor order (0, 1, 2, or 3; 0 = verbatim zigzag —
    # optimal for noise-dominated content, where differencing near-white
    # noise doubles the variance and costs a whole bit per sample)
    tiers: dict
    exceptions: tuple = None


def _zigzag(r: np.ndarray) -> np.ndarray:
    return ((r << 1) ^ (r >> 31)).astype(np.uint32)


def _unzigzag_np(z: np.ndarray) -> np.ndarray:
    z = z.astype(np.uint32)
    return ((z >> 1).astype(np.int32)) ^ -(z & 1).astype(np.int32)


def _residual(x: np.ndarray, order: int) -> np.ndarray:
    """Order-k delta along axis=1 with per-row warmup samples kept raw."""
    r = x.astype(np.int32)
    for _ in range(order):
        r = np.concatenate([r[:, :1], np.diff(r, axis=1)], axis=1)
    return r


def _pack_words(z: np.ndarray, w: int) -> np.ndarray:
    """[n, BLOCK] uint32 values (each < 2**w) -> [n, _WPB*w] int32 words,
    MSB-first bitstream. np.packbits does the bit assembly in C; chunked to
    bound the transient bit matrix."""
    n = z.shape[0]
    out = np.empty((n, _WPB * w), np.uint32)
    shifts = (w - 1 - np.arange(w)).astype(np.uint32)
    step = max(1, (1 << 26) // (BLOCK * w))  # ~64MB transient per chunk
    for i in range(0, n, step):
        zi = z[i : i + step]
        bits = ((zi[:, :, None] >> shifts) & 1).astype(np.uint8)
        packed = np.packbits(bits.reshape(zi.shape[0], BLOCK * w), axis=-1)
        out[i : i + step] = (
            packed.view(">u4").astype(np.uint32).reshape(zi.shape[0], _WPB * w)
        )
    return out.view(np.int32)


def _bucket(n: int, row_bytes: int = 4) -> int:
    """Pad row counts to compile-friendly buckets: 1/16-octave steps
    (64, 128, ..., then p + k*p/16; <=6.25% pad waste, 16 shapes per
    octave), additionally capped so a tier's expected padding stays under
    ~128 kB of wire (`row_bytes` = bytes per padded row). Fine buckets are
    affordable because the decode runs as one small program PER TIER (see
    decode_pcm) — a tier's compile profile is its own (width, rows) alone,
    not the joint multiset across tiers, so profiles accumulate linearly.
    The original half-step buckets wasted 15-17% of the wire in padding on
    measured batches; the byte cap matters once pFOR concentrates most
    blocks into one bulk tier (an 83k-row width-11 tier padded 975 kB at
    1/16-octave granularity — more than the pFOR lowering saved)."""
    if n <= 64:
        return 64
    p = 1 << int(np.floor(np.log2(n)))
    step = max(64, p // 16)
    cap = (128 << 10) // max(1, row_bytes)
    if cap < step:
        step = max(64, 1 << int(np.floor(np.log2(cap))))
    return -(-n // step) * step


def _pfor_lower_np(z_blocks: np.ndarray, widths: np.ndarray):
    """Patched-FOR width lowering (numpy oracle; mirrors native pcm_pfor).

    z_blocks: [n_blocks, BLOCK] uint32 zigzag residuals; widths: the
    max-based block widths. Returns (lowered widths, flat exception
    positions int32, zigzag exception values uint32). Per block the lowered
    width minimizes 8*w + 2*count(need > w) wire words (an exception costs
    an int32 position + int32 value); ties prefer the LARGER width (fewer
    exceptions), matching the native top-down scan."""
    n_blocks = z_blocks.shape[0]
    need = np.zeros(z_blocks.shape, np.int32)
    nz = z_blocks > 0
    need[nz] = np.floor(np.log2(z_blocks[nz].astype(np.float64))).astype(np.int32) + 1
    n_w = 21  # candidate widths 0..20; 32-escape blocks are left alone
    idx = need.astype(np.int64) + np.arange(n_blocks, dtype=np.int64)[:, None] * n_w
    hist = np.bincount(idx.ravel(), minlength=n_blocks * n_w).reshape(n_blocks, n_w)
    # excgt[:, w] = #samples needing more than w bits
    excgt = np.zeros((n_blocks, n_w), np.int64)
    excgt[:, :-1] = hist[:, ::-1].cumsum(axis=1)[:, ::-1][:, 1:]
    cost = 8 * np.arange(n_w, dtype=np.int64)[None, :] + 2 * excgt
    # ties -> larger width: argmin over the reversed axis finds the
    # largest-w minimum (costs above the max-based width are strictly
    # larger, so the pick never exceeds it)
    wsel = (n_w - 1) - cost[:, ::-1].argmin(axis=1)
    keep = (widths == 0) | (widths > 20)  # silence / defensive escape
    wsel = np.where(keep, widths.astype(np.int64), wsel)
    exc_mask = need > wsel[:, None].astype(np.int32)
    blk, off = np.nonzero(exc_mask)  # block-major = native emit order
    positions = (blk * BLOCK + off).astype(np.int32)
    values = z_blocks[exc_mask]
    return wsel.astype(widths.dtype), positions, values


def _pad_exceptions(positions, values, n_blocks):
    """Bucket-pad the exception stream; pads write 0 into the decode grid's
    dummy row (flat position n_blocks*BLOCK). Returns None when empty."""
    n = len(positions)
    if n == 0:
        return None
    npad = _bucket(n, row_bytes=8)
    pos = np.full(npad, n_blocks * BLOCK, np.int32)
    val = np.zeros(npad, np.uint32)
    pos[:n] = positions
    val[:n] = values
    return pos, val.view(np.int32)


def encode_pcm(x: np.ndarray, order: int = None) -> EncodedPCM:
    """Encode an int16 [B, T] (or [T]) batch for the wire. Lossless.

    Uses the native (C++) single-pass encoder when available — the numpy
    path below is the behaviour-identical fallback (and the layout oracle
    in tests), but it is ~50x slower on the single-core serving hosts."""
    if x.ndim == 1:
        x = x[None, :]
    assert x.dtype == np.int16, x.dtype
    b, t = x.shape
    n_valid = t
    if t % BLOCK:
        pad = BLOCK - t % BLOCK
        x = np.pad(x, ((0, 0), (0, pad)))
        t += pad

    from audio_analysis_torch.native import load_pcmcodec_library

    lib = load_pcmcodec_library()
    if lib is not None:
        return _encode_native(lib, x, b, t, n_valid, order)

    def tiers_for(o):
        r = _residual(x, o)
        z = _zigzag(r).reshape(-1, BLOCK)  # [n_blocks, BLOCK]
        mx = z.max(axis=1)
        need = np.zeros(len(mx), np.int32)
        nz = mx > 0
        need[nz] = np.floor(np.log2(mx[nz].astype(np.float64))).astype(np.int32) + 1
        widths = np.asarray(_WIDTHS, np.int32)
        tier = widths[np.searchsorted(widths, need)]
        total_words = int(sum((tier[tier == w].size * _WPB * w) for w in _WIDTHS))
        return z, tier, total_words

    if order is None:
        # order choice predates the pFOR lowering (max-based totals, same
        # rule as the native encoder) — lowering then optimizes widths
        # within the chosen order only
        best = None
        for o in (0, 1, 2, 3):
            z, tier, words = tiers_for(o)
            if best is None or words < best[3]:
                best = (o, z, tier, words)
        order, z, tier, _ = best
    else:
        z, tier, _ = tiers_for(order)

    n_blocks = z.shape[0]
    tier, exc_pos, exc_val = _pfor_lower_np(z, tier)
    exceptions = _pad_exceptions(exc_pos, exc_val, n_blocks)
    tiers = {}
    for w in _WIDTHS:
        idx = np.nonzero(tier == w)[0].astype(np.int32)
        if idx.size == 0 or w == 0:
            # width-0 blocks (digital silence) are implicit: scatter target
            # starts zeroed
            continue
        npad = _bucket(idx.size, row_bytes=_WPB * w * 4 + 4)
        positions = np.full(npad, n_blocks, np.int32)  # pad -> dummy row
        positions[: idx.size] = idx
        words = _pack_words(z[idx] & np.uint32((1 << w) - 1), w)
        words = np.pad(words, ((0, npad - idx.size), (0, 0)))
        tiers[w] = (positions, words)
    return EncodedPCM((b, t), n_valid, order, tiers, exceptions)


def _encode_native(lib, x, b, t, n_valid, order) -> EncodedPCM:
    x = np.ascontiguousarray(x)
    n_blocks = (b * t) // BLOCK
    widths4 = np.empty((4, n_blocks), np.uint8)
    lib.widths(x, b, t, widths4)
    if order is None:
        totals = [int(widths4[o].astype(np.int64).sum()) for o in range(4)]
        order = int(np.argmin(totals))
    w_chosen = widths4[order]

    # patched-FOR: lower block widths in place; pcm_pack below emits the
    # exception (position, value) pairs while it packs (it already touches
    # every sample) — pfor only sizes the buffers and gates w==0 blocks
    exc_counts = np.empty(n_blocks, np.int32)
    n_exc = int(lib.pfor(x, b, t, order, w_chosen, exc_counts))
    npad_exc = _bucket(n_exc, row_bytes=8) if n_exc else 1
    exc_pos = np.full(npad_exc, n_blocks * BLOCK, np.int32)  # pads -> dummy
    exc_val = np.zeros(npad_exc, np.uint32)

    # The packer writes each block straight into its padded tier slot
    # (tier-major layout), so the per-width word matrices are zero-copy
    # views of one buffer — no post-pack gather (the single-core hosts
    # can't afford one).
    present = [int(w) for w in np.unique(w_chosen) if w != 0]
    tier_rank = np.argsort(w_chosen, kind="stable")  # tier-major block order
    counts = np.bincount(w_chosen, minlength=33)
    segments = {}  # w -> (positions int32 [npad], start_word, npad)
    flat_words = 0
    for w in present:
        n_w = int(counts[w])
        npad = _bucket(n_w, row_bytes=_WPB * w * 4 + 4)
        lo = int(np.searchsorted(w_chosen[tier_rank], w))
        idx = tier_rank[lo : lo + n_w].astype(np.int32)
        positions = np.full(npad, n_blocks, np.int32)
        positions[:n_w] = idx
        segments[w] = (positions, flat_words, npad, idx)
        flat_words += npad * _WPB * w

    flat = np.zeros(flat_words, np.uint32)  # pad rows stay zero
    dest = np.zeros(n_blocks, np.int64)
    for w in present:
        positions, start_word, npad, idx = segments[w]
        n_w = len(idx)
        dest[idx] = start_word + np.arange(n_w, dtype=np.int64) * (_WPB * w)
    n_written = int(
        lib.pack(
            x, b, t, order, np.ascontiguousarray(w_chosen), dest, flat,
            exc_counts, exc_pos, exc_val,
        )
    )
    assert n_written == n_exc, (n_written, n_exc)
    exceptions = (exc_pos, exc_val.view(np.int32)) if n_exc else None

    tiers = {}
    for w in present:
        positions, start_word, npad, _ = segments[w]
        words = flat[start_word : start_word + npad * _WPB * w].reshape(npad, _WPB * w)
        tiers[w] = (positions, words.view(np.int32))
    return EncodedPCM((b, t), n_valid, order, tiers, exceptions)


def wire_bytes(enc: EncodedPCM) -> int:
    """Bytes this encoding puts on the wire (padded tiers included)."""
    n = sum(p.nbytes + w.nbytes for p, w in enc.tiers.values())
    if enc.exceptions is not None:
        n += enc.exceptions[0].nbytes + enc.exceptions[1].nbytes
    return n


@lru_cache(maxsize=32)
def _unpack_plan(w: int):
    """Compile-time constants for width-w unpacking: for sample j in a
    block, its bits live in words wi[j] (and wi[j]+1 when straddling)."""
    j = np.arange(BLOCK, dtype=np.int64)
    start = j * w
    wi = (start // 32).astype(np.int32)
    off = (start % 32).astype(np.int32)
    return wi, off


_U32 = 0xFFFFFFFF


@lru_cache(maxsize=64)
def _unpack_index(w: int, device: torch.device):
    """``_unpack_plan(w)`` on `device`, int64: each sample's first word, the
    word after it (clamped to the appended zero word) and its bit offset.
    Cached, so a decode copies no index to the device."""
    wi, off = _unpack_plan(w)
    return tuple(torch.from_numpy(a.astype(np.int64)).to(device)
                 for a in (wi, np.minimum(wi + 1, _WPB * w), off))


def _unpack_words(words: torch.Tensor, w: int) -> torch.Tensor:
    """[n, _WPB*w] int32 words -> [n, BLOCK] int64 zigzag values (< 2**32,
    width w), the JAX ``_unpack_words`` with each uint32 held in an int64."""
    wi, wi1, off = _unpack_index(w, words.device)
    u = words.to(torch.int64) & _U32
    # append a zero word so wi+1 never reads out of bounds (a width-0
    # tier's one word is that zero)
    u = torch.cat([u, u.new_zeros((u.shape[0], 1))], dim=1)
    w0, w1 = u[:, wi], u[:, wi1]
    # value = w bits starting at off within (w0:w1), MSB-first; w = 0 shifts
    # the 32-bit word right by 32, which leaves 0 as the JAX uint32 shift does
    hi = ((w0 << off) & _U32) >> (32 - w)
    spill = off + w > 32  # bits continuing into w1
    lo = torch.where(spill, w1 >> torch.where(spill, 64 - w - off, 0), 0)
    return hi | lo


def decode_pcm(enc: EncodedPCM, device) -> torch.Tensor:
    """Decode on `device` -> int16 [B, T_padded]. Slice [:, :enc.n_valid]
    for the original samples.

    Every tier's positions and words and the exceptions go to the device in
    one copy of one (pinned, for a CUDA device) int32 buffer."""
    device = torch.device(device)
    b, t = enc.shape
    n_blocks = (b * t) // BLOCK
    tiers = sorted(enc.tiers)
    parts = [a for w in tiers for a in enc.tiers[w]]
    if enc.exceptions is not None:
        parts += list(enc.exceptions)
    sizes = [a.size for a in parts]
    host = torch.empty(sum(sizes), dtype=torch.int32, pin_memory=device.type == "cuda")
    flat = host.numpy()
    o = 0
    for a, n in zip(parts, sizes):
        flat[o : o + n] = a.reshape(-1).view(np.int32)
        o += n
    buf = to_device_async(host, device)
    views, o = [], 0
    for a, n in zip(parts, sizes):
        views.append(buf[o : o + n].view(a.shape))
        o += n
    # +1 dummy row: every pad row of a tier and every pad exception lands there
    z = torch.zeros((n_blocks + 1) * BLOCK, dtype=torch.int64, device=device)
    grid = z.view(n_blocks + 1, BLOCK)
    for i, w in enumerate(tiers):
        positions, words = views[2 * i], views[2 * i + 1]
        grid[positions.to(torch.int64)] = _unpack_words(words, w)
    if enc.exceptions is not None:
        positions, values = views[-2], views[-1]
        z[positions.to(torch.int64)] = values.to(torch.int64) & _U32
    z = z[: n_blocks * BLOCK].view(b, t)
    r = ((z >> 1) ^ -(z & 1)).to(torch.int32)
    for _ in range(enc.order):
        r = torch.cumsum(r, dim=1, dtype=torch.int32)
    return r.to(torch.int16)


def upload_pcm_encoded(x, enc: EncodedPCM, device) -> torch.Tensor:
    """Device half of ``upload_pcm`` for a pre-computed encode of the int16
    [B, T] `x` (numpy, or a host tensor; a pinned one is copied without
    staging): ``decode_pcm(enc, device)``, or the raw BLOCK-padded samples
    when the encoding would put at least as many bytes on the wire as the
    samples themselves (incompressible content), as in the JAX package."""
    if wire_bytes(enc) >= x.nbytes:
        x = torch.as_tensor(x)
        pad = (-x.shape[1]) % BLOCK
        if pad:
            x = torch.nn.functional.pad(x, (0, pad))
        return to_device_async(x, device)
    return decode_pcm(enc, device)


def upload_pcm(x: np.ndarray, device) -> torch.Tensor:
    """Encode, copy and decode an int16 [B, T] (or [T]) batch -> int16
    [B, T_padded] on `device` (see ``upload_pcm_encoded`` for the raw
    rule)."""
    if x.ndim == 1:
        x = x[None, :]
    return upload_pcm_encoded(x, encode_pcm(x), device)


def decode_pcm_np(enc: EncodedPCM) -> np.ndarray:
    """Pure-numpy reference decode (tests / hosts without a device)."""
    b, t = enc.shape
    n_blocks = (b * t) // BLOCK
    z = np.zeros((n_blocks + 1, BLOCK), np.uint32)
    for w, (positions, words) in enc.tiers.items():
        wi, off = _unpack_plan(w)
        u = np.concatenate(
            [words.view(np.uint32), np.zeros((words.shape[0], 1), np.uint32)],
            axis=1,
        )
        w0 = u[:, wi]
        w1 = u[:, wi + 1]
        offj = off.astype(np.uint32)[None, :]
        hi = (w0 << offj) >> np.uint32(32 - w)
        spill = offj + np.uint32(w) > 32
        lo_shift = np.where(spill, (np.uint32(64 - w) - offj), np.uint32(0))
        lo = np.where(spill, w1 >> lo_shift, np.uint32(0))
        z[positions] = hi | lo
    if enc.exceptions is not None:
        pos, val = enc.exceptions
        z.reshape(-1)[pos] = val.view(np.uint32)
    z = z[:-1]
    r = _unzigzag_np(z).reshape(b, t)
    for _ in range(enc.order):
        r = np.cumsum(r, axis=1, dtype=np.int32)
    return r.astype(np.int16)
