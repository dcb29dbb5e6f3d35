"""The host-side planning of the direct bf16 route (``csrc/stft_bf16.cu``,
``stft_mel_bf16_kernel``) on the CPU: the frame classes and their copies,
the tiles and the scratch they need, the shared memory a block takes, and a numpy transcription
of the pre-pass and of the tensor-map boxes that fetch each tile's frames,
held against the framed windows the plain version reads.

The kernel itself is held against ``stft_mel_bf16_plain`` on a GPU in
tests/test_torch_kernels.py."""

import math

import numpy as np
import pytest
import torch

from audio_analysis_torch.ops import melspec as ms

HOPS = [640, 644, 642, 641, 281, 125, 256, 100, 160, 1]


@pytest.mark.parametrize("hop", HOPS)
def test_classes_align_every_frame(hop):
    """P = 8 / gcd(hop, 8): frame t starts 16-byte aligned in copy (t hop %
    8) / gcd(hop, 8) < P, and a class's frames lie P hop samples apart, a
    whole number of 16-byte steps (a tensor map's stride)."""
    p = ms.direct_classes(hop)
    g = math.gcd(hop, 8)
    assert p == 8 // g and p in (1, 2, 4, 8)
    assert (p * hop * 2) % 16 == 0
    for t in range(64):
        sh = t * hop % 8
        assert sh % g == 0 and sh // g < p
        assert (t * hop - sh) % 8 == 0
        assert (t * hop) % 8 == ((t % p) * hop) % 8  # a class shares its copy


def test_direct_smem_fits_the_card():
    """Every mel capacity fits one block's shared memory on an H100, with
    the ring of 4 stages of 32 KB and two mel tiles."""
    for rows in ms.BF16_MEL_ROWS:
        got = ms.direct_smem(rows)
        assert got == 1024 + 4 * 32768 + 2 * rows * 128 + 8 * 12
        assert got <= ms.SMEM_OPTIN_H100
    assert ms.DIRECT_STAGES == 4 and ms.DIRECT_FRAMES == 128


# (n_out, n_fft, hop, n_tiles, lrow): the n_fft-4410 classify grid (one
# class, hop 640), the batch end-scan under AAT_PALLAS_ALG=matmul (hop 281:
# eight classes; the scratch is 8 bf16 copies of each 2.88M-sample window,
# 8 x 8 x 2,881,960 x 2 bytes, ~369 MB for the batch), n_fft 500 at hop
# 125 (eight classes), an odd hop on the classify grid
TILES = [
    (226, 4410, 640, 2, 167616),
    (10200, 4800, 281, 10, 2881960),
    (129, 500, 125, 1, 128376),
    (226, 4410, 641, 1, 660160),
]


@pytest.mark.parametrize("n_out,n_fft,hop,n_tiles,lrow", TILES)
def test_direct_tiles_shapes(n_out, n_fft, hop, n_tiles, lrow):
    assert ms.direct_tiles(n_out, n_fft, hop) == (n_tiles, lrow)
    assert lrow % 8 == 0
    assert lrow >= ((ms.direct_classes(hop) * n_tiles * ms.DIRECT_FRAMES - 1) * hop + n_fft)


def _item_frames(n_windows, n_out, hop, n_tiles):
    """The kernel's direct_item and row -> frame mapping: {item: (w, [frame
    of each of the 128 rows])}."""
    p = ms.direct_classes(hop)
    out = {}
    for item in range(n_windows * p * n_tiles):
        w, rem = divmod(item, p * n_tiles)
        v, i = divmod(rem, n_tiles)
        u0 = i * ms.DIRECT_FRAMES
        out[item] = (w, [v + p * (u0 + r) for r in range(ms.DIRECT_FRAMES)])
    return out


@pytest.mark.parametrize("n_out,hop", [(226, 640), (226, 641), (129, 125), (1300, 281),
                                       (300, 644), (300, 642), (1, 281), (128, 640)])
def test_tiles_cover_each_frame_once(n_out, hop):
    """The items' rows hold each frame below n_out exactly once per
    window, and every frame a tile holds (those past n_out too, whose rows
    are not stored) lies in the copy's row of lrow samples."""
    n_fft = 4410
    tiles, lrow = ms.direct_tiles(n_out, n_fft, hop)
    seen = {}
    for w, frames in _item_frames(2, n_out, hop, tiles).values():
        for t in frames:
            assert t * hop + n_fft <= lrow
            if t < n_out:
                seen[(w, t)] = seen.get((w, t), 0) + 1
    assert seen == {(w, t): 1 for w in range(2) for t in range(n_out)}


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("n_fft,hop,frames", [(500, 125, None), (4410, 640, None),
                                              (4099, 281, None), (600, 642, 12), (300, 33, 90)])
def test_tensor_map_boxes_read_the_frames(rng, n_fft, hop, frames):
    """A transcription of the pre-pass (copy c of a window: n_fft/2 zeros,
    the bf16 samples, zeros, shifted left by c gcd(hop, 8)) and of the
    frames' 4-D tensor map (samples < n_fft, 8-sample blocks, a class's
    frames P hop apart, copy rows) at the box coordinates the producer
    computes: every row of every tile whose frame is below n_out holds that
    frame's n_fft bf16 samples, zero past n_fft, exactly as the plain
    version frames the window."""
    n_windows, s = 2, 9000
    x = rng.randn(n_windows, s).astype(np.float32)
    n_out = frames or 1 + s // hop
    p = ms.direct_classes(hop)
    shift = math.gcd(hop, 8)
    tiles, lrow = ms.direct_tiles(n_out, n_fft, hop)
    half = n_fft // 2
    lfill = -(-((n_out - 1) * hop + n_fft) // 8) * 8
    xb = np.full((n_windows * p, lrow), np.nan, np.float32)  # past lfill: never stored
    for row in range(n_windows * p):
        w, cp = divmod(row, p)
        j = np.arange(lfill) + cp * shift - half
        ok = (j >= 0) & (j < s)
        xb[row, :lfill] = np.where(ok, _bf16(x[w])[np.clip(j, 0, s - 1)], 0.0)
    flat = np.concatenate([xb.ravel(), np.full(lrow, np.nan, np.float32)])

    def box(k0, b, row):
        """TMA box {64, 1, 128, 1} at (k0, b, 0, row): sample k of the
        u-th frame is element row lrow + 8 b + u P hop + k, zero for k >=
        n_fft."""
        k = k0 + np.arange(ms.BF16_K_STEP)
        u = np.arange(ms.DIRECT_FRAMES)[:, None]
        idx = row * lrow + 8 * b + u * p * hop + k[None]
        return np.where(k[None] < n_fft, flat[np.minimum(idx, len(flat) - 1)], 0.0)

    padded = np.pad(_bf16(x), ((0, 0), (half, n_fft - half)))
    k_pad = -(-n_fft // ms.BF16_K_STEP) * ms.BF16_K_STEP
    for w, fr in _item_frames(n_windows, n_out, hop, tiles).values():
        e = fr[0] * hop  # row 0: the tile's first frame
        sh = e % 8
        tile = np.zeros((ms.DIRECT_FRAMES, k_pad), np.float32)
        for k0 in range(0, k_pad, ms.BF16_K_STEP):
            tile[:, k0:k0 + ms.BF16_K_STEP] = box(k0, (e - sh) // 8, w * p + sh // shift)
        for r, t in enumerate(fr):
            if t < n_out:
                want = np.zeros(k_pad, np.float32)
                want[:n_fft] = padded[w, t * hop:t * hop + n_fft]
                np.testing.assert_array_equal(tile[r], want)
