"""The dif route of the port's fast DFT -> mel (``stft_mel_bf16``, CUDA
source ``csrc/stft_bf16.cu``) and the row medians' radix select
(``csrc/medians.cu``), checked on the CPU:

- the dif route's plain version against the JAX package's
  ``_melspec_core_dif`` at exact=0 (Pallas interpret mode) and a float64
  oracle, and its constants against the JAX package's;
- the route choice (``bf16_route``, the JAX package's ``_use_dif``);
- a numpy transcription of the dif kernel (its span staging, group and
  split order, twiddle indexing, leaf offsets and padded leaf width)
  against the plain version and ``np.fft.rfft``;
- a numpy transcription of the row kernel's radix select against
  ``np.median`` on adversarial rows.

The kernels themselves run only on a GPU (``tests/test_torch_kernels.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_analysis_tpu.ops.pallas import melspec as jm
from audio_analysis_tpu.ops.windows import get_window_np

from audio_analysis_torch.ops import medians as md
from audio_analysis_torch.ops import melspec as ms
from audio_analysis_torch.ops.mel import mel_support_bins

# (sr, n_fft, hop, n_mels, fmin, fmax, samples, htk, power): n_fft 512 at
# 16 kHz (3 levels), Slaney, the end-scan's geometry on a short signal
# (n_fft 4800, 120 mels, power 1: 4 levels), the classify geometry, and a
# window of 338 frames (above the JAX package's 320-frame cap), and n_fft
# 2056 over the whole band (3 levels only, as 2056 % 16 != 0: 129 bins a
# leaf, two bin tiles of 128, leaves of 257 points padded to 272)
DIF_CASES = {
    "nfft512-p2": (16000, 512, 160, 40, 50.0, 7000.0, 4000, True, 2.0),
    "nfft512-p1": (16000, 512, 160, 40, 50.0, 7000.0, 4000, True, 1.0),
    "slaney": (16000, 512, 256, 32, 50.0, 7000.0, 2048, False, 2.0),
    "endscan": (48000, 4800, 281, 120, 50.0, 11000.0, 24000, True, 1.0),
    "classify": (48000, 4096, 640, 160, 50.0, 11000.0, 48000, True, 2.0),
    "338frames": (16000, 512, 16, 40, 50.0, 7000.0, 5400, True, 2.0),
    "nfft2056": (16000, 2056, 512, 40, 50.0, 8000.0, 8000, True, 2.0),
}


def _max_rel(got, gt):
    """tests/test_pallas_exact.py's measure."""
    den = np.maximum(np.abs(gt), 1e-3 * np.abs(gt).max())
    return (np.abs(got - gt) / den).max()


def _kw(case):
    sr, n_fft, hop, n_mels, fmin, fmax, _, htk, power = DIF_CASES[case]
    return dict(sr=sr, n_fft=n_fft, hop_length=hop, n_mels=n_mels, fmin=fmin, fmax=fmax,
                htk=htk, power=power)


def _f64_oracle(wins, sr, n_fft, hop_length, n_mels, fmin, fmax, htk, power):
    """Centre-padded STFT -> |.|^power -> mel matmul, all float64."""
    win = get_window_np("hann", n_fft, periodic=True).astype(np.float64)
    fb = jm._fb_np(sr, n_mels, fmin, fmax, n_fft, 1750.0, htk).astype(np.float64)
    out = []
    for row in wins:
        x = np.pad(row.astype(np.float64), (n_fft // 2, n_fft // 2))
        nf = 1 + (len(x) - n_fft) // hop_length
        frames = np.stack([x[i * hop_length: i * hop_length + n_fft] for i in range(nf)])
        out.append(fb @ (np.abs(np.fft.rfft(frames * win, axis=-1).T) ** power))
    return np.stack(out)


@pytest.fixture(autouse=True)
def _dif_route(monkeypatch):
    monkeypatch.delenv("AAT_PALLAS_ALG", raising=False)


@pytest.mark.parametrize("case", list(DIF_CASES))
def test_dif_plain_vs_pallas_kernel_dif(rng, case):
    """Limit 1e-2 max rel against ``_melspec_core_dif(exact=0)``: the same
    rounding points (bf16 samples, float32 split, bf16 leaves, bf16 power),
    so only the order of the float32 sums and the bf16 rounding flips it
    causes differ; one flip of a power term moves a mel value by at most
    2^-7 of itself. ``_melspec_core_dif`` is called directly: only
    ``pallas_mel_spectrogram`` applies the 320-frame cap."""
    kw = _kw(case)
    s = DIF_CASES[case][6]
    wins = rng.randn(2, s).astype(np.float32)
    consts = jm._device_weights_dif(kw["sr"], kw["n_fft"], kw["n_mels"], kw["fmin"],
                                    kw["fmax"], 1750.0, kw["htk"], "hann", exact=0)
    ref = np.asarray(jm._melspec_core_dif(jnp.asarray(wins), *consts,
                                          hop_length=kw["hop_length"], n_fft=kw["n_fft"],
                                          power=kw["power"], interpret=True, exact=0))
    got = ms.stft_mel_bf16(torch.from_numpy(wins), **kw).numpy()
    assert got.shape == ref.shape == (2, kw["n_mels"], 1 + s // kw["hop_length"])
    assert _max_rel(got, ref) <= 1e-2


@pytest.mark.parametrize("case", list(DIF_CASES))
def test_dif_plain_vs_f64_oracle(rng, case):
    """The JAX test's bf16 budget against float64
    (tests/test_pallas_melspec.py: rtol 3e-2, atol 5e-3 of the scale)."""
    kw = _kw(case)
    wins = rng.randn(2, DIF_CASES[case][6]).astype(np.float32)
    got = ms.stft_mel_dif_bf16_plain(torch.from_numpy(wins), **kw).numpy()
    oracle = _f64_oracle(wins, **kw)
    np.testing.assert_allclose(got, oracle, rtol=3e-2, atol=5e-3 * np.abs(oracle).max())


@pytest.mark.parametrize("case", ["nfft512-p2", "slaney", "endscan", "classify", "nfft2056"])
def test_dif_constants_match_the_jax_package(case):
    """Depth, leaf offsets and each level's twiddle table equal the JAX
    package's bit for bit; the leaf DFT
    matrices agree to a bf16 rounding step (the JAX package rounds float64
    to bf16 at once, the port through float32); the leaf-permuted mel rows
    are equal."""
    sr, n_fft, _, n_mels, fmin, fmax, _, htk, _ = DIF_CASES[case]
    bu = mel_support_bins(sr, n_mels, fmin, fmax, n_fft, 1750.0, htk)
    levels = ms.dif_levels(n_fft, bu)
    assert levels == jm._dif_levels(n_fft, bu)
    assert ms.leaf_off(levels) == jm._leaf_off(levels)
    win, twc, tws, ct, st, melt, lv, nb, bl = ms._dif_consts(sr, n_mels, fmin, fmax, n_fft,
                                                             1750.0, htk, "cpu")
    assert lv == levels and nb == -(-bu // (1 << levels)) and bl >= nb
    assert bl % 16 == 0 if nb <= 128 else bl % 128 == 0
    jw, jtws, jc, js, bl_j = jm._dif_consts(n_fft, "hann", bu, False, levels)
    np.testing.assert_array_equal(win.numpy(), jw[0])
    assert twc.numel() == tws.numel() == n_fft - (n_fft >> levels)
    for lvl, t in enumerate(jtws):
        off, q = ms.dif_twiddle_offset(n_fft, lvl), n_fft >> (lvl + 1)
        np.testing.assert_array_equal(twc.numpy()[off:off + q], t[0])
        np.testing.assert_array_equal(tws.numpy()[off:off + q], t[1])
    m_leaf = n_fft >> levels
    for mine, theirs in ((ct, jc), (st, js)):
        a = mine.float().numpy()[:nb, :m_leaf].T
        b = np.asarray(theirs, np.float32)[:, :nb]
        assert np.abs(a - b).max() <= 2.0 ** -8
        assert not mine.float().numpy()[nb:].any() and not mine.float().numpy()[:, m_leaf:].any()
    jmel = np.asarray(jm._mel_mat_dif(sr, n_mels, fmin, fmax, n_fft, 1750.0, htk, bl_j, False,
                                      levels), np.float32)
    mel = melt.float().numpy()
    assert not mel[n_mels:].any()
    for b in range(1 << levels):
        np.testing.assert_array_equal(mel[:n_mels, b * bl: b * bl + nb].T,
                                      jmel[b * bl_j: b * bl_j + nb])
        assert not mel[:, b * bl + nb: (b + 1) * bl].any()
        assert not jmel[b * bl_j + nb: (b + 1) * bl_j].any()


@pytest.mark.parametrize("n_fft,alg,route", [
    (500, "", "direct"), (4410, "", "direct"), (56, "", "direct"), (4096, "", "dif"),
    (4800, "", "dif"), (512, "", "dif"), (64, "", "dif"), (4096, "matmul", "direct"),
    (4800, " MatMul ", "direct"), (500, "matmul", "direct"), (4096, "fft", "dif"),
])
def test_route_choice(monkeypatch, n_fft, alg, route):
    """``_use_dif``: n_fft % 8 == 0 and n_fft >= 64, unless AAT_PALLAS_ALG
    is matmul; no frame cap."""
    monkeypatch.setenv("AAT_PALLAS_ALG", alg)
    assert ms.bf16_route(n_fft) == route


@pytest.mark.parametrize("alg,n_fft,samples,taken", [
    ("", 500, 2000, "direct"), ("", 512, 5400, "dif"), ("", 4096, 216000, "dif"),
    ("matmul", 512, 5400, "direct"), ("matmul", 4800, 9600, "direct"),
])
def test_cpu_wrapper_takes_the_plain_version_of_its_route(rng, monkeypatch, alg, n_fft,
                                                          samples, taken):
    """A CPU tensor takes the plain version of the route the card would
    take (a window of 338 frames included), read at each call; no launch is
    counted."""
    monkeypatch.setenv("AAT_PALLAS_ALG", alg)
    calls = []
    for name, attr in (("direct", "stft_mel_bf16_plain"), ("dif", "stft_mel_dif_bf16_plain")):
        monkeypatch.setattr(ms, attr, lambda *a, _n=name, **k: calls.append(_n))
    before = (ms.stft_mel_bf16.launches, ms.stft_mel_bf16.direct_launches)
    x = torch.zeros(1, samples)
    ms.stft_mel_bf16(x, sr=48000, n_fft=n_fft, hop_length=16 if n_fft == 512 else 640,
                     n_mels=40, fmin=50.0, fmax=7000.0)
    assert calls == [taken]
    assert (ms.stft_mel_bf16.launches, ms.stft_mel_bf16.direct_launches) == before


def test_dif_refuses_what_the_kernel_does_not_take(rng):
    x = torch.zeros(1, 4000)
    with pytest.raises(ValueError, match="257 mels"):
        ms.stft_mel_dif_bf16_plain(x, sr=16000, n_fft=512, hop_length=160, n_mels=257,
                                   fmin=50.0, fmax=7000.0)
    with pytest.raises(ValueError, match="levels"):  # 6 levels: 4096 bins on 2^16 points
        ms._dif_consts(48000, 40, 0.0, 24000.0, 1 << 16, 1750.0, False, "cpu")


# ---------------------------------------------------------------------------
# a numpy transcription of the dif kernel (stft_mel_dif_bf16_kernel)
# ---------------------------------------------------------------------------


def bf16_np(a):
    """Round float32 to the nearest bf16 (ties to even), kept as float32."""
    b = np.asarray(a, np.float32).view(np.uint32)
    r = (b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return r.view(np.float32)


def split_np(frames, win, twc, tws, levels, n, grp):
    """dif_split<L> for positions n of frames [F, n_fft] (the span rows):
    the group's 8 leaves [(re, im) [F, len(n)]] in slot order. Arithmetic
    in the dtype of the inputs, each operation rounded on its own."""
    n_fft = frames.shape[1]
    m_leaf = n_fft >> levels
    lg = levels - 3
    vr = [frames[:, n + j * m_leaf] * win[n + j * m_leaf] for j in range(1 << levels)]
    vi = [np.zeros_like(v) for v in vr]

    def diff(ar, ai, br, bi, c, s):
        dr, di = ar - br, ai - bi
        return dr * c + di * s, di * c - dr * s

    for lvl in range(lg):
        h = (1 << levels) >> (lvl + 1)
        take_diff = (grp >> (lg - 1 - lvl)) & 1
        for j in range(h):
            if take_diff:
                t = ms.dif_twiddle_offset(n_fft, lvl) + n + j * m_leaf
                vr[j], vi[j] = diff(vr[j], vi[j], vr[j + h], vi[j + h], twc[t], tws[t])
            else:
                vr[j], vi[j] = vr[j] + vr[j + h], vi[j] + vi[j + h]
    for lvl in range(lg, levels):
        h = 8 >> (lvl - lg + 1)
        for j in range(h):
            t = ms.dif_twiddle_offset(n_fft, lvl) + n + j * m_leaf
            for b0 in range(0, 8, 2 * h):
                a, b = b0 + j, b0 + j + h
                d = diff(vr[a], vi[a], vr[b], vi[b], twc[t], tws[t])
                vr[a], vi[a] = vr[a] + vr[b], vi[a] + vi[b]
                vr[b], vi[b] = d
    return list(zip(vr[:8], vi[:8]))


def span_np(x, t0, nf, hop, n_fft):
    """The block's bf16 PCM span: (TFD - 1) hop + n_fft samples from
    t0 hop - n_fft/2, zero outside the window and past the last frame."""
    span = np.zeros((ms.DIF_FRAMES - 1) * hop + n_fft, np.float32)
    e = np.arange((nf - 1) * hop + n_fft)
    s = t0 * hop - n_fft // 2 + e
    ok = (s >= 0) & (s < len(x))
    span[e[ok]] = bf16_np(x[s[ok]])
    return span


def dif_kernel_np(x, *, sr, n_fft, hop_length, n_mels, fmin, fmax, power, htk=True):
    """The dif kernel on one window x [S] float32, block by block: span
    staging, the split by group over K chunks, bf16 leaves, the leaf
    products (float64 sums of exact products), bf16 power, the mel rows
    of each leaf. Returns [n_mels, 1 + S // hop] float32."""
    win, twc, tws, ct, st, melt, levels, nb, bl = (
        t.float().numpy() if isinstance(t, torch.Tensor) else t
        for t in ms._dif_consts(sr, n_mels, fmin, fmax, n_fft, 1750.0, htk, "cpu"))
    m_leaf, m_pad = n_fft >> levels, ct.shape[1]
    n_out = 1 + len(x) // hop_length
    tfd = ms.DIF_FRAMES
    out = np.zeros((n_mels, n_out), np.float32)
    for t0 in range(0, n_out, tfd):
        nf = min(tfd, n_out - t0)
        span = span_np(x, t0, nf, hop_length, n_fft)
        frames = np.stack([span[f * hop_length: f * hop_length + n_fft] for f in range(tfd)])
        acc = np.zeros((tfd, melt.shape[0]))
        for grp in range(1 << (levels - 3)):
            leaves = [(np.zeros((tfd, m_pad), np.float32), np.zeros((tfd, m_pad), np.float32))
                      for _ in range(8)]
            for k0 in range(0, m_pad, ms.DIF_K_CHUNK):
                n = np.arange(k0, min(k0 + ms.DIF_K_CHUNK, m_leaf))
                if not len(n):
                    continue
                for (lr, li), (ur, ui) in zip(leaves, split_np(frames, win, twc, tws, levels,
                                                               n, grp)):
                    lr[:, n], li[:, n] = bf16_np(ur), bf16_np(ui)
            for w, (r, i) in enumerate(leaves):
                r, i = r.astype(np.float64), i.astype(np.float64)
                c, s = ct.T.astype(np.float64), st.T.astype(np.float64)
                xr, xi = r @ c, -(r @ s)
                if grp or w:
                    xr, xi = xr + i @ s, xi + i @ c
                xr, xi = xr.astype(np.float32), xi.astype(np.float32)
                p = xr * xr + xi * xi
                p = np.sqrt(p) if power == 1.0 else p ** np.float32(power / 2) if power != 2 else p
                b = grp * 8 + w
                acc += bf16_np(p).astype(np.float64) @ melt[:, b * bl:(b + 1) * bl].T
        out[:, t0:t0 + nf] = acc[:nf, :n_mels].T
    return out


@pytest.mark.parametrize("case,samples", [
    ("nfft512-p2", 4001), ("endscan", 9001), ("classify", 20000), ("slaney", 2048),
    ("nfft2056", 6000),
])
def test_kernel_transcription_split_equals_the_plain_tree(rng, case, samples):
    """The kernel's split (groups of 8 leaves, slot order, each level's
    twiddle table, float32 operations without contraction) gives the plain
    version's leaves bit for bit, frame by frame from the staged spans."""
    kw = _kw(case)
    n_fft, hop = kw["n_fft"], kw["hop_length"]
    x = rng.randn(samples).astype(np.float32)
    win, twc, tws, _, _, _, levels, _, _ = ms._dif_consts(kw["sr"], kw["n_mels"], kw["fmin"],
                                                          kw["fmax"], n_fft, 1750.0,
                                                          kw["htk"], "cpu")
    win, twc, tws = win.numpy(), twc.numpy(), tws.numpy()
    m_leaf = n_fft >> levels
    n_out = 1 + samples // hop
    for t0 in (0, (n_out - 1) // 16 * 16):  # the first block and the last, ragged one
        nf = min(16, n_out - t0)
        span = span_np(x, t0, nf, hop, n_fft)
        frames = np.stack([span[f * hop: f * hop + n_fft] for f in range(16)])
        tree = ms.dif_tree(torch.from_numpy(frames) * torch.from_numpy(win),
                           torch.from_numpy(twc), torch.from_numpy(tws), levels)
        n = np.arange(m_leaf)
        for grp in range(1 << (levels - 3)):
            for w, (ur, ui) in enumerate(split_np(frames, win, twc, tws, levels, n, grp)):
                r, i = tree[grp * 8 + w]
                np.testing.assert_array_equal(ur, r.numpy())
                np.testing.assert_array_equal(ui, np.zeros_like(ur) if i is None else i.numpy())
        # the span's frames are the plain version's bf16 frames
        padded = np.pad(x, (n_fft // 2, n_fft - n_fft // 2))
        for f in range(nf):
            t = (t0 + f) * hop
            np.testing.assert_array_equal(frames[f], bf16_np(padded[t: t + n_fft]))


@pytest.mark.parametrize("n_fft,levels", [(512, 3), (4800, 4), (4096, 3), (1024, 5),
                                          (480, 3), (960, 4)])
def test_kernel_split_leaves_hold_the_rfft_bins(rng, n_fft, levels):
    """In float64, leaf b's DFT at j is bin 2^L j + leaf_off[b] of the
    windowed frame's rfft, for every group, position and bin."""
    frames = rng.randn(3, n_fft)
    win = get_window_np("hann", n_fft, periodic=True).astype(np.float64)
    ang = np.concatenate([2 * np.pi * np.arange(n_fft >> (lvl + 1)) / (n_fft >> lvl)
                          for lvl in range(levels)])
    m_leaf = n_fft >> levels
    ref = np.fft.rfft(frames * win, axis=-1)
    n = np.arange(m_leaf)
    dft = np.exp(-2j * np.pi * np.outer(n, np.arange(m_leaf)) / m_leaf)
    off = ms.leaf_off(levels)
    for grp in range(1 << (levels - 3)):
        for w, (ur, ui) in enumerate(split_np(frames, win, np.cos(ang), np.sin(ang), levels,
                                              n, grp)):
            b = grp * 8 + w
            # the split's twiddles are conjugated (c, s) pairs applied as
            # (dr c + di s, di c - dr s): the leaf is a plain complex sequence
            leaf = (ur + 1j * ui) @ dft
            k = off[b] + (1 << levels) * np.arange(m_leaf)
            keep = k <= n_fft // 2
            np.testing.assert_allclose(leaf[:, keep], ref[:, k[keep]], rtol=0,
                                       atol=1e-9 * np.abs(ref).max())


@pytest.mark.parametrize("case,samples", [
    ("nfft512-p2", 4001), ("nfft512-p1", 3300), ("endscan", 9001), ("classify", 20000),
    ("slaney", 2048), ("nfft2056", 9000),
])
def test_kernel_transcription_matches_plain(rng, case, samples):
    """The whole kernel transcription against the plain version: 1e-2 max
    rel (the order of the sums, and the bf16 flips it causes, differ), and
    exact zeros past a silent tail."""
    kw = _kw(case)
    x = rng.randn(samples).astype(np.float32)
    x[samples * 2 // 3:] = 0.0
    got = dif_kernel_np(x, **kw)
    ref = ms.stft_mel_dif_bf16_plain(torch.from_numpy(x)[None], **kw)[0].numpy()
    assert got.shape == ref.shape
    assert _max_rel(got, ref) <= 1e-2
    silent = 1 + (samples * 2 // 3 + kw["n_fft"] // 2) // kw["hop_length"]
    assert not got[:, silent:].any() and not ref[:, silent:].any()


# ---------------------------------------------------------------------------
# a numpy transcription of the row kernel's radix select
# ---------------------------------------------------------------------------

INF_BITS = 0x7F800000


def radix_select_np(bits, k):
    """radix_select: four passes over 8-bit digits, most significant first;
    each keeps the entries that match the digits so far, histograms the
    next digit and picks the bucket whose exclusive prefix count holds k."""
    bits = bits.astype(np.int64)  # bit 31 is 0: the digit masks stay non-negative
    prefix = mask = 0
    for shift in (24, 16, 8, 0):
        sel = (bits & mask) == prefix
        hist = np.bincount((bits[sel] >> shift) & 255, minlength=256)
        excl = np.cumsum(hist) - hist
        (d,) = np.nonzero((excl <= k) & (k < excl + hist))[0]
        prefix |= int(d) << shift
        mask |= 255 << shift
        k -= int(excl[d])
    return prefix


def row_median_np(row, nv):
    """row_medians_kernel on one row over its first nv columns."""
    bits = row.astype(np.float32).view(np.int32).copy()
    bits[nv:] = INF_BITS
    lo = radix_select_np(bits, (nv - 1) // 2)
    c = int((bits <= lo).sum())
    above = bits[bits > lo]
    up = lo if c >= nv // 2 + 1 else (int(above.min()) if len(above) else INF_BITS)
    f = np.array([lo, up], np.int32).view(np.float32)
    return (f[0] + f[1]) * np.float32(0.5)


def _rows(rng, kind, t):
    if kind == "ties":
        return (rng.randint(0, 3, size=(6, t)) * 0.5).astype(np.float32)
    if kind == "equal":
        return np.full((3, t), 0.1875, np.float32)
    if kind == "zeros":
        x = np.abs(rng.randn(6, t)).astype(np.float32)
        x[rng.rand(6, t) < 0.8] = 0.0
        return x
    if kind == "digits":  # values that share their leading digits
        base = np.float32(1.5).view(np.int32)
        return (base + rng.randint(0, 300, size=(6, t))).astype(np.int32).view(np.float32)
    if kind == "wide":
        return (np.abs(rng.randn(6, t)) * 10.0 ** rng.randint(-30, 30, size=(6, t))).astype(
            np.float32)
    return np.abs(rng.randn(6, t)).astype(np.float32) ** 3


@pytest.mark.parametrize("kind", ["random", "ties", "equal", "zeros", "digits", "wide"])
@pytest.mark.parametrize("t,nvs", [(1, (1,)), (2, (1, 2)), (7, (1, 2, 3, 6, 7)),
                                   (64, (1, 2, 31, 32, 63, 64)), (257, (129, 200, 256, 257))])
def test_radix_select_equals_np_median(rng, kind, t, nvs):
    """Bit for bit against np.median over the first nv columns (the rest
    masked to +inf), and against the plain version: ties, all-equal rows,
    zeros, shared leading digits, a wide exponent range, nv = 1 and 2, odd
    and even nv."""
    rows = _rows(rng, kind, t)
    for nv in nvs:
        want = np.median(rows[:, :nv], axis=1).astype(np.float32)
        got = np.array([row_median_np(r, nv) for r in rows], np.float32)
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
        plain = md.row_medians_plain(torch.from_numpy(rows)[None], torch.tensor([nv]))
        np.testing.assert_array_equal(plain[0, :, 0].numpy(), want)


def test_radix_select_ranks_every_entry(rng):
    """Every rank of a row with ties and a masked tail picks the sorted
    value of that rank."""
    bits = (rng.randint(0, 5, size=200) * 0.25).astype(np.float32).view(np.int32).copy()
    bits[150:] = INF_BITS
    order = np.sort(bits)
    for k in range(200):
        assert radix_select_np(bits, k) == order[k]
