"""The dif route of the port's fast DFT -> mel (``stft_mel_bf16``, CUDA
source ``csrc/stft_bf16.cu``) and the row medians' radix select
(``csrc/medians.cu``), checked on the CPU:

- the dif route's plain version against the JAX package's
  ``_melspec_core_dif`` at exact=0 (Pallas interpret mode) and a float64
  oracle, and its constants against the JAX package's;
- the route choice (``bf16_route``, the JAX package's ``_use_dif``);
- a numpy transcription of the dif kernel's tiling (16-frame items, the
  aligned span buffer, 64-position K chunks of the (leaf, frame) rows, the
  pass's C/S rows, the per-k16 float32 sums, the mel bands walked in bin
  order; group and split order, twiddle indexing, leaf offsets and padded
  leaf width) against the plain version and ``np.fft.rfft``, and the
  block's shared-memory plans;
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
from audio_analysis_torch.ops.mel import filterbank_np, mel_support_bins

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
    with pytest.raises(ValueError, match="9 levels"):  # 32769 bins on 2^16 points
        ms._dif_consts(48000, 40, 0.0, 24000.0, 1 << 16, 1750.0, False, "cpu")


# (sr, n_fft, hop, n_mels, fmin, fmax, htk, levels): the depths the kernel
# gained, as tests/test_torch_kernels.py::DEEP_DIF_GEOMS runs them on the
# card: 6 levels (n_fft 24000 and 32768 on the classify geometry), 7
# (32768 over the whole band at 256 mels), 8 (the same with Slaney's bank)
DEEP_CASES = {
    "levels6-nfft24000": (48000, 24000, 640, 160, 50.0, 11000.0, True, 6),
    "levels6-nfft32768": (48000, 32768, 640, 160, 50.0, 11000.0, True, 6),
    "levels7-nfft32768": (48000, 32768, 640, 256, 50.0, 24000.0, True, 7),
    "levels8-nfft32768": (48000, 32768, 640, 256, 50.0, 24000.0, False, 8),
}


@pytest.mark.parametrize("case", list(DEEP_CASES))
def test_deep_dif_plain_vs_pallas(rng, case):
    """The plain version at 6 to 8 levels against ``pallas_mel_spectrogram``
    (exact=0, interpret mode, which runs ``_kernel_dif`` at the same depth):
    limit 1e-2 max rel, as at 3 to 5 levels; the depth is the JAX
    package's."""
    sr, n_fft, hop, n_mels, fmin, fmax, htk, levels = DEEP_CASES[case]
    bu = mel_support_bins(sr, n_mels, fmin, fmax, n_fft, 1750.0, htk)
    assert ms.dif_levels(n_fft, bu) == jm._dif_levels(n_fft, bu) == levels
    kw = dict(sr=sr, n_fft=n_fft, hop_length=hop, n_mels=n_mels, fmin=fmin, fmax=fmax,
              htk=htk, power=2.0)
    wins = rng.randn(2, 2 * hop).astype(np.float32)
    ref = np.asarray(jm.pallas_mel_spectrogram(jnp.asarray(wins), interpret=True, exact=0, **kw))
    got = ms.stft_mel_bf16(torch.from_numpy(wins), **kw).numpy()
    assert got.shape == ref.shape == (2, n_mels, 3)
    assert _max_rel(got, ref) <= 1e-2


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


def bitrev(v, bits):
    return int(format(v, f"0{bits}b")[::-1], 2) if bits else 0


def span_np(x, t0, nf, hop, n_fft, base=0):
    """An item's span buffer as the span loaders write it: sample e of the
    span (window element t0 hop - n_fft/2 + e), rounded to bf16, at element
    delta + e, delta = (base + t0 hop - n_fft/2) mod 4 (base: the window's
    first element in floats from a 16-byte boundary); zeros outside the
    window, past the item's last frame and in the alignment. Returns
    (buffer, delta)."""
    s0 = t0 * hop - n_fft // 2
    delta = (base + s0) % 4
    buf = np.zeros(ms.dif_span_alloc(hop, n_fft), np.float32)
    e = np.arange((nf - 1) * hop + n_fft)
    s = s0 + e
    ok = (s >= 0) & (s < len(x))
    buf[delta + e[ok]] = bf16_np(x[s[ok]])
    return buf, delta


def mel_band_np(melt, levels, bl, n_mels):
    """dif_mel_band: each row's first and last bin with a nonzero weight,
    (2^31 - 1, -1) where there is none. Column b bl + j is bin 2^L j +
    bitrev_L(b)."""
    col = np.arange(melt.shape[1])
    leaf, j = col // bl, col % bl
    bins = (j << levels) | np.array([bitrev(b, levels) for b in leaf])
    lo = np.full(n_mels, 2 ** 31 - 1)
    hi = np.full(n_mels, -1)
    for m in range(n_mels):
        nz = bins[melt[m] != 0]
        if len(nz):
            lo[m], hi[m] = nz.min(), nz.max()
    return lo, hi


def dif_kernel_np(x, *, sr, n_fft, hop_length, n_mels, fmin, fmax, power, htk=True,
                  frames=None):
    """The dif kernel on one window x [S] float32, item by item: the span
    buffer, then per pass (leaf group, bin tile) the K loop in chunks of 64
    leaf positions (the split of each chunk into the (leaf, frame) rows of
    R and I, bf16; the pass's rows of C and S, zeros past m_pad; per k16
    step xr += C.R, xr += S.I, xi += C.I, xi -= S.R, each a
    float64 block sum of exact products added to the float32 sum), |X|^power
    rounded to bf16 into the p tile [leaf, bin, frame], and the mel rows
    over each row's band, bin by bin in float32. Returns [n_mels, n_out]
    float32."""
    win, twc, tws, ct, st, melt, levels, nb, bl = (
        t.float().numpy() if isinstance(t, torch.Tensor) else t
        for t in ms._dif_consts(sr, n_mels, fmin, fmax, n_fft, 1750.0, htk, "cpu"))
    m_leaf, m_pad = n_fft >> levels, ct.shape[1]
    n_out = frames or 1 + len(x) // hop_length
    fd, kd, rg = ms.DIF_FRAMES, ms.DIF_K_CHUNK, levels - 3
    tbw = ms.dif_pass_width(bl)
    n_chunks = -(-m_pad // kd)
    lo, hi = mel_band_np(melt, levels, bl, n_mels)
    out = np.zeros((n_mels, n_out), np.float32)
    for t0 in range(0, n_out, fd):
        nf = min(fd, n_out - t0)
        buf, delta = span_np(x, t0, nf, hop_length, n_fft)
        fr = np.stack([buf[delta + f * hop_length: delta + f * hop_length + n_fft]
                       for f in range(fd)])
        mel = np.zeros((n_mels, fd), np.float32)
        for grp in range(1 << rg):
            for j0 in range(0, bl, ms.DIF_BIN_TILE):
                cs = [np.zeros((tbw, n_chunks * kd)) for _ in range(2)]
                for t, tab in zip(cs, (ct, st)):
                    t[:, :m_pad] = tab[j0:j0 + tbw]
                xr = np.zeros((tbw, 8 * fd), np.float32)
                xi = np.zeros((tbw, 8 * fd), np.float32)
                for c in range(n_chunks):
                    n = np.arange(c * kd, (c + 1) * kd)
                    keep = n < m_leaf
                    rr, ii = np.zeros((8 * fd, kd)), np.zeros((8 * fd, kd))
                    for b, (ur, ui) in enumerate(split_np(fr, win, twc, tws, levels, n[keep],
                                                          grp)):
                        rr[b * fd:(b + 1) * fd, keep] = bf16_np(ur)
                        ii[b * fd:(b + 1) * fd, keep] = bf16_np(ui)
                    for k0 in range(0, kd, 16):
                        k = slice(k0, k0 + 16)
                        ck, sk = cs[0][:, c * kd + k0: c * kd + k0 + 16], cs[1][:, c * kd + k0:
                                                                                c * kd + k0 + 16]
                        xr = (xr + ck @ rr[:, k].T).astype(np.float32)
                        xr = (xr + sk @ ii[:, k].T).astype(np.float32)
                        xi = (xi + ck @ ii[:, k].T).astype(np.float32)
                        xi = (xi - sk @ rr[:, k].T).astype(np.float32)
                p = xr * xr + xi * xi
                p = np.sqrt(p) if power == 1.0 else p ** np.float32(power / 2) if power != 2 else p
                ptile = bf16_np(p).reshape(tbw, 8, fd).transpose(1, 0, 2)  # [leaf, bin, f]
                res = bitrev(grp, rg)
                for m in range(n_mels):
                    if hi[m] < 0:
                        continue
                    b0, b1 = max(lo[m], j0 << levels), min(hi[m], ((j0 + tbw) << levels) - 1)
                    b0 += (res - b0) % (1 << rg)
                    bins = np.arange(b0, b1 + 1, 1 << rg)
                    if not len(bins):
                        continue
                    leaf = np.array([bitrev(v, levels) for v in bins % (1 << levels)])
                    j = (bins >> levels) - j0
                    prods = melt[m, leaf * bl + j0 + j][:, None] * ptile[leaf % 8, j]
                    mel[m] = np.add.accumulate(np.concatenate([mel[m][None], prods]),
                                               dtype=np.float32)[-1]
        out[:, t0:t0 + nf] = mel[:, :nf]
    return out


@pytest.mark.parametrize("case,samples", [
    ("nfft512-p2", 4001), ("endscan", 9001), ("classify", 20000), ("slaney", 2048),
    ("nfft2056", 6000), ("classify", 64 * 640), ("classify", 126 * 640),
    ("classify", 128 * 640),
])
def test_kernel_transcription_split_equals_the_plain_tree(rng, case, samples):
    """The kernel's split (groups of 8 leaves, slot order, each level's
    twiddle table, float32 operations without contraction) gives the plain
    version's leaves bit for bit, frame by frame from the span buffers (the
    first item and the last, partial one: 65, 127 and 129 frames at
    classify leave 1, 15 and 1 in it)."""
    kw = _kw(case)
    n_fft, hop = kw["n_fft"], kw["hop_length"]
    x = rng.randn(samples).astype(np.float32)
    win, twc, tws, _, _, _, levels, _, _ = ms._dif_consts(kw["sr"], kw["n_mels"], kw["fmin"],
                                                          kw["fmax"], n_fft, 1750.0,
                                                          kw["htk"], "cpu")
    win, twc, tws = win.numpy(), twc.numpy(), tws.numpy()
    m_leaf = n_fft >> levels
    n_out = 1 + samples // hop
    for t0 in (0, (n_out - 1) // 16 * 16):  # the first item and the last, ragged one
        nf = min(16, n_out - t0)
        span, delta = span_np(x, t0, nf, hop, n_fft, base=samples)
        frames = np.stack([span[delta + f * hop: delta + f * hop + n_fft] for f in range(16)])
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
    ("slaney", 2048), ("nfft2056", 9000), ("classify", 64 * 640), ("classify", 126 * 640),
    ("classify", 128 * 640),
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


CARD_SMEM = 232448  # an H100 block's opt-in shared memory


def _mma_sync_design_smem(hop, n_fft, bl):
    """Shared memory of the dif kernel's earlier design (16 warps on
    mma.sync: two stages of the 16 frames' leaf chunks and of the C/S
    chunks in rows of 72, the p tile, the span): the hops it admitted stay
    admitted."""
    tbw = min(bl, 128)
    span = -(-((16 - 1) * hop + n_fft) // 8) * 8
    return 2 * (2 * 8 * 2 * 16 * 72 + 4 * tbw * 72 + 16 * (8 * tbw + 8) + span)


def _dif_geometries():
    """(sr, n_fft, n_mels, fmax, hop) of every dif geometry the card tests
    run (tests/test_torch_kernels.py: BF16_GEOMS and DIF_GEOMS)."""
    from test_torch_kernels import BF16_GEOMS, DIF_GEOMS

    geoms = [(sr, n_fft, n_mels, min(11000.0, sr / 2), hop)
             for sr, n_fft, hop, n_mels, _, _ in BF16_GEOMS.values()
             if ms.bf16_route(n_fft) == "dif"]
    geoms += [(sr, n_fft, n_mels, fmax, hop)
              for sr, n_fft, hop, n_mels, fmax, _, _ in DIF_GEOMS.values()]
    return geoms


def test_dif_smem_fits_every_geometry_and_admitted_hop():
    """At every dif geometry of the card tests (levels 3, 4 and 5), the
    first plan that fits an H100 block takes the geometry's hop, and takes
    every hop that the earlier design's budget admitted: its largest, and
    (the sizes grow with the hop) every smaller one; the plan picked for
    each is the first of DIF_PLANS that fits, and each size is the sum of
    its parts. The deep splits (levels 6, 7 and 8, at n_fft 24000 and
    32768, which the earlier design took at no hop) fit at their hop, 7 and
    8 levels only without the band list."""
    seen, plans = set(), set()
    for sr, n_fft, n_mels, fmax, hop in _dif_geometries():
        *_, melt, levels, nb, bl = ms._dif_consts(sr, n_mels, 50.0, fmax, n_fft, 1750.0, True,
                                                  "cpu")
        rows = melt.shape[0]
        seen.add(levels)
        top = max(h for h in range(1, 1 + 60000 // 15)
                  if _mma_sync_design_smem(h, n_fft, bl) <= CARD_SMEM)
        for h in (1, hop, top // 2, top):
            plan = ms.dif_plan(h, n_fft, levels, bl, rows, CARD_SMEM)
            assert plan is not None, (n_fft, bl, h)
            plans.add(plan)
            assert ms.dif_smem(h, n_fft, levels, bl, rows, *plan) <= CARD_SMEM
            before = ms.DIF_PLANS[:ms.DIF_PLANS.index(plan)]
            assert all(ms.dif_smem(h, n_fft, levels, bl, rows, *p) > CARD_SMEM for p in before)
        tbw = ms.dif_pass_width(bl)
        assert bl % tbw == 0 and tbw % 16 == 0 and tbw <= 128
        size = ms.dif_smem(hop, n_fft, levels, bl, rows, 2, 2)
        assert size - ms.dif_smem(hop, n_fft, levels, bl, rows, 1, 2) == (
            2 * tbw * 64 * 2 + 2 * 128 * 64 * 2)
        assert size - ms.dif_smem(hop, n_fft, levels, bl, rows, 2, 1) == (
            2 * ms.dif_span_alloc(hop, n_fft))
        # the band list holds every nonzero weight of the filterbank's rows
        lo, hi = mel_band_np(melt.float().numpy(), levels, bl, n_mels)
        assert (hi - lo + 1)[hi >= 0].sum() <= ms.dif_band_cap(levels, bl, rows)
    from test_torch_kernels import DEEP_DIF_GEOMS

    for sr, n_fft, hop, n_mels, fmax, htk, _ in DEEP_DIF_GEOMS.values():
        *_, melt, levels, nb, bl = ms._dif_consts(sr, n_mels, 50.0, fmax, n_fft, 1750.0, htk,
                                                  "cpu")
        rows = melt.shape[0]
        seen.add(levels)
        plan = ms.dif_plan(hop, n_fft, levels, bl, rows, CARD_SMEM)
        assert plan == ((1, 1, 1) if levels == 6 else (1, 1, 0))
        plans.add(plan)
        before = ms.DIF_PLANS[:ms.DIF_PLANS.index(plan)]
        assert all(ms.dif_smem(hop, n_fft, levels, bl, rows, *p) > CARD_SMEM for p in before)
        assert ms.dif_smem(hop, n_fft, levels, bl, rows, 1, 1, 1) - ms.dif_smem(
            hop, n_fft, levels, bl, rows, 1, 1, 0) == 2 * ms.dif_band_cap(levels, bl, rows)
    assert seen == {3, 4, 5, 6, 7, 8} and plans == set(ms.DIF_PLANS)
    # the main paths' two shapes: two span buffers, two ring stages at
    # classify and three at the end-scan, each with the band list
    assert ms.dif_plan(640, 4096, 3, 128, 160, CARD_SMEM) == (2, 2, 1)
    assert ms.dif_plan(281, 4800, 4, 80, 128, CARD_SMEM) == (3, 2, 1)


@pytest.mark.parametrize("hop,n_fft", [(281, 4800), (640, 4096), (16, 512), (125, 1000),
                                       (7, 64)])
def test_span_buffer_runs_are_aligned(rng, hop, n_fft):
    """Quad q of a span buffer (elements 4q .. 4q + 3) holds window elements
    whose address is a whole 16-byte run, for any window offset and item;
    the buffer holds the alignment and every sample of the item's frames."""
    for base in rng.randint(0, 1 << 20, size=6):
        for t0 in (0, 16, 48, 160):
            s0 = t0 * hop - n_fft // 2
            _, delta = span_np(np.zeros(10), t0, 16, hop, n_fft, base=int(base))
            assert 0 <= delta < 4 and (int(base) + s0 - delta) % 4 == 0
            assert delta + 15 * hop + n_fft <= ms.dif_span_alloc(hop, n_fft)
            assert ms.dif_span_alloc(hop, n_fft) % 8 == 0


@pytest.mark.parametrize("case", ["nfft512-p2", "slaney", "endscan", "classify", "nfft2056"])
def test_mel_bands_hold_every_weight(case):
    """The band of each mel row (dif_mel_band) holds every nonzero weight
    of the row's leaf-permuted columns, and the rows' bands together hold
    the filterbank's support; a bin's leaf is in group g iff the bin is
    bitrev(g) modulo 2^(L - 3), the rule by which a pass walks the band."""
    sr, n_fft, _, n_mels, fmin, fmax, _, htk, _ = DIF_CASES[case]
    _, _, _, _, _, melt, levels, _, bl = ms._dif_consts(sr, n_mels, fmin, fmax, n_fft, 1750.0,
                                                        htk, "cpu")
    melt = melt.float().numpy()
    lo, hi = mel_band_np(melt, levels, bl, n_mels)
    fb = filterbank_np(sr, n_mels, fmin, fmax, n_fft, 1750.0, htk)
    for m in range(n_mels):
        nz = np.nonzero(fb[m])[0]
        assert (lo[m], hi[m]) == ((nz.min(), nz.max()) if len(nz) else (2 ** 31 - 1, -1))
    rg = levels - 3
    for leaf in range(1 << levels):
        k = bitrev(leaf, levels)  # the leaf's bins are k + 2^L j
        for g in range(1 << rg):
            assert ((leaf >> 3) == g) == (k % (1 << rg) == bitrev(g, rg))


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
