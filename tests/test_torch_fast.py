"""The port's fast frontend level (AAT_FAST / AAT_PALLAS) against the JAX
package: the bf16 DFT -> mel (``stft_mel_bf16``'s plain version) against
the Pallas ``_kernel`` in interpret mode and a float64 oracle, the level
resolver's precedence, the fast end-scan's decisions, and the fast classify
against the JAX package's fast classify.

On a CPU tensor the wrapper takes its plain version; the kernel itself is
held against that in tests/test_torch_kernels.py, on a GPU."""

import json
import logging
import sys
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_analysis_tpu.ops.pallas import melspec as jm
from audio_analysis_tpu.ops.windows import get_window_np

from audio_analysis_torch.ops import melspec as ms
from audio_analysis_torch.pipeline import frontend as fe

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (fixture writers and the result contract)

SR = 48000

# (sr, n_fft, hop, n_mels, fmin, fmax, samples, htk, power): a power of two
# at 16 kHz, n_fft % 8 != 0, a window of more than 320 frames, Slaney
BF16_CASES = {
    "nfft512-p2": (16000, 512, 160, 40, 50.0, 7000.0, 4000, True, 2.0),
    "nfft512-p1": (16000, 512, 160, 40, 50.0, 7000.0, 4000, True, 1.0),
    "nfft500-p1": (16000, 500, 125, 32, 50.0, 7000.0, 2000, True, 1.0),
    "nfft500-p2": (16000, 500, 125, 32, 50.0, 7000.0, 2000, True, 2.0),
    "338frames": (16000, 512, 16, 40, 50.0, 7000.0, 5400, True, 2.0),
    "slaney": (16000, 512, 256, 32, 50.0, 7000.0, 2048, False, 2.0),
}


def _max_rel(got, gt):
    """tests/test_pallas_exact.py's measure."""
    den = np.maximum(np.abs(gt), 1e-3 * np.abs(gt).max())
    return (np.abs(got - gt) / den).max()


def _f64_oracle(wins, sr, n_fft, hop, n_mels, fmin, fmax, htk, power):
    """Centre-padded STFT -> |.|^power -> mel matmul, all float64."""
    win = get_window_np("hann", n_fft, periodic=True).astype(np.float64)
    fb = jm._fb_np(sr, n_mels, fmin, fmax, n_fft, 1750.0, htk).astype(np.float64)
    out = []
    for row in wins:
        x = np.pad(row.astype(np.float64), (n_fft // 2, n_fft // 2))
        nf = 1 + (len(x) - n_fft) // hop
        frames = np.stack([x[i * hop : i * hop + n_fft] for i in range(nf)])
        out.append(fb @ (np.abs(np.fft.rfft(frames * win, axis=-1).T) ** power))
    return np.stack(out)


@pytest.mark.parametrize("case", list(BF16_CASES))
def test_stft_mel_bf16_plain_vs_pallas_kernel_and_oracle(rng, case):
    """Limits: 1e-2 max rel against the Pallas ``_kernel`` (the same bf16
    contract; one bf16 rounding flip of a power term moves a mel value by
    at most 2^-7 of itself, and the summation order adds ~1e-6), and the
    JAX test's bf16 budget against float64 (tests/test_pallas_melspec.py:
    rtol 3e-2, atol 5e-3 of the scale)."""
    sr, n_fft, hop, n_mels, fmin, fmax, s, htk, power = BF16_CASES[case]
    wins = rng.randn(2, s).astype(np.float32)
    wr, wi, melm, _ = jm._device_weights(sr, n_fft, n_mels, fmin, fmax, 1750.0, htk, "hann")
    ref = np.asarray(jm._melspec_core(jnp.asarray(wins), wr, wi, melm, hop_length=hop,
                                      n_fft=n_fft, power=power, interpret=True))
    got = ms.stft_mel_bf16(torch.from_numpy(wins), sr=sr, n_fft=n_fft, hop_length=hop,
                           n_mels=n_mels, fmin=fmin, fmax=fmax, htk=htk, power=power).numpy()
    assert got.shape == ref.shape == (2, n_mels, 1 + s // hop)
    assert _max_rel(got, ref) <= 1e-2
    oracle = _f64_oracle(wins, sr, n_fft, hop, n_mels, fmin, fmax, htk, power)
    np.testing.assert_allclose(got, oracle, rtol=3e-2, atol=5e-3 * np.abs(oracle).max())


def test_stft_mel_bf16_frames_and_shapes(rng):
    """``frames`` takes a prefix of the frames; more mels than the kernel's
    largest tile are refused on every device."""
    wins = torch.from_numpy(rng.randn(2, 4000).astype(np.float32))
    kw = dict(sr=16000, n_fft=512, hop_length=160, n_mels=40, fmin=50.0, fmax=7000.0)
    full = ms.stft_mel_bf16(wins, **kw)
    torch.testing.assert_close(ms.stft_mel_bf16(wins, frames=9, **kw), full[..., :9],
                               rtol=0, atol=0)
    with pytest.raises(ValueError):
        ms.stft_mel_bf16(wins, frames=27, **kw)
    with pytest.raises(ValueError):
        ms.stft_mel_bf16(wins, **{**kw, "n_mels": 257})


@pytest.mark.parametrize("fast,pallas,level", [
    (None, None, fe.EXACT),
    ("1", None, fe.FAST),
    ("1", "0", fe.EXACT),  # an explicit AAT_PALLAS beats the preset
    (None, "1", fe.FAST),
    ("1", "exact2", fe.EXACT),
    (None, "yes", fe.FAST),
    ("0", None, fe.EXACT),
    (None, "exact1", fe.EXACT),
    (None, "3", fe.EXACT),
])
def test_level_resolver_precedence(monkeypatch, fast, pallas, level):
    """tests/test_fast_mode.py's cases on the port's resolver."""
    for name, v in (("AAT_FAST", fast), ("AAT_PALLAS", pallas)):
        if v is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, v)
    assert fe.frontend_level() == level


@pytest.mark.parametrize("fast,level", [("1", fe.FAST), (None, fe.EXACT)])
def test_level_resolver_warns_once_on_a_bad_value(monkeypatch, caplog, fast, level):
    monkeypatch.setattr(fe, "_WARNED_BAD_LEVEL", False)
    monkeypatch.setenv("AAT_PALLAS", "exact-2")
    if fast is None:
        monkeypatch.delenv("AAT_FAST", raising=False)
    else:
        monkeypatch.setenv("AAT_FAST", fast)
    with caplog.at_level(logging.WARNING):
        assert fe.frontend_level() == level
        assert fe.frontend_level() == level
    assert sum("AAT_PALLAS" in r.getMessage() for r in caplog.records) == 1


def test_fast_level_on_cpu_runs_the_bf16_plain_version(monkeypatch, rng):
    """At the fast level a CPU tensor takes the bf16 kernel's plain version
    (the CPU mirrors the card), never the float64 ``stft_mel_plain``; no
    kernel launch is counted."""
    from audio_analysis_torch.detect.signal_noise import _batch_chunk_flatness

    calls = []
    plain = ms.stft_mel_bf16_plain

    def spy(*a, **k):
        calls.append(k["n_fft"])
        return plain(*a, **k)

    def refuse(*a, **k):
        raise AssertionError("the fast level reached the float64 plain version")

    monkeypatch.setattr(ms, "stft_mel_bf16_plain", spy)
    monkeypatch.setattr(ms, "stft_mel_plain", refuse)
    monkeypatch.setenv("AAT_FAST", "1")
    monkeypatch.delenv("AAT_PALLAS", raising=False)
    launches = (ms.stft_mel.launches, ms.stft_mel_bf16.launches)
    g = torch.from_numpy(rng.randn(2, 48000).astype(np.float32))
    feats = fe.spectrogram_grid(g, sr=48000, hop_length=640, n_fft=4096, n_mels=64,
                                mel_break=1750.0)
    assert feats.shape == (2, 64, 76, 1)
    _batch_chunk_flatness(g, sr=48000, hop_length=281)
    assert calls == [4096, 4800]
    assert (ms.stft_mel.launches, ms.stft_mel_bf16.launches) == launches


def test_fast_endscan_keeps_lsb_dither_nonflat():
    """tests/test_detect.py::test_fast_endscan_keeps_lsb_dither_nonflat on
    the port: a DC offset at int16 16384 with +-1 LSB dither rounds to one
    bf16 value, yet no chunk reads flat at the fast level (nonzero input
    puts unequal energy in different bins), as at the exact level and in
    the JAX package's XLA end-scan."""
    from audio_analysis_tpu.detect.signal_noise import _batch_chunk_flatness as j_flat
    from audio_analysis_torch.detect.signal_noise import _batch_chunk_flatness

    hop = 281
    rng = np.random.RandomState(7)
    pcm = (16384 + rng.randint(-1, 2, size=(1, 3 * SR))).astype(np.float32) / 32768.0
    mx0, mn0 = j_flat(jnp.asarray(pcm), sr=SR, hop_length=hop, level=0)
    flat0 = np.asarray(mx0 == mn0)
    assert not flat0.any()
    for level in (fe.EXACT, fe.FAST):
        mx, mn = _batch_chunk_flatness(torch.from_numpy(pcm), sr=SR, hop_length=hop,
                                       level=level)
        np.testing.assert_array_equal((mx == mn).numpy(), flat0)


def test_detect_is_the_same_at_both_levels():
    """The silent-tail recording: the fast end-scan finds the same data
    end, so detect()'s length and signals are identical at both levels."""
    from audio_analysis_torch.detect.signal_noise import detect

    y = torch.from_numpy(chip_smoke.make_recording(seconds=12, silent_from=9.0, seed=5))
    exact = detect(y, SR, level=fe.EXACT)
    fast = detect(y, SR, level=fe.FAST)
    assert exact[0] == fast[0] == 9
    assert exact[1], "the fixture must produce signals"
    assert [s.to_array() for s in exact[1]] == [s.to_array() for s in fast[1]]


def _result(tracks, length, signals, raw_length, labels):
    from audio_analysis_torch.pipeline.cacophony import (
        calc_cacophony_index, filter_tracks, get_chirps, get_max_chirps,
    )

    for t in tracks:
        t.set_master_tag()
    rec_signals = [s.to_array() for s in signals]
    chirps = get_chirps(tracks, labels, signals)
    return json.loads(json.dumps({
        "duration": raw_length, "length": length, "signals": rec_signals,
        "chirps": chirps, "max_chirps": get_max_chirps(length),
        "cacophony_index": calc_cacophony_index(filter_tracks(tracks), length)[0],
        "species_identify": [t.get_meta() for t in tracks],
    }))


def test_fast_classify_matches_jax_fast_classify(tmp_path, monkeypatch):
    """The JAX package's fast classify (the Pallas frontend forced on the
    CPU backend in interpret mode, AAT_PALLAS_ALG=matmul so the frontend is
    ``_kernel``, as tests/test_pallas_melspec.py sets it up) against the
    port's fast classify on the CPU: signals, length and labels identical,
    confidences within 1 (a float32 TuiNet)."""
    import audio_analysis_tpu.pipeline.frontend as jfe
    from audio_analysis_tpu.ops.pallas import medians as jmd
    from audio_analysis_tpu.pipeline.classify import classify_frames as j_classify
    from audio_analysis_torch.pipeline.classify import classify_frames

    model = chip_smoke.write_tuinet_model(tmp_path / "m", seed=2, channels=(8, 16), stem=8,
                                          dense=16, n_mels=40)
    y = chip_smoke.make_recording(seconds=12, silent_from=10.0, seed=3)
    monkeypatch.setattr(jfe, "_pallas_backend", lambda: True)
    monkeypatch.setenv("AAT_FAST", "1")
    monkeypatch.delenv("AAT_PALLAS", raising=False)
    monkeypatch.setenv("AAT_PALLAS_ALG", "matmul")
    monkeypatch.setattr(jm, "pallas_mel_spectrogram",
                        partial(jm.pallas_mel_spectrogram, interpret=True))
    monkeypatch.setattr(jm, "pallas_stft_magnitude",
                        partial(jm.pallas_stft_magnitude, interpret=True))
    monkeypatch.setattr(jmd, "pallas_masked_medians_rowcol",
                        partial(jmd.pallas_masked_medians_rowcol, interpret=True))
    calls = []
    core = jm._melspec_core
    monkeypatch.setattr(jm, "_melspec_core", lambda *a, **k: calls.append(1) or core(*a, **k))

    ref = _result(*j_classify(y, SR, [str(model)], False, None, rng=np.random.RandomState(0)))
    assert calls, "the JAX side must run the direct-DFT _kernel"
    launches = ms.stft_mel_bf16.launches
    got = _result(*classify_frames(y, SR, [str(model)], False, None,
                                   rng=np.random.RandomState(0), device="cpu"))
    assert ms.stft_mel_bf16.launches == launches  # the CPU runs the plain version
    assert ref["species_identify"], "the fixture must produce tracks"
    for k in ("length", "signals", "max_chirps"):
        assert got[k] == ref[k]
    chip_smoke.compare_results(got, ref)
