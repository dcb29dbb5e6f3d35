#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (audio_analysis_torch) end to end on one GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit, and the torch/CUDA versions;
2. builds the CUDA kernels from audio_analysis_torch/csrc (one nvcc per
   source, all started together; sm_90a);
3. writes fixtures into a temporary directory: a seeded 60 s, 48 kHz,
   16-bit WAV (noise and chirps, then a digitally silent tail that the
   end-scan finds), a full-width float32 TuiNet model dir (160 mels;
   channels 64/128/256, stem 32, dense 256) with weights drawn from a seed,
   24 more seeded 60 s WAVs with silent tails at different points (some
   with none), and two full-width TuiNet dirs at TuiNet's default bfloat16
   (a bird model with 8 labels and a pre-model with 3);
4. holds each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it and on the fixtures' data, and times the
   kernel, the plain version and, where one exists, a single PyTorch call
   computing the same function (CUDA events);
5. the exact level's single-recording path: runs the port's CLI
   (``analyse -o FILE --bird-model DIR --seed 0``) in this process on the
   card, cold and then warm, with every kernel's launch count set to 0 just
   before and read just after each run, then once more under
   torch.profiler (device busy time, idle share, device time by kernel);
   reproduces the committed golden snapshot on the card, and runs the CLI
   once more with ``--device cpu`` (the plain versions) and requires the
   card's result to equal it: signals, length, chirps, cacophony index and
   labels identical, confidences within 1;
6. the fast level's batch path: runs the batch CLI (``AAT_FAST=1``,
   ``batch -o --bird-model B --bird-model PRE --batch-size 8 --seed 0`` on
   the first eight WAVs) cold and then warm with the counts reset around each
   run, requires stft_mel_bf16 twice per batch and stft_mel never, prints
   the wall time, audio seconds per second and stage times, and holds
   stft_mel_bf16 against its plain version on the inputs the cold batch
   gave it (the [8, T] end-scan and the batch's padded classify grid);
   then runs a backlog of 24 WAVs (three batches through the pipelined
   stream) and prints its audio seconds per second over the whole run,
   profiles one more warm batch, and runs the first four WAVs with
   ``--device cpu`` and requires the card's results to equal them
   (confidences within 2: the bf16 TuiNet's convolutions round at other
   places on cuDNN and the CPU);
7. prints one JSON line describing every kernel, then the last line
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero before the last
line; without a CUDA device it exits non-zero at once.
"""

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

SR = 48000
SECONDS = 60
SILENT_FROM = 52.0  # seconds; the rest of the recording is digital silence
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM, dense bf16 on the tensor cores
BATCH_SILENT_FROM = (52.0, 60.0, 45.0, 57.5, 60.0, 49.0, 41.0, 55.0)  # 60.0: no tail
BACKLOG = 24  # recordings in the backlog run: three batches of 8
PRE_LABELS = ["bird", "human", "noise"]
REPO = Path(__file__).resolve().parent
GOLDEN_MODEL = REPO / "tests" / "data" / "golden_model"
GOLDEN_SNAPSHOT = REPO / "tests" / "data" / "golden_snapshot.json"
LABELS = ["bird", "morepork", "kiwi", "whistler", "tui", "human", "noise", "insect"]


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# fixtures (also used by the CPU tests)
# ---------------------------------------------------------------------------


def make_recording(seconds=SECONDS, silent_from=SILENT_FROM, seed=0, sr=SR):
    """Noise plus chirps (as tests/test_golden_snapshot.py, stretched), then
    digital silence from `silent_from` seconds. float32 in [-1, 1)."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * sr)) / sr
    y = 0.01 * rng.randn(len(t)).astype(np.float32)
    n_chirps = max(1, int(silent_from // 6))
    for i in range(n_chirps):
        t0 = 1.0 + i * (silent_from - 2.0) / n_chirps
        f0 = float(rng.uniform(1500, 4500))
        sweep = float(rng.uniform(-400, 400))
        dur = float(rng.uniform(0.6, 1.2))
        m = (t >= t0) & (t < t0 + dur)
        phase = 2 * np.pi * (f0 * t[m] + sweep * (t[m] - t0) ** 2)
        y[m] += (0.5 * np.sin(phase)).astype(np.float32)
    y[int(silent_from * sr):] = 0.0
    return y


def golden_recording():
    """The golden snapshot's recording (tests/test_golden_snapshot.py): 20 s
    of seeded noise and three chirps, float32."""
    rng = np.random.RandomState(123)
    t = np.arange(20 * SR) / SR
    y = 0.01 * rng.randn(len(t)).astype(np.float32)
    for f0, sweep, t0, dur in [(2800, 300, 2.0, 0.9), (3500, -400, 8.0, 1.1),
                               (1800, 200, 14.0, 0.7)]:
        m = (t >= t0) & (t < t0 + dur)
        phase = 2 * np.pi * (f0 * t[m] + sweep * (t[m] - t0) ** 2)
        y[m] += (0.5 * np.sin(phase)).astype(np.float32)
    return y


def write_tuinet_model(model_dir, seed=0, channels=(64, 128, 256), stem=32, dense=256,
                       n_mels=160, labels=LABELS, **meta_overrides):
    """metadata.txt + weights.npz in the JAX package's layout (HWIO convs),
    weights drawn from a numpy seed (He-normal, BN statistics perturbed).
    ``meta_overrides`` update the metadata; a None value removes the key
    (``net_dtype=None`` leaves TuiNet's default, bfloat16)."""
    model_dir = Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    meta = {
        "architecture": "tuinet", "name": "tuinet-smoke", "labels": list(labels),
        "n_fft": 4096, "hop_length": 640, "n_mels": n_mels, "fmin": 50, "fmax": 11000,
        "break_freq": 1750, "htk": True, "db_scale": False, "normalize": True,
        "power": 2, "segment_length": 3, "segment_stride": 1.5, "threshold": 0.2,
        "net_dtype": "float32", "net_channels": list(channels),
        "net_stem_channels": stem, "net_dense_units": dense,
    }
    meta.update(meta_overrides)
    meta = {k: v for k, v in meta.items() if v is not None}
    (model_dir / "metadata.txt").write_text(json.dumps(meta, indent=4, sort_keys=True))
    rng = np.random.RandomState(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    conv = lambda ci, co: f32(rng.randn(3, 3, ci, co) * np.sqrt(2.0 / (9 * ci)))
    w = {"mag_a": f32([-1.0]), "stem/w": conv(1, stem), "stem/b": f32(0.01 * rng.randn(stem))}
    c_in = stem
    for i, c in enumerate(channels):
        w[f"blocks/{i}/w1"] = conv(c_in, c)
        w[f"blocks/{i}/w2"] = conv(c, c)
        for bn in ("bn1", "bn2"):
            w[f"blocks/{i}/{bn}/gamma"] = f32(1 + 0.1 * rng.randn(c))
            w[f"blocks/{i}/{bn}/beta"] = f32(0.1 * rng.randn(c))
            w[f"blocks/{i}/{bn}/mean"] = f32(0.1 * rng.randn(c))
            w[f"blocks/{i}/{bn}/var"] = f32(1 + 0.1 * rng.rand(c))
        c_in = c
    w["head/w1"] = f32(rng.randn(c_in, dense) * np.sqrt(2.0 / c_in))
    w["head/b1"] = f32(0.01 * rng.randn(dense))
    w["head/w2"] = f32(rng.randn(dense, len(labels)) * np.sqrt(1.0 / dense))
    w["head/b2"] = f32(0.01 * rng.randn(len(labels)))
    np.savez(model_dir / "weights.npz", **w)
    return model_dir


def compare_results(a, b, confidence_tol=1):
    """The contract between two result JSONs of one recording: signals,
    duration, chirps, cacophony index and every track's box and labels
    identical, confidences within ``confidence_tol``. Raises AssertionError
    naming the first difference; returns the largest confidence
    difference."""
    for k in ("duration", "chirps", "cacophony_index", "cacophony_index_version",
              "non_bird_tags", "species_identify_version"):
        if a.get(k) != b.get(k):
            raise AssertionError(f"{k} differs: {a.get(k)!r} vs {b.get(k)!r}")
    ta, tb = a["species_identify"], b["species_identify"]
    worst = 0
    if len(ta) != len(tb):
        raise AssertionError(f"{len(ta)} vs {len(tb)} tracks")
    for i, (x, y) in enumerate(zip(ta, tb)):
        for k in ("begin_s", "end_s", "freq_start", "freq_end"):
            if x[k] != y[k]:
                raise AssertionError(f"track {i} {k}: {x[k]} vs {y[k]}")
        preds = lambda t: [
            (r["model"], p) for r in t.get("model_results", []) for p in r["predictions"]
        ] + [(r["model"], r["raw_prediction"]) for r in t.get("model_results", [])
             if "raw_prediction" in r]
        pa, pb = preds(x), preds(y)
        if [(m, p["label"]) for m, p in pa] != [(m, p["label"]) for m, p in pb]:
            raise AssertionError(f"track {i} labels differ: {pa} vs {pb}")
        for (_, p), (_, q) in zip(pa, pb):
            worst = max(worst, abs(p["confidence"] - q["confidence"]))
            if abs(p["confidence"] - q["confidence"]) > confidence_tol:
                raise AssertionError(f"track {i} confidence {p} vs {q}")
        ma = x.get("master_tag", {}).get("prediction", {}).get("label")
        mb = y.get("master_tag", {}).get("prediction", {}).get("label")
        if ma != mb:
            raise AssertionError(f"track {i} master tag {ma} vs {mb}")
    return worst


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def time_ms(fn, iters):
    """Mean device time of fn() over `iters` calls after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_rel(got, gt):
    """The measure of tests/test_pallas_exact.py: |got - gt| over
    max(|gt|, 1e-3 max|gt|)."""
    import torch

    gt = gt.double()
    den = torch.clamp(gt.abs(), min=1e-3 * float(gt.abs().max()))
    return float(((got.double() - gt).abs() / den).max())


def fft_flops(n_fft):
    """Operations of one real FFT of n_fft points (the usual 2.5 n log2 n)."""
    return 2.5 * n_fft * math.log2(n_fft)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def check_kernels(pcm):
    """Each kernel against its plain version on the card, at the main
    path's shapes; returns {name: measurement}."""
    import torch

    from audio_analysis_torch.detect.signal_noise import (
        _batch_chunk_flatness, _endscan_decision,
    )
    from audio_analysis_torch.ops import medians as md
    from audio_analysis_torch.ops import melspec as ms
    from audio_analysis_torch.ops.mel import filterbank_np
    from audio_analysis_torch.ops.scale import normalize_minmax

    dev = torch.device("cuda")
    y = torch.from_numpy(pcm).to(dev)[None]  # [1, T] float32
    t = y.shape[1]
    hop = 281
    res = {}

    def dft_entry(name, replaces, fn, plain, library, out_bytes, in_bytes, frames,
                  n_fft, mel_nnz, iters):
        got = fn()
        ref = plain()
        torch.cuda.synchronize()
        if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(ref.shape)} or non-finite")
        rel = max_rel(got, ref)
        abs_err = float((got.double() - ref.double()).abs().max())
        if not rel < 1e-5:
            raise AssertionError(f"{name}: max rel {rel:.3g} vs its plain version (limit 1e-5)")
        ops = frames * (fft_flops(n_fft) + 2 * mel_nnz)
        byte_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
        op_ms = ops / F32_FLOPS * 1e3
        res[name] = dict(
            name=name, route="cuda", source="audio_analysis_torch/csrc/stft.cu",
            replaces=replaces, max_abs_err=abs_err, max_rel=rel,
            ms=time_ms(fn, iters), plain_ms=time_ms(plain, iters),
            library_ms=None if library is None else time_ms(library, iters),
            bound_ms=max(byte_ms, op_ms), bound_by="bytes" if byte_ms >= op_ms else "operations",
            bytes_ms=byte_ms,
            shape=list(got.shape),
        )
        log(json.dumps(res[name]))

    # end-scan mel: whole frames of the recording, n_fft sr//10 = 4800
    chunk = SR // hop
    n_keep = ((1 + t // hop) // chunk) * chunk
    kw_end = dict(sr=SR, n_fft=SR // 10, hop_length=hop, n_mels=120, fmin=50.0,
                  fmax=11000.0, break_freq=1750.0, power=1.0, htk=True, frames=n_keep)
    nnz_end = int((filterbank_np(SR, 120, 50.0, 11000.0, SR // 10, 1750.0, True) != 0).sum())
    dft_entry(
        "stft_mel[end-scan]", "audio_analysis_tpu/ops/pallas/melspec.py:391 (_kernel_dif)",
        lambda: ms.stft_mel(y, **kw_end), lambda: ms.stft_mel_plain(y, **kw_end), None,
        out_bytes=120 * n_keep * 4, in_bytes=t * 4, frames=n_keep, n_fft=SR // 10,
        mel_nnz=nnz_end, iters=3,
    )

    # classify frontend: 64 normalised 3 s windows of the recording's sound
    # (an all-zero window normalises to NaN, as in the reference)
    sample = 3 * SR
    bases = np.arange(64) * ((int(SILENT_FROM * SR) - sample) // 64)
    win = torch.stack([y[0, b : b + sample] for b in bases])
    win = normalize_minmax(win).contiguous()
    kw_cls = dict(sr=SR, n_fft=4096, hop_length=640, n_mels=160, fmin=50.0, fmax=11000.0,
                  break_freq=1750.0, power=2.0, htk=True)
    nnz_cls = int((filterbank_np(SR, 160, 50.0, 11000.0, 4096, 1750.0, True) != 0).sum())
    f_cls = 1 + sample // 640
    dft_entry(
        "stft_mel[classify]", "audio_analysis_tpu/ops/pallas/melspec.py:391 (_kernel_dif)",
        lambda: ms.stft_mel(win, **kw_cls), lambda: ms.stft_mel_plain(win, **kw_cls), None,
        out_bytes=64 * 160 * f_cls * 4, in_bytes=64 * sample * 4, frames=64 * f_cls,
        n_fft=4096, mel_nnz=nnz_cls, iters=3,
    )

    # detection |STFT| of the recording, zeroed past the end-scan's data end
    mx, mn = _batch_chunk_flatness(y, sr=SR, hop_length=hop)
    found, _, mask_valid = _endscan_decision(
        torch.tensor([t], device=dev), mx, mn, sr=SR, hop_length=hop
    )
    if not bool(found[0]):
        raise AssertionError("the end-scan did not find the silent tail")
    mask_valid = int(mask_valid[0])
    fz = y.clone()
    fz[:, mask_valid:] = 0.0
    n_frames = 1 + t // hop
    hann = torch.hann_window(4096, periodic=True, device=dev)
    dft_entry(
        "stft_mag", "audio_analysis_tpu/ops/pallas/melspec.py:453 (_kernel_dif_mag)",
        lambda: ms.stft_mag(fz, n_fft=4096, hop_length=hop),
        lambda: ms.stft_mag_plain(fz, n_fft=4096, hop_length=hop),
        lambda: torch.stft(fz[0], 4096, hop, window=hann, center=True, pad_mode="constant",
                           return_complex=True).abs(),
        out_bytes=2049 * n_frames * 4, in_bytes=t * 4, frames=n_frames, n_fft=4096,
        mel_nnz=0, iters=3,
    )

    # medians of the a_max-normalised spectrogram over its valid frames
    spec = ms.stft_mag(fz, n_fft=4096, hop_length=hop)
    nvf = torch.tensor([1 + mask_valid // hop], device=dev)
    valid = torch.arange(n_frames, device=dev) < nvf[:, None]
    spec_n = (spec / torch.where(valid[:, None, :], spec, 0.0).amax()).contiguous()
    bytes_ms = spec_n.numel() * 4 / HBM_BYTES_PER_S * 1e3
    for name, fn, plain, replaces, out_elems in (
        ("row_medians", lambda: md.row_medians(spec_n, nvf),
         lambda: md.row_medians_plain(spec_n, nvf),
         "audio_analysis_tpu/ops/pallas/medians.py:87 (_kernel_row_medians)", 2049),
        ("col_medians", lambda: md.col_medians(spec_n),
         lambda: md.col_medians_plain(spec_n),
         "audio_analysis_tpu/ops/pallas/medians.py:95 (_kernel_col_medians)", n_frames),
    ):
        got, ref = fn(), plain()
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            bad = int((got != ref).sum())
            raise AssertionError(f"{name}: {bad} medians differ from the plain version")
        res[name] = dict(
            name=name, route="cuda", source="audio_analysis_torch/csrc/medians.cu",
            replaces=replaces, max_abs_err=0.0, max_rel=0.0,
            ms=time_ms(fn, 5), plain_ms=time_ms(plain, 5), library_ms=None,
            bound_ms=bytes_ms + out_elems * 4 / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            shape=list(got.shape),
        )
        log(json.dumps(res[name]))
    return res


def bf16_entry(name, x, kw):
    """stft_mel_bf16 against its plain version on the card on windows `x`
    [N, S] with keyword arguments `kw`; returns its measurement. Rows of
    `x` that are not finite are the padding of a window grid (all-zero
    audio normalises to NaN, as in the reference; the per-track means drop
    them) and are left out of the comparison."""
    import torch

    from audio_analysis_torch.ops import melspec as ms
    from audio_analysis_torch.ops.mel import filterbank_np

    got = ms.stft_mel_bf16(x, **kw)
    ref = ms.stft_mel_bf16_plain(x, **kw)
    torch.cuda.synchronize()
    rows = torch.isfinite(x).all(dim=1)
    g, r = got[rows], ref[rows]
    if got.shape != ref.shape or not len(g) or not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(ref.shape)}, "
                             f"{len(g)} finite rows, or non-finite output")
    rel = max_rel(g, r)
    if not rel <= 1e-2:
        raise AssertionError(f"{name}: max rel {rel:.3g} vs its plain version (limit 1e-2)")
    n, s = x.shape
    n_fft, n_mels, frames = kw["n_fft"], kw["n_mels"], got.shape[-1]
    nnz = int((filterbank_np(kw["sr"], n_mels, kw["fmin"], kw["fmax"], n_fft,
                             kw["break_freq"], kw.get("htk", True)) != 0).sum())
    byte_ms = (n * s + got.numel()) * 4 / HBM_BYTES_PER_S * 1e3
    op_ms = n * frames * (fft_flops(n_fft) + 2 * nnz) / BF16_FLOPS * 1e3
    m = dict(
        name=name, route="cuda", source="audio_analysis_torch/csrc/stft_bf16.cu",
        replaces="audio_analysis_tpu/ops/pallas/melspec.py:98 (_kernel)",
        max_abs_err=float((g.double() - r.double()).abs().max()), max_rel=rel,
        ms=time_ms(lambda: ms.stft_mel_bf16(x, **kw), 10),
        plain_ms=time_ms(lambda: ms.stft_mel_bf16_plain(x, **kw), 3), library_ms=None,
        bound_ms=max(byte_ms, op_ms), bound_by="bytes" if byte_ms >= op_ms else "operations",
        shape=list(got.shape), rows_compared=int(rows.sum()),
    )
    log(json.dumps(m))
    return m


def check_bf16(pcm):
    """stft_mel_bf16 against its plain version on the card, at the slice's
    shapes and where the JAX package takes ``_kernel`` (more than 320
    frames a window, n_fft % 8 != 0); returns {name: measurement}."""
    import torch

    from audio_analysis_torch.ops.scale import normalize_minmax

    y = torch.from_numpy(pcm).to(torch.device("cuda"))
    t = y.shape[0]
    chunk = SR // 281
    n_keep = ((1 + t // 281) // chunk) * chunk

    def windows(n, sample):
        """n normalised windows of the recording's sound."""
        bases = np.arange(n) * ((int(SILENT_FROM * SR) - sample) // n)
        return normalize_minmax(torch.stack([y[b : b + sample] for b in bases])).contiguous()

    cls = dict(sr=SR, n_fft=4096, hop_length=640, n_mels=160, fmin=50.0, fmax=11000.0,
               break_freq=1750.0, power=2.0)
    shapes = {
        "classify": (windows(64, 3 * SR), cls),
        "end-scan": (y[None], dict(sr=SR, n_fft=SR // 10, hop_length=281, n_mels=120, fmin=50.0,
                                   fmax=11000.0, break_freq=1750.0, power=1.0, frames=n_keep)),
        "long": (windows(16, int(4.5 * SR)), cls),
        "nfft500": (windows(16, 16000), dict(sr=16000, n_fft=500, hop_length=125, n_mels=40,
                                             fmin=50.0, fmax=7000.0, break_freq=1750.0,
                                             power=2.0)),
    }
    return {f"stft_mel_bf16[{tag}]": bf16_entry(f"stft_mel_bf16[{tag}]", x, kw)
            for tag, (x, kw) in shapes.items()}


@contextlib.contextmanager
def capture_bf16(captured):
    """Within the block, record a copy of the first input of each kind that
    the frontend passes to stft_mel_bf16 (``batch end-scan``: the call with
    a ``frames`` prefix; ``batch classify``: the window grid) into
    `captured` {tag: (windows, kwargs)}. The kernel still runs, and counts,
    once per call."""
    from audio_analysis_torch.pipeline import frontend

    kernel = frontend.stft_mel_bf16

    def recording(windows, **kw):
        tag = "batch end-scan" if kw.get("frames") is not None else "batch classify"
        captured.setdefault(tag, (windows.clone(), dict(kw)))
        return kernel(windows, **kw)

    frontend.stft_mel_bf16 = recording
    try:
        yield captured
    finally:
        frontend.stft_mel_bf16 = kernel


def counters():
    from audio_analysis_torch.ops import medians as md
    from audio_analysis_torch.ops import melspec as ms

    return {"stft_mel": ms.stft_mel, "stft_mag": ms.stft_mag,
            "row_medians": md.row_medians, "col_medians": md.col_medians,
            "stft_mel_bf16": ms.stft_mel_bf16}


def require_launches(tag, launches, expect):
    """`expect` maps a kernel to its least count on the path; 0 means the
    path must not launch it at all."""
    bad = {k: launches[k] for k, least in expect.items()
           if (launches[k] < least if least else launches[k] != 0)}
    if bad:
        raise AssertionError(f"{tag}: launches {launches}, expected {expect}")


def run_cli(wav, model_dir, device):
    """One CLI run in this process; returns (result JSON, wall seconds,
    launches per kernel)."""
    import torch

    from audio_analysis_torch.cli.analyse import run

    for w in counters().values():
        w.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        run(["-o", str(wav), "--bird-model", str(model_dir), "--seed", "0", "--device", device])
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in counters().items()}
    return json.loads(buf.getvalue()), wall, launches


def run_batch_cli(wavs, models, device, timer=None):
    """One batch CLI run in this process (``--batch-size 8 --seed 0``), its
    stages added into `timer` (a StageTimer) when given; returns (result
    JSON list, wall seconds, launches per kernel)."""
    import torch

    from audio_analysis_torch.cli.batch import run

    for w in counters().values():
        w.launches = 0
    argv = ["-o", "--batch-size", "8", "--seed", "0", "--device", device]
    for m in models:
        argv += ["--bird-model", str(m)]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        run(argv + [str(w) for w in wavs], timer=timer)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in counters().items()}
    return json.loads(buf.getvalue()), wall, launches


def without_times(results):
    """Batch results without their wall-clock field."""
    return [{"file": r["file"], "analysis": {
        k: v for k, v in r["analysis"].items() if k != "processing_time_seconds"
    }} for r in results]


def profile_run(run):
    """One more warm run (``run()`` returns (result, wall, launches)) under
    torch.profiler: device busy time (the union of the device's kernel
    intervals) against the run's wall time, and device time by kernel
    name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall, _ = run()
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    busy, end = 0.0, float("-inf")
    for a, b in spans:  # length of the union of the intervals, in us
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    return dict(
        profiled_wall_ms=wall * 1e3, device_busy_ms=busy / 1e3,
        idle_share=1.0 - busy / 1e3 / (wall * 1e3), device_kernels=len(spans),
        top=[[name[:70], n, t / 1e3] for name, (n, t) in top],
    )


def summary_of(res):
    return dict(
        duration=res["duration"], signals=len(res["chirps"]["signals"]),
        tracks=len(res["species_identify"]), chirps=res["chirps"]["chirps"],
        cacophony_index=res["cacophony_index"], timing=res.get("timing"),
        processing_time_seconds=res["processing_time_seconds"],
    )


def _round3(obj):
    """Floats rounded to 3 places, as tests/test_golden_snapshot.py compares."""
    if isinstance(obj, dict):
        return {k: _round3(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_round3(v) for v in obj]
    return round(obj, 3) if isinstance(obj, float) else obj


def check_golden(device):
    """The port's analysis of the golden recording with the golden model on
    `device`, held to tests/data/golden_snapshot.json: length, duration and
    signals identical, then `compare_results` over the tracks, all with
    floats rounded to 3 places. Raises AssertionError on a difference."""
    from audio_analysis_torch.pipeline.cacophony import (
        calc_cacophony_index, filter_tracks, get_chirps, get_max_chirps,
    )
    from audio_analysis_torch.pipeline.classify import classify_frames

    tracks, length, signals, raw_length, labels = classify_frames(
        golden_recording(), SR, [str(GOLDEN_MODEL)], False, None, rng=None, device=device
    )
    for tr in tracks:
        tr.set_master_tag()
    got = _round3(json.loads(json.dumps({
        "duration": raw_length, "length": length,
        "signals": [s.to_array() for s in signals],
        "chirps": get_chirps(tracks, labels, signals), "max_chirps": get_max_chirps(length),
        "cacophony_index": calc_cacophony_index(filter_tracks(tracks), length)[0],
        "species_identify": [tr.get_meta() for tr in tracks],
    })))
    ref = _round3(json.loads(GOLDEN_SNAPSHOT.read_text()))
    ref["species_identify"] = ref.pop("tracks")
    for k in ("length", "max_chirps", "signals"):
        if got[k] != ref[k]:
            raise AssertionError(f"golden {k}: {got[k]} vs {ref[k]}")
    compare_results(got, ref)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    from audio_analysis_torch.io.audio import write_wav
    from audio_analysis_torch.ops import cuda as kcuda

    log(f"card: {card_line()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    kcuda.library()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"({kcuda.build_dir().relative_to(REPO)})")
    for line in kcuda.build_log().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log("  " + line.strip())

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        wav = tmp / "rec60.wav"
        write_wav(wav, make_recording(), SR)
        model_dir = write_tuinet_model(tmp / "tuinet")
        from audio_analysis_torch.io.audio import load_recording

        pcm16, _ = load_recording(wav, prefer_int16=True)
        pcm = pcm16.astype(np.float32) / 32768.0
        log(f"fixtures written in {tmp}: {SECONDS} s WAV, full-width TuiNet")

        t0 = time.perf_counter()
        kernels = check_kernels(pcm)
        kernels.update(check_bf16(pcm))
        log(f"kernel checks done in {time.perf_counter() - t0:.1f} s")

        # the exact level's single-recording path
        os.environ["AAT_TIMINGS"] = "1"
        for knob in ("AAT_FAST", "AAT_PALLAS"):
            os.environ.pop(knob, None)
        exact_path = {"stft_mel": 2, "stft_mag": 1, "row_medians": 1, "col_medians": 1,
                      "stft_mel_bf16": 0}
        runs = {}
        for tag in ("cold", "warm"):
            res, wall, launches = run_cli(wav, model_dir, "cuda")
            runs[tag] = (res, launches)
            log(json.dumps({"cli_run": tag, "device": "cuda", "wall_s": wall,
                            "launches": launches, **summary_of(res)}))
            require_launches(f"{tag} run", launches, exact_path)
        gpu_res, launches = runs["cold"]
        if runs["warm"][0]["species_identify"] != gpu_res["species_identify"]:
            raise AssertionError("warm run differs from the cold run")
        if gpu_res["duration"] != SECONDS or not gpu_res["chirps"]["signals"]:
            raise AssertionError(f"unexpected result: {summary_of(gpu_res)}")

        log(json.dumps({"profile": "warm", "device": "cuda",
                        **profile_run(lambda: run_cli(wav, model_dir, "cuda"))}))

        t0 = time.perf_counter()
        check_golden("cuda")
        log(f"golden snapshot reproduced on the card ({time.perf_counter() - t0:.1f} s)")

        cpu_res, wall, cpu_launches = run_cli(wav, model_dir, "cpu")
        log(json.dumps({"cli_run": "cpu", "device": "cpu", "wall_s": wall,
                        "launches": cpu_launches, **summary_of(cpu_res)}))
        if any(cpu_launches.values()):
            raise AssertionError(f"the CPU run launched kernels: {cpu_launches}")
        compare_results(gpu_res, cpu_res)
        log("card result equals the CPU result")

        # the fast level's batch path: 8 x 60 s, AAT_FAST=1
        from audio_analysis_torch.utils.runtime import StageTimer

        t0 = time.perf_counter()
        wavs = []
        for i in range(BACKLOG):
            wavs.append(tmp / f"batch{i}.wav")
            silent_from = BATCH_SILENT_FROM[i % len(BATCH_SILENT_FROM)]
            write_wav(wavs[-1], make_recording(silent_from=silent_from, seed=i), SR)
        backlog, wavs = wavs, wavs[:8]
        models = [write_tuinet_model(tmp / "bird-model", seed=0, net_dtype=None,
                                     name="bird-model"),
                  write_tuinet_model(tmp / "pre-model", seed=2, labels=PRE_LABELS,
                                     net_dtype=None, pre_model=True, name="pre-model")]
        log(f"batch fixtures written in {time.perf_counter() - t0:.1f} s: "
            f"{len(backlog)} x {SECONDS} s WAVs, bird and pre TuiNets (bfloat16)")
        os.environ["AAT_FAST"] = "1"
        fast_path = {"stft_mel_bf16": 2, "stft_mag": 1, "row_medians": 1, "col_medians": 1,
                     "stft_mel": 0}
        batch_runs, captured = {}, {}
        for tag in ("cold", "warm"):
            timer = StageTimer()
            with capture_bf16(captured) if tag == "cold" else contextlib.nullcontext():
                res, wall, batch_launches = run_batch_cli(wavs, models, "cuda", timer)
            batch_runs[tag] = res
            log(json.dumps({"batch_run": tag, "device": "cuda", "recordings": len(res),
                            "wall_s": wall, "audio_s_per_s": len(res) * SECONDS / wall,
                            "launches": batch_launches, "timing": timer.as_dict(),
                            "results": [summary_of(r["analysis"]) for r in res]}))
            require_launches(f"batch {tag} run", batch_launches, fast_path)
        if without_times(batch_runs["warm"]) != without_times(batch_runs["cold"]):
            raise AssertionError("the warm batch differs from the cold batch")
        durations = [r["analysis"]["duration"] for r in batch_runs["cold"]]
        if len(durations) != len(wavs) or any(d != SECONDS for d in durations):
            raise AssertionError(f"unexpected batch durations: {durations}")
        if not all(r["analysis"]["chirps"]["signals"] for r in batch_runs["cold"]):
            raise AssertionError("a batch recording has no signals")
        if sorted(captured) != ["batch classify", "batch end-scan"]:
            raise AssertionError(f"stft_mel_bf16 inputs captured: {sorted(captured)}")
        for tag, (x, kw) in sorted(captured.items()):
            kernels[f"stft_mel_bf16[{tag}]"] = bf16_entry(f"stft_mel_bf16[{tag}]", x, kw)
        del captured

        # a backlog of three batches through the pipelined stream
        timer = StageTimer()
        res, wall, backlog_launches = run_batch_cli(backlog, models, "cuda", timer)
        log(json.dumps({"batch_run": "backlog", "device": "cuda", "recordings": len(res),
                        "batches": -(-len(res) // 8), "wall_s": wall,
                        "audio_s_per_s": len(res) * SECONDS / wall,
                        "launches": backlog_launches, "timing": timer.as_dict()}))
        require_launches("backlog run", backlog_launches,
                         {k: 3 * least for k, least in fast_path.items()})
        if without_times(res[:8]) != without_times(batch_runs["warm"]):
            raise AssertionError("the backlog's first batch differs from the warm batch")
        log(json.dumps({"profile": "batch warm", "device": "cuda",
                        **profile_run(lambda: run_batch_cli(wavs, models, "cuda"))}))

        cpu_batch, wall, cpu_launches = run_batch_cli(wavs[:4], models, "cpu")
        log(json.dumps({"batch_run": "cpu", "device": "cpu", "recordings": len(cpu_batch),
                        "wall_s": wall, "launches": cpu_launches}))
        if any(cpu_launches.values()):
            raise AssertionError(f"the CPU batch launched kernels: {cpu_launches}")
        worst = 0
        for g, c in zip(batch_runs["cold"], cpu_batch):
            worst = max(worst, compare_results(g["analysis"], c["analysis"], confidence_tol=2))
        log(json.dumps({"fast_card_vs_cpu": len(cpu_batch), "max_confidence_diff": worst}))
        os.environ.pop("AAT_FAST")

    out = []
    for name, m in kernels.items():
        base = name.split("[")[0]
        # each kernel's count on this slice's path where it runs there,
        # else on the single-recording path
        n = batch_launches[base] if fast_path[base] else launches[base]
        out.append({k: m.get(k) for k in (
            "name", "route", "source", "replaces")} | {"launches": n} | {
            "launches_by_path": {"analyse_exact": launches[base],
                                 "batch_fast": batch_launches[base],
                                 "backlog_fast": backlog_launches[base]}} | {
            k: m.get(k) for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms", "max_rel", "shape")})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": out}))
    log(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
