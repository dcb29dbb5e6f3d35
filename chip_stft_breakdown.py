#!/usr/bin/env python3
"""Where the time of the float64 FFT kernel goes, on one GPU.

    python3 chip_stft_breakdown.py

Times ``stft_mag``'s fft route (``csrc/stft.cu::stft_mag_fft_kernel``) on a
seeded 60 s, 48 kHz signal, [1, 2.88M] -> [1, 2049, 10250] (n_fft 4096, hop
281, tiles of 8 frames), with CUDA events over 10 launches after a warm-up:

- with the first 0, 1, ..., all passes of its radix plan (the output is
  wrong below all passes; with none, what is left is staging, the split and
  the write-out), at power 1 and, with all passes, at power 2 (no square
  root);
- built three more times from the same source with one part taken out:
  ``no staging loads`` (each sample is the window's value instead of the
  signal's), ``no write-out`` (the tile is never stored to device memory)
  and ``no zero flags`` (a plain barrier instead of the two block-wide ORs).

Each variant is the checked-in source with one line replaced, compiled by
nvcc into its own library under ``audio_analysis_torch/build/breakdown/``.
The script holds the unchanged build against the plain version (bit for
bit) before it times anything. It prints the card's name and power limit,
one line per variant and the float64 ``torch.stft(...).abs()`` of the same
signal.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
VARIANTS = {
    "unchanged": [],
    "no staging loads": [
        ("if (s >= 0 && s < S) va = x[s] * w;", "va = w;"),
        ("if (has_b && s + hop >= 0 && s + hop < S) vb = x[s + hop] * w;",
         "vb = has_b ? w : 0.f;"),
    ],
    "no write-out": [
        ("if (f < nf) o[(long)k * n_frames + f] = tile[k * (TF + 1) + f];",
         "if (f < nf && power < 0.f) o[(long)k * n_frames + f] = tile[k * (TF + 1) + f];"),
    ],
    "no zero flags": [
        ("  const int any_a = __syncthreads_or(nz & 1);\n"
         "  const int any_b = __syncthreads_or(nz & 2);",
         "  __syncthreads();\n  const int any_a = 1, any_b = 1;"),
    ],
}


def build_variants(out_dir):
    """{variant: the library's aat_stft_mag_fft}, one nvcc per variant, all
    started together."""
    from audio_analysis_torch.ops import cuda as kcuda

    src = (kcuda.CSRC / "stft.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise AssertionError(f"{name}: the line to replace is not in stft.cu: {old!r}")
            text = text.replace(old, new)
        stem = name.replace(" ", "_")
        (out_dir / f"{stem}.cu").write_text(text)
        cmd = [kcuda.nvcc(), *kcuda.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
               "-shared", str(out_dir / f"{stem}.cu"), "-o", str(out_dir / f"{stem}.so")]
        procs[name] = (stem, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (stem, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        fn = ctypes.CDLL(str(out_dir / f"{stem}.so")).aat_stft_mag_fft
        fn.argtypes = kcuda._SIGNATURES["aat_stft_mag_fft"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_stft_breakdown: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    from audio_analysis_torch.ops import cuda as kcuda
    from audio_analysis_torch.ops import melspec as ms
    from chip_smoke import card_line, make_recording, time_ms

    print(f"card: {card_line()}", flush=True)
    fns = build_variants(kcuda.BUILD_ROOT / "breakdown")
    dev = torch.device("cuda")
    y = torch.from_numpy(make_recording()).to(dev)[None]
    n_fft, hop, tf = 4096, 281, 8
    n_frames = ms.stft_frames(y.shape[1], n_fft, hop)
    win, cs, sn, radix = ms._dft_consts(n_fft, "fft", dev)
    out = torch.empty((1, n_fft // 2 + 1, n_frames), device=dev)
    stream = kcuda.stream_of(y)

    def launch(fn, n_pass, power=1.0):
        rc = fn(y.data_ptr(), win.data_ptr(), cs.data_ptr(), sn.data_ptr(), radix.data_ptr(),
                n_pass, out.data_ptr(), 1, y.shape[1], n_fft, hop, n_frames, power, tf, stream)
        kcuda.check(rc, "stft_mag (breakdown)")

    launch(fns["unchanged"], radix.numel())
    ref = ms.stft_mag_plain(y, n_fft=n_fft, hop_length=hop)
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        raise AssertionError("the unchanged build differs from the plain version")
    print(f"radix plan {tuple(radix.tolist())}, tiles of {tf} frames; ms after n passes:")
    for name, fn in fns.items():
        row = [f"{time_ms(lambda: launch(fn, p), 10):.4f}" for p in range(radix.numel() + 1)]
        pow2 = time_ms(lambda: launch(fn, radix.numel(), 2.0), 10)
        print(f"  {name:17s} {' '.join(row)}   power 2: {pow2:.4f}", flush=True)
    yd = y.double()
    hann = torch.hann_window(n_fft, periodic=True, device=dev, dtype=torch.float64)
    f64 = time_ms(lambda: torch.stft(yd, n_fft, hop, window=hann, center=True,
                                     pad_mode="constant", return_complex=True).abs(), 10)
    print(f"torch.stft(...).abs(), float64: {f64:.4f} ms")
    print(f"card: {card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
