#!/usr/bin/env python3
"""Where the time of the float64 DFTs' cluster route goes, on one GPU.

    python3 chip_cluster_breakdown.py

Times ``stft_mel`` and ``stft_mag`` on their cluster route
(``csrc/stft.cu::stft_mel_cluster_kernel``, ``stft_mag_cluster_kernel``:
the transform split over a thread-block cluster) at the shapes
``chip_smoke.py`` holds them at, on a seeded 60 s, 48 kHz recording:
``stft_mel`` on the classify grid, 64 normalised 3 s windows [64, 144000]
-> [64, 160, 226] at n_fft 16384 (two blocks), 32768 (four) and the prime
6301 (Bluestein over two blocks); ``stft_mag`` of the recording
[1, 2.88M] at hop 281 -> [1, n_fft / 2 + 1, 10250] at 16384 and 6301;
CUDA events over 5 launches after a warm-up. The source is built once as
it is checked in and once more for each variant, the checked-in source
with lines replaced:

- ``no exchange``: the exchange passes across the cluster do nothing;
- ``no block passes``: no block runs its in-place passes (nor, with
  Bluestein, the filter's product);
- ``no split``: no block splits the pair nor computes |X|^power;
- ``no mel sums``: the mel outputs are not summed nor written;
- ``exchange in the staging's order``: the exchange takes the points at
  the addresses where the block stages them in the digit-reversed order
  (``fft_positions``; the first design's order, whose neighbouring
  threads' addresses share banks), its twiddles still read by address;
- ``staging at natural addresses``: each block stages its chunk in natural
  order instead of at ``fft_positions`` (whose neighbouring threads'
  addresses share banks; Bluestein stages in natural order already).

The output of every variant but the first is wrong. Each variant is compiled
by nvcc into its own library under
``audio_analysis_torch/build/cluster_breakdown/``, all started together,
and the wrappers are pointed at each library in turn. The script holds the
unchanged build against the plain versions (max rel 1e-6) before it times
anything. It prints the card's name and power limit and one line per
variant and shape.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
VARIANTS = {
    "unchanged": [],
    "no exchange": [("  switch (d.c) {\n", "  if (d.c > 0) return;\n  switch (d.c) {\n")],
    "no block passes": [
        ("    fft_inplace<true>(a, tw, d.m, d.radix, d.n_pass, d.csm, d.snm);", "    (void)tw;"),
        ("    fft_inplace_dif(a, tw, d.m, d.radix, d.n_pass, d.csm, d.snm);\n"
         "    const double* bc", "    const double* bc"),
        ("    for (int p = threadIdx.x; p < d.m; p += blockDim.x) {\n"
         "      const double xr = a[pad(p)], xi = a[np + pad(p)];",
         "    for (int p = threadIdx.x; p < (bc == bs ? d.m : 0); p += blockDim.x) {\n"
         "      const double xr = a[pad(p)], xi = a[np + pad(p)];"),
        ("    fft_inplace<false>(a, tw, d.m, d.radix, d.n_pass, d.csm, d.snm);\n    cl.sync();",
         "    cl.sync();"),
    ],
    "no split": [("    const int k = rank + i * d.c;\n    if (k >= bins) break;\n"
                  "    double pr, pi, qr, qi;",
                  "    const int k = rank + i * d.c;\n    if (k >= bins || power > -1.f) break;\n"
                  "    double pr, pi, qr, qi;")],
    "no mel sums": [("  mel_cluster(pw, bpc, fb, fb_lo, fb_hi, out, w, t0, nf, n_out, bins, n_mels, "
                     "d.c, rank);", "  (void)pw;")],
    "exchange in the staging's order": [("    const int at = pad(q);\n",
                                         "    const int at = pad(d.perm ? __ldg(d.perm + q) : q);\n")],
    "staging at natural addresses": [("    const int at = BLUE ? i : __ldg(d.perm + i);\n",
                                      "    const int at = i;\n")],
}


def build_variants(out_dir):
    """{variant: its loaded library}, one nvcc per variant, all started
    together."""
    from audio_analysis_torch.ops import cuda as kcuda

    src = (kcuda.CSRC / "stft.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    texts = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise AssertionError(f"{name}: the line to replace is not once in stft.cu: "
                                     f"{old!r}")
            text = text.replace(old, new)
        texts[name] = text
    procs = {}
    try:
        for name, text in texts.items():
            stem = "".join(ch if ch.isalnum() else "_" for ch in name)
            (out_dir / f"{stem}.cu").write_text(text)
            cmd = [kcuda.nvcc(), *kcuda.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                   "-shared", str(out_dir / f"{stem}.cu"), "-o", str(out_dir / f"{stem}.so")]
            procs[name] = (stem, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True))
        libs = {}
        for name, (stem, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}:\n{log}")
            lib = ctypes.CDLL(str(out_dir / f"{stem}.so"))
            for fn_name, args in kcuda._SIGNATURES.items():
                if fn_name.startswith("aat_stft_") and "bf16" not in fn_name or \
                        fn_name == "aat_smem_optin":
                    fn = getattr(lib, fn_name)
                    fn.argtypes = args
                    fn.restype = ctypes.c_int
            libs[name] = lib
    finally:  # no nvcc outlives a failure
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return libs


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_cluster_breakdown: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    from audio_analysis_torch.ops import cuda as kcuda
    from audio_analysis_torch.ops import melspec as ms
    from audio_analysis_torch.ops.scale import normalize_minmax
    from chip_smoke import SILENT_FROM, SR, card_line, make_recording, max_rel, time_ms

    print(f"card: {card_line()}", flush=True)
    libs = build_variants(kcuda.BUILD_ROOT / "cluster_breakdown")
    dev = torch.device("cuda")
    y = torch.from_numpy(make_recording()).to(dev)
    sample = 3 * SR
    bases = np.arange(64) * ((int(SILENT_FROM * SR) - sample) // 64)
    cls = normalize_minmax(torch.stack([y[b: b + sample] for b in bases])).contiguous()
    mel = dict(sr=SR, hop_length=640, n_mels=160, fmin=50.0, fmax=11000.0, break_freq=1750.0,
               power=2.0, htk=True)
    shapes = {f"stft_mel n_fft {n}": (ms.stft_mel, ms.stft_mel_plain, cls, dict(mel, n_fft=n))
              for n in (16384, 32768, 6301)}
    shapes |= {f"stft_mag n_fft {n}": (ms.stft_mag, ms.stft_mag_plain, y[None].contiguous(),
                                       dict(n_fft=n, hop_length=281)) for n in (16384, 6301)}
    try:
        for tag, (fn, plain, x, kw) in shapes.items():
            kcuda._LIB = libs["unchanged"]
            before = fn.cluster_launches
            ref_out = fn(x, **kw)
            if fn.cluster_launches != before + 1:
                raise AssertionError(f"{tag}: not the cluster route")
            rel = max_rel(ref_out, plain(x, **kw))
            if not rel <= 1e-6:
                raise AssertionError(f"{tag}: the unchanged build is {rel:.3g} from the plain "
                                     "version")
            bins = kw["n_fft"] // 2 + 1 if fn is ms.stft_mag else ms.mel_support_bins(
                SR, 160, 50.0, 11000.0, kw["n_fft"], 1750.0, True)
            c, points, tf = ms.cluster_plan(kw["n_fft"], bins, mel=fn is ms.stft_mel,
                                            cap=kcuda.smem_optin(dev))
            print(f"{tag}: {list(x.shape)} -> {list(ref_out.shape)}, {c} blocks of "
                  f"{points // c} points, {tf} frames a cluster; max rel {rel:.3g}; ms:",
                  flush=True)
            for name, lib in libs.items():
                kcuda._LIB = lib
                print(f"  {name:27s} {time_ms(lambda: fn(x, **kw), 5):.4f}", flush=True)
    finally:
        kcuda._LIB = None
    print(f"card: {card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
