#!/usr/bin/env python3
"""Where the time of the dif route's bf16 kernel goes, on one GPU.

    python3 chip_dif_breakdown.py

Times ``stft_mel_bf16``'s dif route (``csrc/stft_bf16.cu::
stft_mel_dif_bf16_kernel``) at the fast level's shapes, on windows of
seeded 60 s, 48 kHz recordings: classify, 64 normalised 3 s windows
[64, 144000] -> [64, 160, 226] (n_fft 4096, hop 640, 3 levels), the
end-scan of one recording [1, 2.88M] -> [1, 120, 10200] and of the fast
batch's eight [8, 2.88M] (n_fft 4800, hop 281, power 1, 4 levels), with
CUDA events over 10 launches after a warm-up. The kernel is built once as
it is checked in and once more for each set of parts taken out, each
variant the checked-in source with lines replaced (the output is wrong in
every variant but the first):

- ``no span loads``: the span loaders store a pattern, not the signal;
- ``no split``: the split warpgroup stores one span sample for every leaf
  value, no butterflies;
- ``no leaf products``: no wgmma of the leaf DFTs (the ring still runs);
- ``no p tile``: the consumers store no |X|^power;
- ``no mel product``: no pass over the mel bands;
- ``no mel, no band scan``: neither, nor the scan of the mel matrix and
  the band list at block start;
- ``no write-out``: the outputs are never stored to device memory;
- ``TMA only``: all of the above: the ring's C/S loads and barriers alone;
- ``no window/twiddle loads``: the split's window and twiddle factors come
  from arithmetic on their index instead of device memory;
- ``two ring stages``: the launcher takes two ring stages where it would
  take three.

Each variant is compiled by nvcc into its own library under
``audio_analysis_torch/build/dif_breakdown/``, all started together. The
script holds the unchanged build against the dif route's plain version
(max rel 1e-2) before it times anything. It prints the card's name and
power limit and one line per variant and shape.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
PARTS = {
    "span loads": [
        ("      const float4 t = v[u];",
         "      const float4 t = make_float4((float)(q & 7), 1.f, 2.f, 3.f);"),
    ],
    "split": [
        ("            dif_split<L, 2>(sp, a, sw, c * KD + kk, grp, ur, ui);",
         "            for (int b = 0; b < 2 * GROUP; ++b)\n"
         "              ur[b / 8][b % 8] = ui[b / 8][b % 8] = __bfloat162float(sp[sw * a.hop + kk]);"),
    ],
    "leaf products": [
        ("for (int ks = 0; ks < KD / 16; ++ks) {  // the leaf products",
         "for (int ks = 0; ks < (a.power < 0.f ? KD / 16 : 0); ++ks) {"),
    ],
    "p tile": [("            if (j < a.tbw)\n", "            if (j < a.tbw && a.power < 0.f)\n")],
    "mel product": [
        ("      dif_mel_pass<L>(a, lo, hi, wband, ptile, pass / a.n_bt, (pass % a.n_bt) * BTILE, ct, mel);",
         "      (void)ptile;"),
    ],
    "band scan": [("  dif_mel_band<L>(a, lo, hi, ct);\n  named_bar(1, 256);",
                   "  for (int m = ct; m < a.n_mels; m += 256) lo[m] = 0, hi[m] = -1;\n"
                   "  named_bar(1, 256);")],
    "window/twiddle loads": [
        ("    const float w = __ldg(a.win + k);",
         "    const float w = __int_as_float(0x3f000000 + (k & 1023));"),
        ("          const float c = __ldg(a.twc + t), s = __ldg(a.tws + t);\n#pragma unroll\n"
         "          for (int i = 0; i < NF; ++i)\n            dif_diff(",
         "          const float c = __int_as_float(0x3f000000 + (t & 1023)),\n"
         "                      s = __int_as_float(0x3e000000 + (t & 1023));\n#pragma unroll\n"
         "          for (int i = 0; i < NF; ++i)\n            dif_diff("),
        ("        const float c = __ldg(a.twc + t), s = __ldg(a.tws + t);\n#pragma unroll\n"
         "        for (int b0 = 0;",
         "        const float c = __int_as_float(0x3f000000 + (t & 1023)),\n"
         "                    s = __int_as_float(0x3e000000 + (t & 1023));\n#pragma unroll\n"
         "        for (int b0 = 0;"),
    ],
    "write-out": [
        ("if (m < a.n_mels && t < a.n_out) ow[(long)m * a.n_out + t] = mel[r][e];",
         "if (m < a.n_mels && t < a.n_out && a.power < 0.f) ow[(long)m * a.n_out + t] = mel[r][e];"),
    ],
}
VARIANTS = {
    "unchanged": [],
    "no span loads": PARTS["span loads"],
    "no split": PARTS["split"],
    "no leaf products": PARTS["leaf products"],
    "no p tile": PARTS["p tile"],
    "no mel product": PARTS["mel product"],
    "no mel, no band scan": PARTS["mel product"] + PARTS["band scan"],
    "no write-out": PARTS["write-out"],
    "TMA only": [e for name, part in PARTS.items() if name != "window/twiddle loads"
                 for e in part],
    "no window/twiddle loads": PARTS["window/twiddle loads"],
    "two ring stages": [("constexpr int DIF_PLANS[5][3] = {{3, 2, 1}, {2, 2, 1}, {2, 1, 1}, {1, 1, 1}, {1, 1, 0}};",
                         "constexpr int DIF_PLANS[5][3] = {{2, 2, 1}, {2, 2, 1}, {2, 1, 1}, {1, 1, 1}, {1, 1, 0}};")],
}


def build_variants(out_dir):
    """{variant: the library's aat_stft_mel_dif_bf16}, one nvcc per variant,
    all started together."""
    from audio_analysis_torch.ops import cuda as kcuda

    src = (kcuda.CSRC / "stft_bf16.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    texts = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise AssertionError(f"{name}: the line to replace is not in stft_bf16.cu: "
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
        fns = {}
        for name, (stem, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}:\n{log}")
            fn = ctypes.CDLL(str(out_dir / f"{stem}.so")).aat_stft_mel_dif_bf16
            fn.argtypes = kcuda._SIGNATURES["aat_stft_mel_dif_bf16"]
            fn.restype = ctypes.c_int
            fns[name] = fn
    finally:  # no nvcc outlives a failure
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return fns


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_dif_breakdown: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    from audio_analysis_torch.ops import cuda as kcuda
    from audio_analysis_torch.ops import melspec as ms
    from audio_analysis_torch.ops.scale import normalize_minmax
    from chip_smoke import (BATCH_SILENT_FROM, SILENT_FROM, SR, card_line, make_recording,
                            max_rel, time_ms)

    print(f"card: {card_line()}", flush=True)
    fns = build_variants(kcuda.BUILD_ROOT / "dif_breakdown")
    dev = torch.device("cuda")
    y = torch.from_numpy(make_recording()).to(dev)
    sample = 3 * SR
    bases = np.arange(64) * ((int(SILENT_FROM * SR) - sample) // 64)
    cls = normalize_minmax(torch.stack([y[b: b + sample] for b in bases])).contiguous()
    end_scan = dict(sr=SR, n_fft=SR // 10, hop_length=281, n_mels=120, fmin=50.0, fmax=11000.0,
                    break_freq=1750.0, power=1.0, htk=True)
    batch = torch.from_numpy(np.stack([make_recording(silent_from=s, seed=i)
                                       for i, s in enumerate(BATCH_SILENT_FROM)])).to(dev)
    chunk = SR // 281
    end_frames = ((1 + y.shape[0] // 281) // chunk) * chunk  # the end-scan's whole chunks
    shapes = {
        "classify": (cls, dict(sr=SR, n_fft=4096, hop_length=640, n_mels=160, fmin=50.0,
                               fmax=11000.0, break_freq=1750.0, power=2.0, htk=True)),
        "end-scan": (y[None].contiguous(), dict(end_scan, frames=end_frames)),
        "batch end-scan": (batch, dict(end_scan, frames=end_frames)),
    }
    for tag, (x, kw) in shapes.items():
        n, s = x.shape
        n_out = kw.get("frames") or 1 + s // kw["hop_length"]
        win, twc, tws, ct, st, melt, levels, nb, bl = ms._dif_consts(
            kw["sr"], kw["n_mels"], kw["fmin"], kw["fmax"], kw["n_fft"], kw["break_freq"],
            kw["htk"], dev)
        out = torch.empty((n, kw["n_mels"], n_out), device=dev)

        def launch(fn):
            rc = fn(x.data_ptr(), win.data_ptr(), twc.data_ptr(), tws.data_ptr(), ct.data_ptr(),
                    st.data_ptr(), melt.data_ptr(), out.data_ptr(), n, s, kw["n_fft"], levels,
                    ct.shape[1], kw["hop_length"], n_out, nb, bl, melt.shape[0], kw["n_mels"],
                    kw["power"], kcuda.stream_of(x))
            kcuda.check(rc, "stft_mel_bf16 dif (breakdown)")

        launch(fns["unchanged"])
        rel = max_rel(out, ms.stft_mel_dif_bf16_plain(x, **kw))
        if not rel <= 1e-2:
            raise AssertionError(f"{tag}: the unchanged build is {rel:.3g} from the plain version")
        print(f"{tag}: [{n}, {s}] -> {list(out.shape)}, n_fft {kw['n_fft']}, {levels} levels, "
              f"{bl} bins a leaf; max rel {rel:.3g}; ms:", flush=True)
        for name, fn in fns.items():
            print(f"  {name:21s} {time_ms(lambda: launch(fn), 10):.4f}", flush=True)
    print(f"card: {card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
