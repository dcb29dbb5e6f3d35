#!/usr/bin/env python3
"""Where the time of the dif route's bf16 kernel goes, on one GPU.

    python3 chip_dif_breakdown.py

Times ``stft_mel_bf16``'s dif route (``csrc/stft_bf16.cu::
stft_mel_dif_bf16_kernel``) at the fast level's two shapes, on windows of a
seeded 60 s, 48 kHz recording: classify, 64 normalised 3 s windows
[64, 144000] -> [64, 160, 226] (n_fft 4096, hop 640, 3 levels), and the
end-scan [1, 2.88M] -> [1, 120, 10251] (n_fft 4800, hop 281, power 1, 4
levels), with CUDA events over 10 launches after a warm-up. The kernel is
built once as it is checked in and once more for each part taken out,
each variant the checked-in source with one line replaced (the output is
wrong in every variant but the first):

- ``no span loads``: the span holds a pattern instead of the signal;
- ``no split``: each leaf value is one span sample, no butterflies;
- ``no C/S staging``: the leaf matrices' chunks are never copied;
- ``no leaf products``: no mma.sync of the leaf DFTs;
- ``no mel product``: no mma.sync of the mel rows;
- ``no write-out``: the output tile is never stored to device memory.

Each variant is compiled by nvcc into its own library under
``audio_analysis_torch/build/dif_breakdown/``, all started together. The
script holds the unchanged build against the dif route's plain version
(max rel 1e-2) before it times anything. It prints the card's name and
power limit and one line per variant.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
VARIANTS = {
    "unchanged": [],
    "no span loads": [
        ("v[u] = e < len && s >= 0 && s < a.S ? xw[s] : 0.f;",
         "v[u] = (float)(e & 7) + (float)(s & 1);"),
    ],
    "no split": [
        ("dif_split<L>(span, a, f, n, grp, ur, ui);",
         "for (int b = 0; b < GROUP; ++b) ur[b] = ui[b] = __bfloat162float(span[f * a.hop + n]);"),
    ],
    "no C/S staging": [
        ("            cp_async16(cb + r * LDD + c, a.ct + src);\n"
         "            cp_async16(cb + (tbw_max + r) * LDD + c, a.st + src);",
         "            (void)src;"),
    ],
    "no leaf products": [
        ("            if (jg < nt) {\n              const __nv_bfloat16* bc",
         "            if (jg < nt && a.power < 0.f) {\n              const __nv_bfloat16* bc"),
    ],
    "no mel product": [
        ("          if (mt < n_mt) {\n            const __nv_bfloat16* bp = a.melt",
         "          if (mt < n_mt && a.power < 0.f) {\n            const __nv_bfloat16* bp = a.melt"),
    ],
    "no write-out": [
        ("if (f < nf) ow[(long)m * a.n_out + f] = ob[f * ldo + m];",
         "if (f < nf && a.power < 0.f) ow[(long)m * a.n_out + f] = ob[f * ldo + m];"),
    ],
}


def build_variants(out_dir):
    """{variant: the library's aat_stft_mel_dif_bf16}, one nvcc per variant,
    all started together."""
    from audio_analysis_torch.ops import cuda as kcuda

    src = (kcuda.CSRC / "stft_bf16.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise AssertionError(f"{name}: the line to replace is not in stft_bf16.cu: "
                                     f"{old!r}")
            text = text.replace(old, new)
        stem = name.replace(" ", "_").replace("/", "")
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
    from chip_smoke import SILENT_FROM, SR, card_line, make_recording, max_rel, time_ms

    print(f"card: {card_line()}", flush=True)
    fns = build_variants(kcuda.BUILD_ROOT / "dif_breakdown")
    dev = torch.device("cuda")
    y = torch.from_numpy(make_recording()).to(dev)
    sample = 3 * SR
    bases = np.arange(64) * ((int(SILENT_FROM * SR) - sample) // 64)
    cls = normalize_minmax(torch.stack([y[b: b + sample] for b in bases])).contiguous()
    shapes = {
        "classify": (cls, dict(sr=SR, n_fft=4096, hop_length=640, n_mels=160, fmin=50.0,
                               fmax=11000.0, break_freq=1750.0, power=2.0, htk=True)),
        "end-scan": (y[None].contiguous(), dict(sr=SR, n_fft=SR // 10, hop_length=281,
                                                n_mels=120, fmin=50.0, fmax=11000.0,
                                                break_freq=1750.0, power=1.0, htk=True)),
    }
    for tag, (x, kw) in shapes.items():
        n, s = x.shape
        n_out = 1 + s // kw["hop_length"]
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
            print(f"  {name:17s} {time_ms(lambda: launch(fn), 10):.4f}", flush=True)
    print(f"card: {card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
