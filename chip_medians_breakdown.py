#!/usr/bin/env python3
"""Where the time of the column medians kernel goes, on one GPU.

    python3 chip_medians_breakdown.py

Times ``col_medians`` (``csrc/medians.cu::col_medians_kernel``) on the
normalised detection |STFT| that the main paths give it: one seeded 60 s,
48 kHz recording silent from 52 s, [1, 2049, 10250], and the fast batch's
eight recordings with their own silent tails, [8, 2049, 10250], each zeroed
past the end-scan's data end and divided by its largest valid value, as
``detect_batch_mask`` does. CUDA events over 10 launches after a warm-up.
The kernel is built once for each variant below from the checked-in source,
each by its own nvcc (all started together) with compile-time switches that
only this script passes:

- ``full``: as the package builds it;
- ``staging only`` (``-DAAT_COL_STAGE_ONLY``): the tiles' cp.async copies
  and barriers, no search;
- ``search only`` (``-DAAT_COL_SEARCH_ONLY``): each block stages its first
  tile and searches it again for every tile it owns (one tile's staging per
  block stays in the time).

Each shape is timed whole, on the all-zero tail columns alone (the columns
at or past the first recording's valid frames, copied into their own
contiguous tensor) and with every value zero. The full build is held bit for
bit to the plain version first. The script prints the card's name and power
limit, ptxas' registers and spills for each build, the bound (the
spectrogram read once and the medians written once at 3.35 TB/s), and one
line per input with every variant's time.
"""

import ctypes
import subprocess
import sys

VARIANTS = {
    "full": [],
    "staging only": ["-DAAT_COL_STAGE_ONLY"],
    "search only": ["-DAAT_COL_SEARCH_ONLY"],
}


def ptxas_report(log, kernel="col_medians_kernel"):
    """ptxas' stack frame, spills and registers for `kernel` in nvcc's log."""
    found, on = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            on = kernel in line
        elif on and ("stack frame" in line or "Used" in line):
            found.append(line.split("ptxas info    :")[-1].strip())
    return "; ".join(found)


def build_variants(out_dir):
    """{variant: the library's aat_col_medians}, one nvcc per variant, all
    started together."""
    from audio_analysis_torch.ops import cuda as kcuda

    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, defines in VARIANTS.items():
        so = out_dir / (name.replace(" ", "_") + ".so")
        cmd = [kcuda.nvcc(), *kcuda.ARCH_FLAGS, *kcuda.CFLAGS, *defines, "-shared",
               str(kcuda.CSRC / "medians.cu"), "-o", str(so)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        print(f"  {name:20s} {ptxas_report(log)}", flush=True)
        fn = ctypes.CDLL(str(so)).aat_col_medians
        fn.argtypes = kcuda._SIGNATURES["aat_col_medians"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def detection_spectrogram(y):
    """The normalised |STFT| of signals y [B, T] on the card and each
    recording's valid frames, as detect_batch_mask computes them."""
    import torch

    from audio_analysis_torch.detect.signal_noise import (
        _batch_chunk_flatness, _endscan_decision,
    )
    from audio_analysis_torch.ops import melspec as ms
    from chip_smoke import SR

    hop = 281
    b, t = y.shape
    mx, mn = _batch_chunk_flatness(y, sr=SR, hop_length=hop)
    _, _, mask_valid = _endscan_decision(torch.full((b,), t, device=y.device), mx, mn, sr=SR,
                                         hop_length=hop)
    idx = torch.arange(t, device=y.device)
    fz = torch.where(idx[None, :] < mask_valid[:, None], y, 0.0).contiguous()
    spec = ms.stft_mag(fz, n_fft=4096, hop_length=hop, power=1.0)
    nvf = 1 + mask_valid // hop
    valid = torch.arange(spec.shape[-1], device=y.device)[None, :] < nvf[:, None]
    a_max = torch.where(valid[:, None, :], spec, 0.0).amax(dim=(1, 2), keepdim=True)
    return (spec / a_max).contiguous(), nvf


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_medians_breakdown: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    from audio_analysis_torch.ops import cuda as kcuda
    from audio_analysis_torch.ops import medians as md
    from chip_smoke import BATCH_SILENT_FROM, HBM_BYTES_PER_S, card_line, make_recording, time_ms

    print(f"card: {card_line()}", flush=True)
    fns = build_variants(kcuda.BUILD_ROOT / "medians_breakdown")
    dev = torch.device("cuda")
    one = np.stack([make_recording()])
    batch = np.stack([make_recording(silent_from=s, seed=i)
                      for i, s in enumerate(BATCH_SILENT_FROM)])
    for tag, pcm in (("one recording", one), ("fast batch", batch)):
        spec, nvf = detection_spectrogram(torch.from_numpy(pcm).to(dev))
        del pcm
        b, bins, t = spec.shape
        tail = spec[:1, :, int(nvf[0]):].contiguous()
        inputs = {"whole": spec, f"zero tail [1, {bins}, {tail.shape[-1]}]": tail,
                  "all zero": torch.zeros_like(spec)}
        bound = (spec.numel() + b * t) * 4 / HBM_BYTES_PER_S * 1e3
        print(f"{tag}: {list(spec.shape)}, valid frames {nvf.tolist()}; bound {bound:.4f} ms "
              "(bytes); ms:", flush=True)
        for what, x in inputs.items():
            out = torch.empty((x.shape[0], 1, x.shape[-1]), device=dev)

            def launch(fn):
                rc = fn(x.data_ptr(), out.data_ptr(), x.shape[0], bins, x.shape[-1],
                        kcuda.stream_of(x))
                kcuda.check(rc, "col_medians (breakdown)")

            launch(fns["full"])
            torch.cuda.synchronize()
            if not torch.equal(out, md.col_medians_plain(x)):
                raise AssertionError(f"{tag}, {what}: the full build differs from the plain "
                                     "version")
            times = {name: time_ms(lambda: launch(fn), 10) for name, fn in fns.items()}
            print(f"  {what:24s} " + "  ".join(f"{k} {v:.4f}" for k, v in times.items()),
                  flush=True)
            if what == "whole":
                hidden = times["staging only"] + times["search only"] - times["full"]
                print(f"  {'':24s} staging + search - full = {hidden:.4f} ms overlapped; "
                      f"full / bound = {times['full'] / bound:.2f}", flush=True)
        del spec, inputs, tail
        torch.cuda.empty_cache()
    print(f"card: {card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
