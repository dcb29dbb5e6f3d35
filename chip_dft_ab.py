#!/usr/bin/env python3
"""The DFT kernels' main-path plans in two checkouts, on one GPU: bit for
bit, and timed in turns.

    python3 chip_dft_ab.py TREE_A TREE_B

Builds ``audio_analysis_torch/csrc/stft.cu`` and ``stft_bf16.cu`` of each
checkout into its own libraries (one nvcc each, all started together), then
drives the float64 fft route's entry points of both (``aat_stft_mag_fft``,
``aat_stft_mel_fft``) and the fast level's dif route
(``aat_stft_mel_dif_bf16``), each with the same C interface in both, with
this checkout's host tables, on the inputs the main paths give them: the
seeded 60 s recording of chip_smoke.py (the detection |STFT| at n_fft 4096
and 4410, and the end-scan at 4800), 64 normalised 3 s windows of it (the
classify frontend at 4096), and eight recordings silent from their own
points (the fast batch's |STFT| and its end-scan on the dif route). For
each float64 shape it requires the two trees' outputs equal bit for bit;
for each dif shape (where the trees may sum in different orders) each
tree's output within 1e-2 max rel of this checkout's
``stft_mel_dif_bf16_plain``; for every shape each tree's two launches
equal bit for bit. It times the kernel of each tree in turns, A B B A, 10
launches a turn after a warm-up (CUDA events). Prints one JSON line a
shape, then the card's name and power limit.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent


ENTRIES = {"stft.cu": ("aat_stft_mag_fft", "aat_stft_mel_fft"),
           "stft_bf16.cu": ("aat_stft_mel_dif_bf16",)}


def build(trees, out_dir):
    """{tree: (aat_stft_mag_fft, aat_stft_mel_fft, aat_stft_mel_dif_bf16)}
    from each tree's stft.cu and stft_bf16.cu."""
    from audio_analysis_torch.ops import cuda as kcuda

    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, tree in enumerate(trees):
        for source in ENTRIES:
            so = out_dir / f"{Path(source).stem}_{i}.so"
            cmd = [kcuda.nvcc(), *kcuda.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                   "-shared", str(Path(tree) / "audio_analysis_torch" / "csrc" / source),
                   "-o", str(so)]
            procs.append((tree, source, so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    fns = {tree: [] for tree in trees}
    for tree, source, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {tree}'s {source}:\n{log}")
        lib = ctypes.CDLL(str(so))
        for name in ENTRIES[source]:
            fn = getattr(lib, name)
            fn.argtypes = kcuda._SIGNATURES[name]
            fn.restype = ctypes.c_int
            fns[tree].append(fn)
    return {tree: tuple(f) for tree, f in fns.items()}


def main():
    import torch

    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_dft_ab: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    from audio_analysis_torch.ops import cuda as kcuda
    from audio_analysis_torch.ops import melspec as ms
    from audio_analysis_torch.ops.scale import normalize_minmax
    from chip_smoke import (BATCH_SILENT_FROM, SILENT_FROM, SR, card_line, make_recording,
                            max_rel, time_ms)

    trees = sys.argv[1:]
    print(f"card: {card_line()}", flush=True)
    fns = build(trees, kcuda.BUILD_ROOT / "dft_ab")
    dev = torch.device("cuda")
    rec = torch.from_numpy(make_recording()).to(dev)[None]
    batch = torch.from_numpy(np.stack([make_recording(silent_from=s, seed=i)
                                       for i, s in enumerate(BATCH_SILENT_FROM)])).to(dev)
    sample = 3 * SR
    bases = np.arange(64) * ((int(SILENT_FROM * SR) - sample) // 64)
    grid = normalize_minmax(torch.stack([rec[0, b:b + sample] for b in bases])).contiguous()
    stream = kcuda.stream_of(rec)

    def mag_call(fn, y, n_fft, hop):
        b, t = y.shape
        n_frames = ms.stft_frames(t, n_fft, hop)
        route, tf = ms.stft_plan(n_fft, n_fft // 2 + 1, mel=False)
        assert route == "fft", (n_fft, route)
        win, cs, sn, radix = ms._dft_consts(n_fft, "fft", dev)
        out = torch.empty((b, n_fft // 2 + 1, n_frames), device=dev)

        def run():
            kcuda.check(fn(y.data_ptr(), win.data_ptr(), cs.data_ptr(), sn.data_ptr(),
                           radix.data_ptr(), radix.numel(), out.data_ptr(), b, t, n_fft, hop,
                           n_frames, 1.0, tf, stream), "stft_mag (A/B)")
            return out
        return run

    def mel_call(fn, x, n_fft, hop, n_mels, power, frames=None):
        n, s = x.shape
        n_out = frames or ms.stft_frames(s, n_fft, hop)
        fb, lo, hi = ms._mel_consts(SR, n_mels, 50.0, 11000.0, n_fft, 1750.0, True, dev)
        route, tf = ms.stft_plan(n_fft, fb.shape[1], mel=True)
        assert route == "fft", (n_fft, route)
        win, cs, sn, radix = ms._dft_consts(n_fft, "fft", dev)
        out = torch.empty((n, n_mels, n_out), device=dev)

        def run():
            kcuda.check(fn(x.data_ptr(), win.data_ptr(), cs.data_ptr(), sn.data_ptr(),
                           radix.data_ptr(), radix.numel(), fb.data_ptr(), lo.data_ptr(),
                           hi.data_ptr(), out.data_ptr(), n, s, n_fft, hop, n_out, fb.shape[1],
                           n_mels, power, tf, stream), "stft_mel (A/B)")
            return out
        return run

    def dif_call(fn, x, n_fft, hop, n_mels, power, frames=None):
        n, s = x.shape
        n_out = frames or 1 + s // hop
        win, twc, tws, ct, st, melt, levels, nb, bl = ms._dif_consts(
            SR, n_mels, 50.0, 11000.0, n_fft, 1750.0, True, dev)
        out = torch.empty((n, n_mels, n_out), device=dev)

        def run():
            kcuda.check(fn(x.data_ptr(), win.data_ptr(), twc.data_ptr(), tws.data_ptr(),
                           ct.data_ptr(), st.data_ptr(), melt.data_ptr(), out.data_ptr(), n, s,
                           n_fft, levels, ct.shape[1], hop, n_out, nb, bl, melt.shape[0],
                           n_mels, power, stream), "stft_mel_bf16 dif (A/B)")
            return out
        run.plain = lambda: ms.stft_mel_dif_bf16_plain(
            x, sr=SR, n_fft=n_fft, hop_length=hop, n_mels=n_mels, fmin=50.0, fmax=11000.0,
            power=power, frames=frames)
        return run

    chunk = SR // 281
    end_frames = ((1 + rec.shape[1] // 281) // chunk) * chunk
    shapes = {
        "stft_mag n_fft 4096 [1, 2.88M]": lambda f: mag_call(f[0], rec, 4096, 281),
        "stft_mag n_fft 4096 batch [8, 2.88M]": lambda f: mag_call(f[0], batch, 4096, 281),
        "stft_mag n_fft 4410 [1, 2.88M]": lambda f: mag_call(f[0], rec, 4410, 256),
        "stft_mel n_fft 4096 classify [64, 144000]": lambda f: mel_call(f[1], grid, 4096, 640,
                                                                        160, 2.0),
        "stft_mel n_fft 4800 end-scan [1, 2.88M]": lambda f: mel_call(f[1], rec, 4800, 281, 120,
                                                                      1.0, end_frames),
        "stft_mel_bf16 dif n_fft 4096 classify [64, 144000]": lambda f: dif_call(
            f[2], grid, 4096, 640, 160, 2.0),
        "stft_mel_bf16 dif n_fft 4800 end-scan [1, 2.88M]": lambda f: dif_call(
            f[2], rec, 4800, 281, 120, 1.0, end_frames),
        "stft_mel_bf16 dif n_fft 4800 end-scan batch [8, 2.88M]": lambda f: dif_call(
            f[2], batch, 4800, 281, 120, 1.0, end_frames),
    }
    for tag, make in shapes.items():
        runs = {tree: make(fns[tree]) for tree in trees}
        got = {tree: run().clone() for tree, run in runs.items()}
        repeat = {tree: bool(torch.equal(got[tree], run())) for tree, run in runs.items()}
        torch.cuda.synchronize()
        line = {"shape": tag, "repeat_bit_for_bit": repeat}
        plain = getattr(runs[trees[0]], "plain", None)
        if plain is None:  # float64: the trees agree bit for bit
            line["bit_for_bit"] = bool(torch.equal(got[trees[0]], got[trees[1]]))
            ok = line["bit_for_bit"]
        else:  # dif: each tree within 1e-2 of the plain version
            ref = plain()
            line["max_rel_vs_plain"] = {tree: max_rel(got[tree], ref) for tree in trees}
            ok = all(r <= 1e-2 for r in line["max_rel_vs_plain"].values())
            del ref
        turns = [(tree, time_ms(runs[tree], 10)) for tree in trees + trees[::-1]]
        line["ms"] = {tree: [t for name, t in turns if name == tree] for tree in trees}
        print(json.dumps(line), flush=True)
        if not ok or not all(repeat.values()):
            raise AssertionError(f"{tag}: {line}")
    print(f"card: {card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
