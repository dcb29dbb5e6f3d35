#!/usr/bin/env python3
"""Warm wall times of the TuiNet and EfficientNetB0 paths of two checkouts,
in turns on one GPU.

    python3 chip_ab_host.py TREE_A TREE_B [--runs 9]

Runs eight turns, A B B A A B B A (warm walls of one tree differ by tens
of ms a batch between processes, more than four turns resolve), each in a
fresh process with that checkout first on sys.path: the process builds the
checkout's kernels and writes its chip_smoke.py fixtures (a seeded 60 s
WAV and a full-width float32 TuiNet; 8 seeded 60 s WAVs with a bird and a
pre-model TuiNet in bfloat16), runs the analyse CLI at the exact level once cold and
``--runs`` times warm, then the ``AAT_FAST=1`` batch CLI (8 x 60 s) once
cold and ``--runs`` times warm, then writes the seeded EfficientNetB0
fixture and times its forward alone on a [64, 160, 226, 3] grid in float32
and bfloat16 (ms a forward over 10, CUDA events, ``--runs`` times) and the
exact analyse CLI with it once cold and ``--runs`` times warm, and prints
one JSON line with every warm time. The last line gives, per tree, the
median of its warm samples over all its turns. Host-clock times: compare
two trees only within one call.
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

TURN = r"""
import json, os, sys, tempfile, time
from pathlib import Path
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
from audio_analysis_torch.io.audio import write_wav
from audio_analysis_torch.ops import cuda as kcuda

runs = int(sys.argv[2])
kcuda.library()
os.environ.pop("AAT_FAST", None)
with tempfile.TemporaryDirectory() as tmp:
    tmp = Path(tmp)
    wav = tmp / "rec60.wav"
    write_wav(wav, cs.make_recording(), cs.SR)
    model = cs.write_tuinet_model(tmp / "tuinet")
    cs.run_cli(wav, model, "cuda")
    exact = [cs.run_cli(wav, model, "cuda")[1] for _ in range(runs)]
    wavs = []
    for i in range(8):
        wavs.append(tmp / f"batch{i}.wav")
        write_wav(wavs[-1], cs.make_recording(silent_from=cs.BATCH_SILENT_FROM[i], seed=i), cs.SR)
    models = [cs.write_tuinet_model(tmp / "bird", seed=0, net_dtype=None, name="bird-model"),
              cs.write_tuinet_model(tmp / "pre", seed=2, labels=cs.PRE_LABELS, net_dtype=None,
                                    pre_model=True, name="pre-model")]
    os.environ["AAT_FAST"] = "1"
    cs.run_batch_cli(wavs, models, "cuda")
    batch = [cs.run_batch_cli(wavs, models, "cuda")[1] for _ in range(runs)]
    os.environ.pop("AAT_FAST")
    import torch
    from audio_analysis_torch.models import KerasModel
    eff = cs.efficientnet_fixture(tmp / "effnet")
    grid = cs.effnet_grid(cs.make_recording())
    forward = {}
    with torch.inference_mode():
        for dtype in ("float32", "bfloat16"):
            net = KerasModel.load(eff / "audioModel.keras", compute_dtype=dtype).to("cuda")
            net(grid)
            forward[dtype] = [cs.time_ms(lambda: net(grid), 10) for _ in range(runs)]
    cs.run_cli(wav, eff, "cuda")
    eff_exact = [cs.run_cli(wav, eff, "cuda")[1] for _ in range(runs)]
print(json.dumps({"tree": sys.argv[1], "exact_warm_s": exact, "batch_warm_s": batch,
                  "effnet_f32_ms": forward["float32"], "effnet_bf16_ms": forward["bfloat16"],
                  "effnet_exact_warm_s": eff_exact}))
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("tree_a")
    ap.add_argument("tree_b")
    ap.add_argument("--runs", type=int, default=9)
    args = ap.parse_args()
    trees = [str(Path(t).resolve()) for t in (args.tree_a, args.tree_b)]
    samples = {t: {k: [] for k in ("exact_warm_s", "batch_warm_s", "effnet_f32_ms",
                                   "effnet_bf16_ms", "effnet_exact_warm_s")} for t in trees}
    for tree in (trees[0], trees[1], trees[1], trees[0]) * 2:
        out = subprocess.run([sys.executable, "-c", TURN, tree, str(args.runs)], cwd=tree,
                             capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            print(out.stdout[-4000:] + out.stderr[-4000:], file=sys.stderr)
            return 1
        turn = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(turn), flush=True)
        for k in samples[tree]:
            samples[tree][k] += turn[k]
    print(json.dumps({t: {k: statistics.median(v) for k, v in s.items()}
                      for t, s in samples.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
