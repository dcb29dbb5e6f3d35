#!/usr/bin/env python3
"""The control of a cell's correctness check: the reference, put in the
program's place and computed one precision step below what the
configuration states, judged by the same comparison as a run. It has to
come out not correct; its smallest reading over the seeds is the upper
reading of each limit in ``benchmark/limits/<workload>.json``.

    python3 benchmark/control.py --workload NAME --seeds A B C [--device cuda]

One step below, in two variants: ``detect``, detection's float64 DFTs in
float32; ``classify``, at the exact level the classify frontend's float64
DFTs in float32 and the float32 classifiers with TF32 on, at the fast level
(bfloat16) the classifiers' and the frontend's operands rounded to
float8_e4m3fn. The recordings are those of a run with the seed, the sample
as many as a run checks. Prints one JSON line a seed and variant.
"""

import argparse
import json
import shutil
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE)]


def control_precisions(mix):
    """{variant: Precision}: detection's DFTs one step down, and the
    classify frontend and classifiers one step down. Lowered together,
    detection's differences hide the classifiers' (other tracks, no
    probabilities to compare), so each gives its own readings."""
    import torch

    from benchref.dsp import Precision

    if mix.get("env", {}).get("AAT_FAST") == "1":
        classify = Precision(cnn="fp8", fp8_frontend=True)
    else:
        classify = Precision(frontend_dft=torch.float32, cnn="tf32")
    return {"detect": Precision(detect_dft=torch.float32), "classify": classify}


def control_numbers(workload, seed, device, root=None, variant="classify"):
    """(numbers, rows, correct) of one variant of the control on one seed."""
    import numpy as np

    from benchlib import check
    from benchlib.serving import Serving, seed_of
    from benchlib.spec import ROOT, load_cell
    from benchref.analyse import Model, analyse, result_json

    cell = load_cell(workload, root or ROOT)
    workdir = Path(tempfile.mkdtemp(prefix="aat-control-"))
    try:
        base = Serving(cell, seed, device, workdir, False)
        prec = control_precisions(cell.mix)[variant]
        low = [Model(m.meta, type(m.net)(m.net.w, mode=prec.cnn)) for m in base.ref_models]
        cli = cell.mix["driver"] == "cli"
        rng_seed = seed_of(seed, 3) % (2 ** 31) if cli else None
        samples = []
        for i in base.sample_ids(len(base.pool)):
            rng = np.random.RandomState(rng_seed) if cli else None
            out = analyse(base.pool[i], low, rng=rng, prec=prec, device=device)
            samples.append({"pcm": base.pool[i], "rng": rng_seed, "groups": out["probs"],
                            "result": result_json(out, low, out["probs"], cli=cli)})
        numbers = check.judge(samples, base.ref_models, device, cli=cli)
        correct, rows = check.verdict(numbers, cell.limits)
        return numbers, rows, correct
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        for variant in ("detect", "classify"):
            numbers, _, correct = control_numbers(args.workload, seed, args.device,
                                                  variant=variant)
            print(json.dumps({"workload": args.workload, "seed": seed, "variant": variant,
                              "control_correct": correct, "numbers": numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
