"""One rank of multi-process serving (the JAX package's
tests/multihost_worker.py).

    python -m audio_analysis_torch.parallel.worker --model DIR --out FILE \\
        [--process-id I --num-processes N --coordinator file:///PATH]
        [--total-recordings 8] [--analyse-tracks] [--device cuda]

Each rank feeds only its own recordings (deterministic synthetic ones,
keyed by their global index) to a ``BatchAnalyzer`` over the mesh of every
rank; the output file receives the GLOBAL result list, so any rank's output
equals one process's run over all the recordings. With one process there
is no mesh. ``--model`` repeats: spectral and embeddings model dirs make a
multi-group analyzer.
"""

import argparse
import json
import sys

import numpy as np

SR = 48000
SECONDS = 8


def make_recording(global_idx: int) -> np.ndarray:
    """Deterministic synthetic recording keyed by its global index."""
    rng = np.random.RandomState(1000 + global_idx)
    t = np.arange(SECONDS * SR) / SR
    y = 0.01 * rng.randn(len(t)).astype(np.float32)
    # a frequency-swept chirp (survives the reference's 4x4 opening)
    t0 = 1.0 + 0.5 * (global_idx % 4)
    m = (t > t0) & (t < t0 + 1.2)
    phase = 2 * np.pi * ((2400 + 150 * global_idx) * t[m] + 220 * (t[m] - t0) ** 2)
    y[m] += (0.6 * np.sin(phase)).astype(np.float32)
    return y


def make_track_meta(global_idx: int) -> dict:
    """Deterministic sidecar-track metadata keyed by global index (for the
    --analyse-tracks leg); geometry stays inside the recording."""
    rng = np.random.RandomState(5000 + global_idx)
    tracks = []
    for j in range(1 + global_idx % 3):
        t0 = float(rng.uniform(0.0, SECONDS - 1.0))
        t1 = min(float(SECONDS), t0 + float(rng.uniform(0.3, 3.0)))
        tr = {"id": 10 * global_idx + j, "start": round(t0, 2), "end": round(t1, 2)}
        if j % 2:
            tr["minFreq"] = 500
            tr["maxFreq"] = 6000
        tracks.append(tr)
    return {"Tracks": tracks}


def serve(models, total, rank=0, n_ranks=1, mesh=None, analyse_tracks=False, device=None):
    """This rank's recordings (global indices rank * total / n_ranks on)
    through a ``BatchAnalyzer`` on `mesh` (or `device` without one); the
    analyzer's result list."""
    from audio_analysis_torch.pipeline.serve import BatchAnalyzer

    per_rank = total // n_ranks
    idx = range(rank * per_rank, (rank + 1) * per_rank)
    analyzer = BatchAnalyzer(list(models), sr=SR, bucket_seconds=SECONDS, rng=None, mesh=mesh,
                             device=None if mesh is not None else device)
    metas = [make_track_meta(i) for i in idx] if analyse_tracks else None
    return analyzer.analyse_recordings([make_recording(i) for i in idx], meta_data=metas,
                                       analyse_tracks=analyse_tracks)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    # repeatable: --model spec_dir --model emb_dir builds a multi-group
    # analyzer (embeddings dirs name their embedder in metadata.txt)
    ap.add_argument("--model", action="append", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--coordinator", default=None,
                    help="init method: file:///PATH, tcp://HOST:PORT or HOST:PORT")
    ap.add_argument("--total-recordings", type=int, default=8)
    ap.add_argument("--analyse-tracks", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--backend", default=None, help="default: nccl on cuda, gloo on cpu")
    args = ap.parse_args(argv)

    import torch

    from audio_analysis_torch.parallel import distributed as dist

    torch.set_num_threads(1)
    pid = args.process_id or 0
    mesh = None
    if args.num_processes > 1:
        dev = dist.initialize(args.coordinator, args.num_processes, pid, backend=args.backend,
                              device=args.device)
        mesh = dist.global_mesh(model_parallel=1, device_type=dev.type)
    try:
        results = serve(args.model, args.total_recordings, pid, args.num_processes, mesh,
                        args.analyse_tracks, args.device)
    finally:
        dist.shutdown()
    with open(args.out, "w") as f:
        json.dump(results, f)
    print(f"process {pid}: wrote {len(results)} results")
    return 0


if __name__ == "__main__":
    sys.exit(main())
