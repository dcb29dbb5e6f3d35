"""Train a TuiNet classifier into a servable checkpoint dir (the JAX
package's tools/train_tuinet.py).

Data layout: DATA_DIR/<label>/*.wav; each file yields overlapping 3 s / 1.5 s
windows at the training rate (the serving geometry). The output dir
(metadata.txt + weights.npz, the JAX layout) is what both packages' analyse
CLIs and batch serving load.

    python -m audio_analysis_torch.cli.train DATA_DIR OUT_MODEL_DIR \\
        [--epochs 5] [--batch 64] [--lr 1e-3] [--device cuda]

Over several devices, one process a device under torchrun (NCCL on the
cards; gloo with ``--device cpu``):

    torchrun --nproc-per-node N -m audio_analysis_torch.cli.train DATA OUT \\
        [--model-parallel M]

Every rank draws the same seeded permutation and takes its rows of each
global batch (N / M data indices; the dense head split over M), so the
global batches are those of one process; rank 0 alone writes the
checkpoint, its head gathered whole. ``--model-parallel`` above 1 without
torchrun needs a world of that many ranks, and fails.
"""

import argparse
import sys
from pathlib import Path

import numpy as np


def load_dataset(data_dir: Path, sr: int, segment: float, stride: float, device=None):
    """(windows [N, segment * sr] float32, labels [N] int32, label names):
    every WAV under DATA_DIR/<label>/, resampled to `sr` (on `device` when
    its rate differs), cut into windows of `segment` s every `stride` s, a
    short tail zero-padded."""
    from audio_analysis_torch.io.audio import load_recording

    labels = sorted(p.name for p in data_dir.iterdir() if p.is_dir())
    windows, ys = [], []
    size = int(segment * sr)
    hop = int(stride * sr)
    for yi, label in enumerate(labels):
        for wav in sorted((data_dir / label).glob("*.wav")):
            frames, _ = load_recording(wav, resample=sr, device=device)
            for s in range(0, max(len(frames) - size + 1, 1), hop):
                w = frames[s : s + size]
                if len(w) < size:
                    w = np.pad(w, (0, size - len(w)))
                windows.append(w.astype(np.float32))
                ys.append(yi)
    return np.stack(windows), np.asarray(ys, np.int32), labels


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("data_dir")
    ap.add_argument("out_dir")
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--sr", type=int, default=48000)
    ap.add_argument("--n-mels", type=int, default=160)
    ap.add_argument("--hop-length", type=int, default=640)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="ranks that split the dense head (a mesh over every rank)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def run(argv=None):
    import os

    import torch

    from audio_analysis_torch.device import resolve_device
    from audio_analysis_torch.io.checkpoint import save_checkpoint
    from audio_analysis_torch.models.birdnet import TuiNetConfig
    from audio_analysis_torch.parallel import distributed
    from audio_analysis_torch.parallel.mesh import data_index, make_mesh
    from audio_analysis_torch.parallel.train import build_train, full_jax_params

    args = parse_args(argv)
    sharded = "WORLD_SIZE" in os.environ or args.model_parallel > 1
    dev = distributed.initialize(device=args.device) if sharded else resolve_device(args.device)
    try:
        mesh = make_mesh(model_parallel=args.model_parallel, device_type=dev.type) \
            if sharded else None
        lead = mesh is None or torch.distributed.get_rank() == 0
        say = print if lead else (lambda *a, **k: None)
        x, y, labels = load_dataset(Path(args.data_dir), args.sr, 3.0, 1.5, device=dev)
        say(f"dataset: {len(x)} windows, labels {labels}")

        cfg = TuiNetConfig(num_classes=len(labels), n_mels=args.n_mels)
        n_data, d = (1, 0) if mesh is None else (mesh.size(0), data_index(mesh))
        if args.batch % n_data:
            raise ValueError(f"--batch {args.batch} not divisible by the mesh's data={n_data}")
        net, optimizer, step = build_train(cfg, dev if mesh is None else None, sr=args.sr,
                                           hop_length=args.hop_length, lr=args.lr,
                                           seed=args.seed, mesh=mesh)
        per = args.batch // n_data
        rows = slice(d * per, (d + 1) * per)
        rng = np.random.RandomState(args.seed)
        n = len(x)
        steps = max(n // args.batch, 1)
        for epoch in range(args.epochs):
            order = rng.permutation(n)
            tot_loss = tot_acc = 0.0
            for s in range(steps):
                idx = order[s * args.batch : (s + 1) * args.batch]
                if len(idx) < args.batch:  # keep the batch shape
                    idx = np.concatenate([idx, order[: args.batch - len(idx)]])
                idx = idx[rows]  # this rank's rows of the global batch
                loss, acc = step(net, optimizer, torch.from_numpy(x[idx]).to(dev),
                                 torch.from_numpy(y[idx]).to(dev))
                tot_loss += float(loss)
                tot_acc += float(acc)
            say(f"epoch {epoch}: loss {tot_loss/steps:.4f} acc {tot_acc/steps:.3f}")

        params = full_jax_params(net, mesh)
        if lead:
            out = save_checkpoint(args.out_dir, params, checkpoint_meta(
                labels, args.n_mels, args.hop_length, cfg.channels))
            print(f"saved servable checkpoint to {out}")
    finally:
        if sharded:
            distributed.shutdown()
    return 0


def checkpoint_meta(labels, n_mels, hop_length, channels):
    """The trained checkpoint's metadata.txt: the JAX trainer's, the
    training frontend's settings (so serving computes the same features)."""
    return {
        "name": "tuinet",
        "architecture": "tuinet",
        "labels": list(labels),
        "segment_length": 3,
        "segment_stride": 1.5,
        "hop_length": hop_length,
        "n_mels": n_mels,
        "break_freq": 1750,
        "htk": True,
        "fmin": 50,
        "fmax": 11000,
        "power": 2,
        "db_scale": True,
        "threshold": 0.7,
        "n_fft": 4096,
        "normalize": True,
        "net_channels": list(channels),
    }


if __name__ == "__main__":
    sys.exit(run())
