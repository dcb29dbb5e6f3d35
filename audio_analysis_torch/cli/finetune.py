"""Fine-tune a released ``.keras`` classifier on labelled audio (the JAX
package's tools/finetune_keras.py).

Takes a model dir (audioModel.keras + metadata.txt) and a data dir laid out
DATA_DIR/<label>/*.wav, and writes OUT_DIR with the tuned audioModel.keras
(written without h5py by io/keras_export.py; tf.keras and both packages
read it), an updated metadata.txt and the model dir's other ``*.json``
files. When the data's labels differ from the checkpoint's, the head is
replaced and metadata.txt carries the new label space.

    python -m audio_analysis_torch.cli.finetune MODEL_DIR DATA_DIR OUT_DIR \\
        [--epochs 5] [--batch 64] [--lr 1e-4] [--seed 0] [--device cuda]

Data-parallel over N devices, one process a device under torchrun:

    torchrun --nproc-per-node N -m audio_analysis_torch.cli.finetune \\
        MODEL_DIR DATA_DIR OUT_DIR --mesh data=N

Every rank draws the same seeded permutation and takes its rows of each
global batch (the batch must divide by N); rank 0 alone writes OUT_DIR.
"""

import argparse
import json
import shutil
import sys
from pathlib import Path

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("model_dir")
    ap.add_argument("data_dir")
    ap.add_argument("out_dir")
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default=None, help="e.g. data=8: data-parallel over 8 ranks")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def mesh_size(spec):
    """N from ``data=N`` (the JAX tool's --mesh)."""
    axis, _, n = (spec or "").partition("=")
    if axis != "data" or not n.isdigit() or int(n) < 1:
        raise ValueError(f"--mesh takes data=N, got {spec!r}")
    return int(n)


def run(argv=None):
    import os

    from audio_analysis_torch.device import resolve_device
    from audio_analysis_torch.parallel import distributed
    from audio_analysis_torch.parallel.mesh import data_index, make_mesh

    args = parse_args(argv)
    sharded = args.mesh is not None or "WORLD_SIZE" in os.environ
    if not sharded:
        return _tune(args, resolve_device(args.device), None, 0)
    n = mesh_size(args.mesh) if args.mesh else None
    dev = distributed.initialize(device=args.device)
    try:
        mesh = make_mesh(n_devices=n, model_parallel=1, device_type=dev.type)
        return _tune(args, dev, mesh, data_index(mesh))
    finally:
        distributed.shutdown()


def _tune(args, dev, mesh, d):
    """The fine-tune on `dev`, or on this rank of `mesh` (data index `d`)."""
    import torch

    from audio_analysis_torch.cli.train import load_dataset
    from audio_analysis_torch.io.keras_export import write_keras_archive
    from audio_analysis_torch.io.modelconfig import ModelConfig
    from audio_analysis_torch.models.keras_graph import KerasModel
    from audio_analysis_torch.parallel.finetune import build_finetune, replace_head
    from audio_analysis_torch.pipeline.classify import features_for_config

    lead = mesh is None or torch.distributed.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    model_dir = Path(args.model_dir)
    cfg = ModelConfig.load(model_dir)
    sr = 48000
    windows, ys, labels = load_dataset(Path(args.data_dir), sr, cfg.segment_length,
                                       cfg.segment_stride, device=dev)
    km = KerasModel.load(model_dir)
    if labels != list(cfg.labels):
        say(f"label space changed {list(cfg.labels)} -> {labels}: replacing head")
        replace_head(km, len(labels), seed=args.seed)

    def feats(pcm):
        # the serving frontend, the EfficientNet 3-channel repeat included:
        # training features must be what pipeline/classify.py feeds
        with torch.no_grad():
            x = features_for_config(pcm, sr, cfg)
        return x.repeat_interleave(3, dim=-1) if cfg.is_efficientnet else x

    if mesh is None:
        params, optimizer, step = build_finetune(km, dev, lr=args.lr)
    else:
        params, optimizer, step = build_finetune(km, lr=args.lr, mesh=mesh)
    rng = np.random.RandomState(args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    n = len(windows)
    batch = min(args.batch, n)
    if batch < 2:
        sys.exit(f"need at least 2 training windows, found {n}")
    n_data = 1 if mesh is None else mesh.size(0)
    if batch % n_data:
        raise ValueError(f"batch {batch} not divisible by the mesh's data={n_data}")
    per = batch // n_data
    loss = acc = float("nan")
    for epoch in range(args.epochs):
        order = rng.permutation(n)
        for lo in range(0, n, batch):
            idx = order[lo : lo + batch]
            if len(idx) < batch:
                # keep the batch shape: wrap the tail with the start of this
                # epoch's shuffle, so every window counts each epoch
                idx = np.concatenate([idx, order[: batch - len(idx)]])
            idx = idx[d * per : (d + 1) * per]  # this rank's rows
            loss, acc = step(params, optimizer, feats(torch.from_numpy(windows[idx]).to(dev)),
                             torch.from_numpy(ys[idx]).to(dev), gen)
        say(f"epoch {epoch}: loss {float(loss):.4f} acc {float(acc):.3f}")
    if not lead:
        return 0

    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    write_keras_archive(model_dir, params, out / "audioModel.keras", config=km.config)
    meta = dict(cfg.raw or {})
    meta["labels"] = labels
    if labels != list(cfg.labels):
        # stale per-label fields would misalign with the new head
        for k in ("ebird_ids", "bird_labels"):
            meta.pop(k, None)
    (out / "metadata.txt").write_text(json.dumps(meta, indent=4, sort_keys=True))
    for extra in model_dir.glob("*.json"):
        shutil.copy(extra, out / extra.name)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(run())
