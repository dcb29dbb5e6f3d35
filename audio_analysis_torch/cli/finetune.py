"""Fine-tune a released ``.keras`` classifier on labelled audio (the JAX
package's tools/finetune_keras.py, on one device).

Takes a model dir (audioModel.keras + metadata.txt) and a data dir laid out
DATA_DIR/<label>/*.wav, and writes OUT_DIR with the tuned audioModel.keras
(written without h5py by io/keras_export.py; tf.keras and both packages
read it), an updated metadata.txt and the model dir's other ``*.json``
files. When the data's labels differ from the checkpoint's, the head is
replaced and metadata.txt carries the new label space.

    python -m audio_analysis_torch.cli.finetune MODEL_DIR DATA_DIR OUT_DIR \\
        [--epochs 5] [--batch 64] [--lr 1e-4] [--seed 0] [--device cuda]
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
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def run(argv=None):
    import torch

    from audio_analysis_torch.cli.train import load_dataset
    from audio_analysis_torch.device import resolve_device
    from audio_analysis_torch.io.keras_export import write_keras_archive
    from audio_analysis_torch.io.modelconfig import ModelConfig
    from audio_analysis_torch.models.keras_graph import KerasModel
    from audio_analysis_torch.parallel.finetune import build_finetune, replace_head
    from audio_analysis_torch.pipeline.classify import features_for_config

    args = parse_args(argv)
    dev = resolve_device(args.device)
    model_dir = Path(args.model_dir)
    cfg = ModelConfig.load(model_dir)
    sr = 48000
    windows, ys, labels = load_dataset(Path(args.data_dir), sr, cfg.segment_length,
                                       cfg.segment_stride, device=dev)
    km = KerasModel.load(model_dir)
    if labels != list(cfg.labels):
        print(f"label space changed {list(cfg.labels)} -> {labels}: replacing head")
        replace_head(km, len(labels), seed=args.seed)

    def feats(pcm):
        # the serving frontend, the EfficientNet 3-channel repeat included:
        # training features must be what pipeline/classify.py feeds
        with torch.no_grad():
            x = features_for_config(pcm, sr, cfg)
        return x.repeat_interleave(3, dim=-1) if cfg.is_efficientnet else x

    params, optimizer, step = build_finetune(km, dev, lr=args.lr)
    rng = np.random.RandomState(args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    n = len(windows)
    batch = min(args.batch, n)
    if batch < 2:
        sys.exit(f"need at least 2 training windows, found {n}")
    loss = acc = float("nan")
    for epoch in range(args.epochs):
        order = rng.permutation(n)
        for lo in range(0, n, batch):
            idx = order[lo : lo + batch]
            if len(idx) < batch:
                # keep the batch shape: wrap the tail with the start of this
                # epoch's shuffle, so every window counts each epoch
                idx = np.concatenate([idx, order[: batch - len(idx)]])
            loss, acc = step(params, optimizer, feats(torch.from_numpy(windows[idx]).to(dev)),
                             torch.from_numpy(ys[idx]).to(dev), gen)
        print(f"epoch {epoch}: loss {float(loss):.4f} acc {float(acc):.3f}")

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
