"""Dry-run hooks (the JAX package's __graft_entry__.py): a forward with
example arguments, and dry runs of the scale-out path over several ranks.

- ``entry()``: the flagship TuiNet's per-window probabilities (frontend +
  forward) and example PCM, on the card.
- ``dryrun_multichip(n)``: `n` ranks (gloo; on the card by default, placed
  round-robin over the visible GPUs), a ('data', 'model') mesh of
  n/2 x 2 on an even count, one sharded training step (DP over windows, TP
  over the dense head) on tiny shapes, then serving over the mesh, which
  must equal a meshless analyzer over the same recordings bit for bit, for
  a TuiNet alone and beside an embeddings group.
- ``dryrun_multiprocess(n_processes, devices_per_process)``: the same
  over n_processes x devices_per_process ranks (one process a device:
  the JAX package's devices of a process are ranks here), then the serving
  worker (``python -m audio_analysis_torch.parallel.worker``) in that many
  OS processes, every one of which must write the whole global result
  list.
"""

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

SR = 48000
SECONDS = 3


def entry(device=None):
    """(fn, example_args): fn(net, pcm) -> per-window probabilities [4, 8]
    of a full-width TuiNet (160 mels) over 3 s windows at 48 kHz, on
    `device` (None: the card)."""
    from audio_analysis_torch.device import resolve_device
    from audio_analysis_torch.models.birdnet import TuiNet, TuiNetConfig
    from audio_analysis_torch.pipeline.frontend import spectrogram_grid

    dev = resolve_device(device)
    cfg = TuiNetConfig(num_classes=8, n_mels=160)
    net = TuiNet.init(cfg, torch.Generator().manual_seed(0)).to(dev).eval()

    def forward(net, pcm):
        with torch.no_grad():
            feats = spectrogram_grid(pcm, sr=SR, hop_length=640, n_fft=4096, n_mels=cfg.n_mels,
                                     mel_break=1750.0, htk=True, power=2.0, db_scale=True,
                                     normalize=True)
            return torch.softmax(net(feats), dim=-1)

    pcm = torch.from_numpy(np.random.RandomState(0).randn(4, 3 * SR).astype(np.float32) * 0.1)
    return forward, (net, pcm.to(dev))


def _recording(i):
    """A 3 s recording with one tone, keyed by `i`."""
    rng = np.random.RandomState(100 + i)
    t = np.arange(SECONDS * SR) / SR
    y = 0.01 * rng.randn(len(t)).astype(np.float32)
    m = (t > 0.5) & (t < 1.5)
    y[m] += (0.5 * np.sin(2 * np.pi * (2000 + 300 * i) * t[m])).astype(np.float32)
    return y


def _write_dryrun_model(model_dir):
    """A tiny float32 TuiNet checkpoint dir (metadata.txt + weights.npz)."""
    from audio_analysis_torch.io.checkpoint import save_checkpoint
    from audio_analysis_torch.models.birdnet import TuiNet, TuiNetConfig

    cfg = TuiNetConfig(num_classes=4, n_mels=64, channels=(8,), dense_units=32, dtype="float32")
    net = TuiNet.init(cfg, torch.Generator().manual_seed(3))
    return save_checkpoint(model_dir, net.to_jax_params(), {
        "name": "tuinet", "architecture": "tuinet", "net_channels": [8],
        "net_stem_channels": 32, "net_dense_units": 32, "net_dtype": "float32",
        "labels": ["bird", "morepork", "human", "noise"], "segment_length": 3,
        "segment_stride": 1.5, "hop_length": 640, "n_mels": 64, "break_freq": 1750,
        "htk": True, "threshold": 0.2, "normalize": True, "db_scale": False,
    })


def _write_dryrun_embeddings_model(model_dir):
    """An embeddings pre-model group without a .keras archive: a dense head
    over 32-wide embeddings, whose metadata names a dense embedder
    (mean-pool to 32 values, then a linear layer)."""
    from audio_analysis_torch.io.checkpoint import save_checkpoint

    rng = np.random.RandomState(7)
    model_dir = Path(model_dir)
    embedder = save_checkpoint(
        model_dir.parent / (model_dir.name + "_embedder"),
        [{"kernel": rng.randn(32, 32).astype(np.float32) * 0.5,
          "bias": np.zeros(32, np.float32)}],
        {"architecture": "dense", "net_pool": 32, "output_activation": "linear", "labels": []})
    return save_checkpoint(
        model_dir,
        [{"kernel": rng.randn(32, 2).astype(np.float32), "bias": np.zeros(2, np.float32)}],
        {"name": "embeddings", "architecture": "dense", "labels": ["bird", "noise"],
         "segment_stride": 5, "threshold": 0.1, "pre_model": True,
         "embedding_model": str(embedder)})


def _dryrun_rank(model_parallel, model_dirs, device_type):
    """One rank of ``dryrun_multichip``; returns the step's loss and the
    number of results served."""
    import torch.distributed as dist

    from audio_analysis_torch.models.birdnet import TuiNetConfig
    from audio_analysis_torch.parallel.mesh import data_index, make_mesh, rank_device
    from audio_analysis_torch.parallel.train import build_train
    from audio_analysis_torch.pipeline.serve import BatchAnalyzer

    mesh = make_mesh(model_parallel=model_parallel, device_type=device_type)
    n, n_data, d = dist.get_world_size(), mesh.size(0), data_index(mesh)
    sr = 1600  # tiny: 3 s windows of 4,800 samples
    cfg = TuiNetConfig(num_classes=4, n_mels=32, channels=(8, 16), dense_units=64,
                       dtype="float32")
    net, opt, step = build_train(cfg, sr=sr, hop_length=64, lr=1e-3, mesh=mesh)
    batch = n * 2
    pcm = np.random.RandomState(0).randn(batch, 3 * sr).astype(np.float32)
    labels = np.arange(batch) % cfg.num_classes
    rows = slice(d * batch // n_data, (d + 1) * batch // n_data)
    dev = rank_device(mesh)
    loss, _ = step(net, opt, torch.from_numpy(pcm[rows]).to(dev),
                   torch.from_numpy(labels[rows]).to(dev))
    if not np.isfinite(float(loss)):
        raise AssertionError(f"sharded step loss {float(loss)}")

    # serving: n recordings, each data index feeding its block
    recs = [_recording(i) for i in range(n)]
    mine = recs[d * n // n_data : (d + 1) * n // n_data]
    served = 0
    for models in ([model_dirs[0]], list(model_dirs)):
        sharded = BatchAnalyzer(models, sr=SR, bucket_seconds=SECONDS, rng=None,
                                mesh=mesh).analyse_recordings(mine)
        single = BatchAnalyzer(models, sr=SR, bucket_seconds=SECONDS, rng=None,
                               device=dev).analyse_recordings(recs)
        if len(models) > 1 and not any(
                [r["model"] for r in t["model_results"]] == ["tuinet", "embeddings"]
                for rec in single for t in rec["species_identify"]):
            raise AssertionError("the mixed dry run produced no two-group track")
        if json.dumps(sharded, sort_keys=True) != json.dumps(single, sort_keys=True):
            raise AssertionError(f"mesh serving differs from the meshless analyzer ({models})")
        served = len(sharded)
    return {"loss": float(loss), "served": served, "mesh": tuple(mesh.shape)}


def dryrun_multichip(n_devices: int, device_type=None):
    """One sharded training step and mesh serving on `n_devices` ranks
    (gloo; `device_type` None: the card, else ``cpu``); raises when a rank
    fails. Returns each rank's summary."""
    from audio_analysis_torch.parallel.distributed import spawn

    model_parallel = 2 if n_devices % 2 == 0 else 1
    with tempfile.TemporaryDirectory(prefix="aat_dryrun_") as tmp:
        dirs = (str(_write_dryrun_model(Path(tmp) / "model")),
                str(_write_dryrun_embeddings_model(Path(tmp) / "emb")))
        return spawn(_dryrun_rank, n_devices, args=(model_parallel, dirs, device_type or "cuda"),
                     device=device_type, backend="gloo")


def dryrun_multiprocess(n_processes: int = 2, devices_per_process: int = 1, device_type=None):
    """``dryrun_multichip`` over n_processes x devices_per_process ranks,
    then the serving worker in that many processes joined through a file:
    every one must write the whole global result list, and all the same.
    Returns the ranks' summaries and that list."""
    n = n_processes * devices_per_process
    summaries = dryrun_multichip(n, device_type)
    with tempfile.TemporaryDirectory(prefix="aat_mp_") as tmp:
        tmp = Path(tmp)
        model_dir = _write_dryrun_model(tmp / "model")
        procs = []
        for pid in range(n):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "audio_analysis_torch.parallel.worker",
                 "--model", str(model_dir), "--out", str(tmp / f"out{pid}.json"),
                 "--process-id", str(pid), "--num-processes", str(n),
                 "--coordinator", f"file://{tmp / 'init'}", "--total-recordings", str(n),
                 "--device", device_type or "cuda", "--backend", "gloo"],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                cwd=Path(__file__).resolve().parents[2],
                env={**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parents[2])}))
        end, errs = time.monotonic() + 600, []
        try:
            for p in procs:
                _, err = p.communicate(timeout=max(end - time.monotonic(), 1))
                errs.append(err)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        if any(p.returncode != 0 for p in procs):
            raise RuntimeError("multi-process dry run failed:\n" + "\n---\n".join(errs)[-4000:])
        outs = [json.loads((tmp / f"out{pid}.json").read_text()) for pid in range(n)]
        if any(len(o) != n or o != outs[0] for o in outs):
            raise AssertionError(f"ranks wrote {[len(o) for o in outs]} results, or not the same")
        return summaries, outs[0]
