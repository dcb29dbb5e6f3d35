#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (audio_analysis_torch) end to end on one GPU.

    python3 chip_smoke.py

1. prints whether h5py and tensorflow can be imported (the port needs
   neither), the card's name and power limit, and the torch/CUDA versions;
2. builds the CUDA kernels from audio_analysis_torch/csrc (one nvcc per
   source, all started together; sm_90a);
3. writes fixtures into a temporary directory: a seeded 60 s, 48 kHz,
   16-bit WAV (noise and chirps, then a digitally silent tail that the
   end-scan finds), a full-width float32 TuiNet model dir (160 mels;
   channels 64/128/256, stem 32, dense 256) with weights drawn from a seed,
   24 more seeded 60 s WAVs with silent tails at different points (some
   with none), and two full-width TuiNet dirs at TuiNet's default bfloat16
   (a bird model with 8 labels and a pre-model with 3);
4. holds each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it and on the fixtures' data, and times the
   kernel, the plain version and, where one exists, a single PyTorch call
   computing the same function (CUDA events). The float64 DFTs (stft_mel,
   stft_mag) must agree to max rel 1e-6 and bit for bit across two
   launches; stft_mag is timed beside torch.stft in float32 and in float64;
   both are held and timed at the other routes' n_fft, each route
   asserted: 4400 (2^4 5^2 11, fft1 with a radix-11 pass in place), 8192
   (fft1, too large for two buffers), the prime 4099 (bluestein) and the
   cluster route (the transform split over a thread-block cluster, with its
   plan and how many such clusters the card holds): the prime 6301
   (Bluestein over two blocks), 16384 and 32768, and stft_mel at 12000,
   stft_mag at 12800; stft_mel on the classify grid
   (with its time over the n_fft 4096 classify's), stft_mag on the whole
   recording beside float64 torch.stft;
   row_medians and col_medians bit for bit against their plain versions and
   np.median;
   stft_mel_bf16 against the plain version of its route (``dif`` for
   n_fft % 8 == 0, ``direct`` for n_fft 500 and the prime 4099 on the
   classify grid; the dif route's deep splits on 16 classify windows:
   n_fft 24000 and 32768 at 6 levels, 32768 over the whole band at 256
   mels at 7 (no band list) and with Slaney's bank at 8) to max rel 1e-2
   and bit for bit across two launches, with
   its max rel against the float64 plain version for information, and at
   classify [64, 144000] and the end-scan [1, 2.88M] the direct route at
   the same shape (AAT_PALLAS_ALG=matmul) held the same way against its
   plain version and timed beside it and the float64 FFT ``stft_mel``;
5. the exact level's single-recording path: runs the port's CLI
   (``analyse -o FILE --bird-model DIR --seed 0``) in this process on the
   card, cold and then warm, with every kernel's launch count set to 0 just
   before and read just after each run (neither the one-buffer routes nor
   the cluster route may run), then once more under
   torch.profiler (device busy time, idle share, device time by kernel);
   reproduces the committed golden snapshot on the card, and runs the CLI
   once more with ``--device cpu`` (the plain versions) and requires the
   card's result to equal it: signals, length, chirps, cacophony index and
   labels identical, confidences within 1; runs the CLI with a full-width
   TuiNet whose metadata sets n_fft 8192 (cold, warm; stft_mel's fft1
   route at least once) and requires the card's result to equal the CPU's
   the same way; the same with a full-width TuiNet whose metadata sets
   n_fft 16384 (stft_mel's cluster route at least once; cold, warm,
   profiled, CPU); holds the packed-word detection
   morphology against its float max-pool plain version bit for bit on the
   cold run's own [1, 2049, T] spectrogram and medians (device ms of both,
   the host's time to enqueue it, its kernel count);
   then the same recording written at 44.1, 32 and 96 kHz, each loaded
   through ``load_recording`` on the card and on the CPU (48 kHz, within
   RESAMPLE_TOL; the card's resample timed beside its bound), and the CLI on the 44.1 kHz WAV (cold, warm, CPU;
   the same launches as at 48 kHz); then the CLI with two band-pass TuiNets
   (``filter_below: 9000`` and ``filter_freq: true``) on the card and on the
   CPU: at least one track filtered and labelled, the filter's time on the
   captured track stack;
6. the fast level's batch path: runs the batch CLI (``AAT_FAST=1``,
   ``batch -o --bird-model B --bird-model PRE --batch-size 8 --seed 0`` on
   the first eight WAVs) cold and then warm with the counts reset around each
   run, requires stft_mel_bf16 twice per batch, stft_mel and the bf16
   direct route never, prints the wall time, audio seconds per second and stage
   times, and holds stft_mel_bf16, stft_mag, row_medians and col_medians
   against their plain versions on the inputs the cold batch gave them (the
   [8, T] end-scan and the batch's padded classify grid, each also timed
   beside the direct route and stft_mel; the [8, T] detection signals, each
   zeroed past its own data end; the [8, 2049, T] normalised spectrogram,
   for both medians);
   holds the packed-word detection morphology against its float max-pool
   plain version bit for bit on the batch's own spectrogram and medians
   (device ms of both, the host's time to enqueue it, its kernel count),
   profiles one detection of the batch (no max-pool kernel may run),
   then runs a backlog of 24 WAVs (three batches through the pipelined
   stream) and prints its audio seconds per second over the whole run,
   profiles one more warm batch, and runs the first four WAVs with
   ``--device cpu`` and requires the card's results to equal them
   (confidences within 2: the bf16 TuiNet's convolutions round at other
   places on cuDNN and the CPU); then the batch again with a band-pass bird
   model (``filter_below: 9000``) and the pre-model, cold and warm (equal),
   the first two on the CPU (confidences within 2); then the batch with a
   bird TuiNet alone whose metadata sets n_fft 4410 (its classify frontend
   on stft_mel_bf16's direct route, once a batch; the end-scan on the dif
   route), cold and warm (equal), the first two on the CPU (confidences
   within 2), and the direct route held against its plain version on the
   classify grid the cold batch gave it;
7. EfficientNetB0 (``efficientnet_fixture``: the committed zero-weight
   archive with seeded weights, read by the port's HDF5 reader): alone on a
   [64, 160, 226, 3] grid of the recording's features, float32 on the card
   against the CPU (max abs <= 1e-4) and bfloat16 against float32 on the
   card (max abs <= 0.15, mean <= 0.02, no clear argmax changed), ms per
   forward at both dtypes with windows/s, and the host's time to enqueue a
   forward against its wall and device busy time (torch.profiler); then the
   exact analyse CLI with it as the bird model (cold, warm, CPU; the card's
   result equals the CPU's, confidences within 1, labels present), and the
   ``AAT_FAST=1`` batch CLI on the eight WAVs with it (bfloat16 by the
   preset; cold, warm, profiled, the first two on the CPU, confidences
   within 2); every kernel count is reset around each run and checked as on
   the TuiNet paths, and the batch's profile may hold no max-pool kernel;
7b. the upload path (``check_upload``): the native PCM encoder builds
   (``native/pcmcodec.cpp``); the card's decode (``io/pcmcodec.py``) equals
   ``decode_pcm_np`` bit for bit on the fast batch's 8 WAVs and on a
   hand-built encoding (``codec_edge_case``: a width-32 tier, exceptions in
   a width-0 block, int32 wraparound) at orders 0-3; the exact CLI and the
   fast batch equal with AAT_WIRE_CODEC 0 and 1, the 24-WAV backlog equal
   through the stream (dispatch on the caller's thread) and through a
   one-worker dispatch (the JAX package's AAT_ASYNC_UPLOAD default, timed
   here as the alternative the port does not take) with the codec on and
   off, every stream run's launches
   checked; the encode's host ms, the wire ratio, the decode's ms and
   device operations against the pinned raw copy's, the exact CLI's warm
   wall with the codec on and off (A B B A B A A B) and the backlog's
   audio-s/s in the four settings (forwards, then backwards: ten pairs of
   stream and worker a codec setting, with the worker's wins); a morepork
   member with a stale conversion raises the JAX package's RuntimeError
   with tensorflow hidden, a current one loads; one exact CLI run under
   AAT_TRACE_DIR leaves a trace naming ``stft_mag_fft_kernel`` and
   ``row_medians_kernel``;
8. ``analyse --old-cacophony-index`` on the 48 kHz and the 44.1 kHz WAV,
   the card's table equal to the CPU's;
9. the side paths (``check_morepork``, ``check_embeddings``,
   ``check_mfcc``), each card run against a CPU run with every kernel
   count reset around it: ``analyse --morepork-model`` with a three-member
   ensemble of seeded CNNs laid out as converted SavedModels, at 48 and
   44.1 kHz (cold, warm, CPU; spans identical and not empty; no kernel of
   the repo launched), with the |STFT|'s, the samples' and each member's
   ms and one profiled run; the exact analyse CLI with an embeddings group
   (a seeded Conv1D embedder, 5 s at 32 kHz in, a 1,280-wide embedding
   out, and a Dense head) and a full-width TuiNet pre-model group, with the
   resample's, the window gather's and the embedder's ms; the AAT_FAST=1
   batch with the embeddings group and the bfloat16 pre-model, and with the
   embeddings group alone; a full-width TuiNet with ``use_mfcc`` on the
   exact CLI and the fast batch, and the frontend's ms over [64, 144000]
   with mfcc off and on at both levels;
10. training (``check_training``): a full-width TuiNet from seeded weights
   carried in, its first step's loss and gradients against the CPU (through
   ``loss_fn``, and on positive features so that every conv gradient is
   nonzero; TF32 off), then ``make_train_step`` at batch 64 of 3 s windows
   ([64, 144000]) in float32 and bfloat16 at the exact level and bfloat16
   under AAT_FAST=1: ms a step (CUDA events), windows/s, peak memory, one
   profiled step, the kernel launches a step (stft_mel 1, or the dif route
   of stft_mel_bf16 1); the trained checkpoint saved and served by the
   exact analyse CLI on the card and the CPU; then EfficientNetB0 with a new
   4-label head fine-tuned at batch 32 on [32, 160, 226, 3] (features each
   step, as the fine-tune CLI takes them), the same numbers, exported
   without h5py, read back leaf for leaf and served by the exact CLI on the
   card and the CPU;
11. scale-out over torch.distributed (``check_scaleout``): a world of one
   rank on NCCL, ``BatchAnalyzer(mesh=make_mesh())`` on the eight WAVs
   under AAT_FAST=1 equal to the meshless analyzer byte for byte; then two
   ranks spawned on the one card (gloo; NCCL refuses two ranks on one GPU),
   each fed four of the eight WAVs at the exact level (the float32 TuiNet)
   and under AAT_FAST=1 (the bird and pre TuiNets): the gathered list, on
   both ranks, equal to this process's analyzer fed the same two batches
   bit for bit and to one 8-WAV batch within the result contract
   (confidences within 1; 2 for the bfloat16 models), each rank launching
   stft_mag, row_medians, col_medians and stft_mel (exact) or
   stft_mel_bf16's dif route (fast); in the same ranks the full-width
   float32 TuiNet's first step at global batch 64 on a data=2 and a model=2
   mesh against this process's step, both on linear mel power (the dB
   features clamp to zeros and leave the convolutions and BatchNorm without
   a gradient): loss within 1e-4, each gradient and each BatchNorm running
   statistic's change within 1e-3 in relative L2 or 3x the permuted batch's
   difference, and no leaf of this process's step without a gradient; and
   the sharded step's ms; each rank's warm wall and gather ms, labelled as
   two ranks sharing one card, not a scaling figure;
12. prints one JSON line of the EfficientNetB0 numbers, one of the packed
   morphology's, one of the side paths', one of training's, one of the
   scale-out phase's, one of the upload path's, one describing every
   kernel, the card's name and power limit, then the last line
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero before the last
line; without a CUDA device it exits non-zero at once.
"""

import contextlib
import importlib.util
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np

SR = 48000
SECONDS = 60
SILENT_FROM = 52.0  # seconds; the rest of the recording is digital silence
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM, dense bf16 on the tensor cores
BATCH_SILENT_FROM = (52.0, 60.0, 45.0, 57.5, 60.0, 49.0, 41.0, 55.0)  # 60.0: no tail
BACKLOG = 24  # recordings in the backlog run: three batches of 8
PRE_LABELS = ["bird", "human", "noise"]
REPO = Path(__file__).resolve().parent
GOLDEN_MODEL = REPO / "tests" / "data" / "golden_model"
GOLDEN_SNAPSHOT = REPO / "tests" / "data" / "golden_snapshot.json"
LABELS = ["bird", "morepork", "kiwi", "whistler", "tui", "human", "noise", "insect"]
EFFNET_ZERO = REPO / "audio_analysis_torch" / "data" / "efficientnet_b0_160x226_zero.keras"
EFFNET_LABELS = ["bird", "kiwi", "morepork", "whistler", "noise", "human", "insect", "other"]
# thresholds in gaps of the fixture's track confidences on the CPU: 18 | 27
# at the exact level (float32), 29 | 33 in the fast batch's first two
# recordings (bfloat16), so that a small card-vs-CPU difference flips no label
EFFNET_THRESHOLD = 0.225
EFFNET_FAST_THRESHOLD = 0.31
EFFNET_WINDOWS = 64  # the model phase's grid: [64, 160, 226, 3]
EFFNET_F32_TOL = 1e-4  # card float32 vs CPU float32, max abs of the probabilities
# bfloat16 vs float32 on the card: through 16 blocks bfloat16 moves this
# network's probabilities by up to 0.112 (mean 0.0063) in the JAX package's
# own bfloat16 mode (CPU, 30 windows; tests/test_torch_keras_graph.py)
EFFNET_BF16_MAX, EFFNET_BF16_MEAN = 0.15, 0.02
MOREPORK_ZERO = REPO / "audio_analysis_torch" / "data" / "morepork_cnn_60x60_zero.keras"
MOREPORK_MEMBERS = 3
EMBEDDER_ZERO = REPO / "audio_analysis_torch" / "data" / "embedder_conv1d_160000_zero.keras"
EMBED_SR = 32000
EMBED_DIM = 1280
EMBED_LABELS = ["bird", "kiwi", "morepork", "tui", "noise", "human"]
EMBED_THRESHOLD = 0.295
RESAMPLE_RATES = (44100, 32000, 96000)  # the recordings written at other rates
RESAMPLE_TOL = 1e-5  # card vs CPU, max abs of the 48 kHz PCM
# band-pass models: at the exact level (float32) above 1/8, the mean of 8
# labels' probabilities, so every classified track has a label at least; in
# the fast batch (bfloat16) in the gap 15 | 24 of the bird model's track
# confidences in the first two recordings on the CPU, so that a small
# card-vs-CPU difference flips no label
BANDPASS_THRESHOLD = 0.13
BANDPASS_FAST_THRESHOLD = 0.2


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# fixtures (also used by the CPU tests)
# ---------------------------------------------------------------------------


def make_recording(seconds=SECONDS, silent_from=SILENT_FROM, seed=0, sr=SR):
    """Noise plus chirps (as tests/test_golden_snapshot.py, stretched), then
    digital silence from `silent_from` seconds. float32 in [-1, 1)."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * sr)) / sr
    y = 0.01 * rng.randn(len(t)).astype(np.float32)
    n_chirps = max(1, int(silent_from // 6))
    for i in range(n_chirps):
        t0 = 1.0 + i * (silent_from - 2.0) / n_chirps
        f0 = float(rng.uniform(1500, 4500))
        sweep = float(rng.uniform(-400, 400))
        dur = float(rng.uniform(0.6, 1.2))
        m = (t >= t0) & (t < t0 + dur)
        phase = 2 * np.pi * (f0 * t[m] + sweep * (t[m] - t0) ** 2)
        y[m] += (0.5 * np.sin(phase)).astype(np.float32)
    y[int(silent_from * sr):] = 0.0
    return y


def codec_edge_case(order, seed=0):
    """A hand-built wire-codec encoding (``io/pcmcodec.py::EncodedPCM``,
    [2, 4 BLOCK]) that ``encode_pcm`` never emits: a width-32 tier of full
    32-bit words, a width-7 tier, width-0 blocks (implicit) with exceptions
    inside one, pad rows and a pad exception on the dummy row, and
    full-range zigzag values whose `order` integrations wrap in int32
    before the int16 cast."""
    from audio_analysis_torch.io import pcmcodec as pc

    rng = np.random.RandomState(seed)
    b, t = 2, 4 * pc.BLOCK
    n_blocks = b * t // pc.BLOCK
    tiers = {}
    for w, blocks in ((32, [1, 5]), (7, [3, 6])):
        z = rng.randint(0, 1 << w, size=(len(blocks), pc.BLOCK), dtype=np.uint64)
        words = pc._pack_words(z.astype(np.uint32), w)
        tiers[w] = (np.asarray(blocks + [n_blocks], np.int32),  # one pad row
                    np.concatenate([words, np.zeros((1, words.shape[1]), np.int32)]))
    pos = np.asarray([3, 2 * pc.BLOCK + 9, 2 * pc.BLOCK + 200, n_blocks * pc.BLOCK], np.int32)
    val = rng.randint(0, 1 << 32, size=len(pos), dtype=np.uint64).astype(np.uint32)
    val[-1] = 0  # the pad exception
    return pc.EncodedPCM((b, t), t - 5, order, tiers, (pos, val.view(np.int32)))


def golden_recording():
    """The golden snapshot's recording (tests/test_golden_snapshot.py): 20 s
    of seeded noise and three chirps, float32."""
    rng = np.random.RandomState(123)
    t = np.arange(20 * SR) / SR
    y = 0.01 * rng.randn(len(t)).astype(np.float32)
    for f0, sweep, t0, dur in [(2800, 300, 2.0, 0.9), (3500, -400, 8.0, 1.1),
                               (1800, 200, 14.0, 0.7)]:
        m = (t >= t0) & (t < t0 + dur)
        phase = 2 * np.pi * (f0 * t[m] + sweep * (t[m] - t0) ** 2)
        y[m] += (0.5 * np.sin(phase)).astype(np.float32)
    return y


def write_tuinet_model(model_dir, seed=0, channels=(64, 128, 256), stem=32, dense=256,
                       n_mels=160, labels=LABELS, **meta_overrides):
    """metadata.txt + weights.npz in the JAX package's layout (HWIO convs),
    weights drawn from a numpy seed (He-normal, BN statistics perturbed).
    ``meta_overrides`` update the metadata; a None value removes the key
    (``net_dtype=None`` leaves TuiNet's default, bfloat16)."""
    model_dir = Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    meta = {
        "architecture": "tuinet", "name": "tuinet-smoke", "labels": list(labels),
        "n_fft": 4096, "hop_length": 640, "n_mels": n_mels, "fmin": 50, "fmax": 11000,
        "break_freq": 1750, "htk": True, "db_scale": False, "normalize": True,
        "power": 2, "segment_length": 3, "segment_stride": 1.5, "threshold": 0.2,
        "net_dtype": "float32", "net_channels": list(channels),
        "net_stem_channels": stem, "net_dense_units": dense,
    }
    meta.update(meta_overrides)
    meta = {k: v for k, v in meta.items() if v is not None}
    (model_dir / "metadata.txt").write_text(json.dumps(meta, indent=4, sort_keys=True))
    rng = np.random.RandomState(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    conv = lambda ci, co: f32(rng.randn(3, 3, ci, co) * np.sqrt(2.0 / (9 * ci)))
    w = {"mag_a": f32([-1.0]), "stem/w": conv(1, stem), "stem/b": f32(0.01 * rng.randn(stem))}
    c_in = stem
    for i, c in enumerate(channels):
        w[f"blocks/{i}/w1"] = conv(c_in, c)
        w[f"blocks/{i}/w2"] = conv(c, c)
        for bn in ("bn1", "bn2"):
            w[f"blocks/{i}/{bn}/gamma"] = f32(1 + 0.1 * rng.randn(c))
            w[f"blocks/{i}/{bn}/beta"] = f32(0.1 * rng.randn(c))
            w[f"blocks/{i}/{bn}/mean"] = f32(0.1 * rng.randn(c))
            w[f"blocks/{i}/{bn}/var"] = f32(1 + 0.1 * rng.rand(c))
        c_in = c
    w["head/w1"] = f32(rng.randn(c_in, dense) * np.sqrt(2.0 / c_in))
    w["head/b1"] = f32(0.01 * rng.randn(dense))
    w["head/w2"] = f32(rng.randn(dense, len(labels)) * np.sqrt(1.0 / dense))
    w["head/b2"] = f32(0.01 * rng.randn(len(labels)))
    np.savez(model_dir / "weights.npz", **w)
    return model_dir


def seeded_keras_archive(zero_archive, archive, seed, calibrate=None):
    """Write `archive`: the committed zero-weight `zero_archive` with its
    weights drawn from a numpy seed and written in place by the port's
    ``write_keras_archive`` (at each dataset's offset that io/h5read.py
    reports): conv and dense kernels He-normal over their fan-in, biases 0,
    BatchNorm gamma ~1 and beta ~0 (perturbed), its moving mean 0 and
    variance 1, Normalization mean 0 and variance 1 (it divides with no
    epsilon). Then ``calibrate(config, weights)``, given the seeded
    archive, returns {weight key: {variable index: array}} to overwrite
    (BatchNorm's moving statistics, ``bn_batch_stats``; an output bias).
    Needs no TensorFlow. Returns `archive`."""
    import zipfile

    from audio_analysis_torch.io.h5read import read_h5
    from audio_analysis_torch.io.keras_export import write_keras_archive
    from audio_analysis_torch.io.keras_import import read_keras_archive

    archive = Path(archive)
    with zipfile.ZipFile(zero_archive) as z:
        tree = read_h5(z.read("model.weights.h5"))
    rng = np.random.RandomState(seed)
    params = {}  # weight key -> {variable index: array}

    def fill(tree, path):
        for key in sorted(tree):
            item = tree[key]
            if isinstance(item, dict):
                fill(item, path + (key,))
                continue
            if path[-1:] != ("vars",):
                continue
            vs = params.setdefault("/".join(path[1:-1]), {})
            layer, i, shape = path[-2].rstrip("0123456789").rstrip("_"), int(key), item.array.shape
            if item.offset is None:  # no storage: nothing to draw
                vs[i] = item.array
            elif layer == "normalization":  # mean, variance, count
                vs[i] = np.full(shape, (0, 1, 0)[i])
            elif layer == "batch_normalization":  # gamma, beta, moving mean, variance
                vs[i] = ((1.0, 0.0)[i] + 0.1 * rng.randn(*shape) if i < 2
                         else np.full(shape, (0.0, 1.0)[i - 2]))
            elif len(shape) >= 2:  # conv (HWIO, WIO), depthwise (h, w, C, 1), dense ([in, out])
                fan_in = int(np.prod(shape[:-2])) * (1 if "depthwise" in layer else shape[-2])
                vs[i] = rng.randn(*shape) * np.sqrt(2.0 / fan_in)
            else:  # biases
                vs[i] = np.zeros(shape)

    def write():
        write_keras_archive(zero_archive, {k: [vs[i] for i in sorted(vs)]
                                           for k, vs in params.items()}, archive)

    fill(tree, ())
    write()
    if calibrate is not None:
        config, weights, _ = read_keras_archive(archive)
        for key, new in calibrate(config, weights).items():
            params[key].update(new)
        write()
    return archive


def efficientnet_fixture(model_dir, seed=0, threshold=EFFNET_THRESHOLD, name="efficientnet-b0",
                         labels=EFFNET_LABELS, **meta_overrides):
    """A full-width EfficientNetB0 model dir over [160, 226, 3] mel windows
    (bench.py's fixture) without TensorFlow: the committed zero-weight
    archive seeded in place (``seeded_keras_archive``), BatchNorm's moving
    mean and variance then set to the statistics its input has on 15
    windows of a seeded recording (``bn_batch_stats``), as training would
    leave them: with mean 0 and variance 1 instead, the input's part of the
    signal decays through the 16 blocks and every window gets the same
    probabilities. Writes audioModel.keras and metadata.txt (bench.py's
    frontend; the name holds "efficientnet", so the 3-channel repeat
    applies)."""
    model_dir = Path(model_dir)
    seeded_keras_archive(EFFNET_ZERO, model_dir / "audioModel.keras", seed,
                         lambda config, weights: bn_batch_stats(config, weights,
                                                                calibration_grid(seed)))
    meta = {
        "name": name, "labels": list(labels), "segment_length": 3, "segment_stride": 1.5,
        "hop_length": 640, "n_mels": 160, "break_freq": 1750, "htk": True, "fmin": 50,
        "fmax": 11000, "power": 2, "db_scale": True, "threshold": threshold, "n_fft": 4096,
        "normalize": True,
    }
    meta.update(meta_overrides)
    meta = {k: v for k, v in meta.items() if v is not None}
    (model_dir / "metadata.txt").write_text(json.dumps(meta, indent=4, sort_keys=True))
    return model_dir


def morepork_ensemble(model_dir, seed=0, members=MOREPORK_MEMBERS):
    """A morepork ensemble of `members` seeded CNNs over [60, 60, 1] samples
    (the committed zero-weight archive: three conv blocks of 32/64/128
    filters with max-pools, Dense(128), Dense(1, sigmoid)), each laid out
    as the JAX package serves a converted SavedModel: ``member<i>/`` holds
    a placeholder saved_model.pb and ``.aat_native/`` the converted
    audioModel.keras, metadata.txt and a .stamp of saved_model.pb's
    st_mtime_ns. Member i is seeded with seed + i; its output bias then
    puts its median activation on the samples of a seeded recording at
    1/members, so the ensemble's sum crosses the 1.0 threshold there about
    half the time (one sigmoid alone never reaches it; tests/test_morepork.py
    biases its members for the same reason). Returns the ensemble dir."""
    import torch

    from audio_analysis_torch.models.keras_graph import KerasModel, _layer_name
    from audio_analysis_torch.pipeline import morepork as mp

    y = torch.from_numpy(make_recording(seconds=20, silent_from=20.0, seed=2000 + seed))
    spec = mp._spectrogram_program(y, sr=SR)
    lows, lengths, _ = mp._sample_grid(int(spec.shape[1]))
    samples = mp._samples_program(spec, torch.from_numpy(lows), torch.from_numpy(lengths))

    def output_bias(config, weights):
        net = KerasModel(config, weights)
        with torch.inference_mode():
            p = net(samples).double().numpy().ravel()
        logit = float(np.median(np.log(p / (1.0 - p))))
        target = -np.log(members - 1.0)  # the logit of 1/members
        return {net._h5key[_layer_name(net._layers[-1])]: {1: [target - logit]}}

    model_dir = Path(model_dir)
    for i in range(members):
        member = model_dir / f"member{i}"
        member.mkdir(parents=True, exist_ok=True)
        pb = member / "saved_model.pb"
        pb.write_bytes(b"")
        native = member / ".aat_native"
        seeded_keras_archive(MOREPORK_ZERO, native / "audioModel.keras", seed + i, output_bias)
        (native / "metadata.txt").write_text(json.dumps({"name": f"morepork{i}",
                                                         "labels": ["morepork"]}))
        (native / ".stamp").write_text(str(pb.stat().st_mtime_ns))
    return model_dir


def embedder_fixture(path, seed=0):
    """The embeddings groups' embedder, Perch's interface: [160000] float32
    windows (5 s at 32 kHz) in, 64 logits and a 1,280-wide embedding out
    (the committed zero-weight archive: Reshape to [500, 320], three
    Conv1D/BatchNorm/ReLU blocks of 128/256/256 channels with two
    max-pools, global average pooling, Dense(1280), Dense(64)), seeded in
    place, its BatchNorm moving statistics those of 8 windows of a seeded
    32 kHz recording (``bn_batch_stats``). Returns the archive's path."""
    import torch

    y = make_recording(seconds=40, silent_from=40.0, seed=3000 + seed, sr=EMBED_SR)
    windows = torch.from_numpy(y.reshape(8, 5 * EMBED_SR))
    return seeded_keras_archive(EMBEDDER_ZERO, path, seed,
                                lambda config, weights: bn_batch_stats(config, weights, windows))


def embeddings_head(model_dir, embedding_model, seed=0, labels=EMBED_LABELS,
                    **meta_overrides):
    """An embeddings group's model: a Dense softmax head over the 1,280-wide
    embedding (``"architecture": "dense"``, weights drawn from a numpy
    seed), ``"name": "embeddings"``, its embedder at `embedding_model`,
    5 s windows every 5 s. ``meta_overrides`` update the metadata."""
    model_dir = Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    np.savez(model_dir / "weights.npz",
             **{"0/kernel": (rng.randn(EMBED_DIM, len(labels)) * np.sqrt(2.0 / EMBED_DIM))
                .astype(np.float32),
                "0/bias": (0.01 * rng.randn(len(labels))).astype(np.float32)})
    meta = {"architecture": "dense", "name": "embeddings", "labels": list(labels),
            "embedding_model": str(embedding_model), "segment_stride": 5,
            "threshold": EMBED_THRESHOLD}
    meta.update(meta_overrides)
    (model_dir / "metadata.txt").write_text(json.dumps(meta, indent=4, sort_keys=True))
    return model_dir


def calibration_grid(seed):
    """15 windows of 3 s (stride 1.5 s) of a seeded 24 s recording, through
    the EfficientNet fixture's frontend at the exact level on the CPU,
    repeated to 3 channels: [15, 160, 226, 3]."""
    import torch

    from audio_analysis_torch.pipeline.frontend import EXACT, spectrogram_grid

    y = make_recording(seconds=24, silent_from=24.0, seed=1000 + seed)
    windows = torch.from_numpy(np.stack([y[i * SR * 3 // 2 : i * SR * 3 // 2 + 3 * SR]
                                         for i in range(15)]))
    feats = spectrogram_grid(windows, level=EXACT, sr=SR, hop_length=640, n_fft=4096,
                             n_mels=160, mel_break=1750.0, htk=True, fmin=50, fmax=11000,
                             power=2.0, db_scale=True, normalize=True)
    return feats.repeat_interleave(3, dim=-1)


def bn_batch_stats(config, weights, x):
    """{weight key: {2: mean, 3: variance}}, BatchNormalization's moving
    statistics set to those of its input in one forward over `x` in which
    each BatchNormalization normalises with its own input's per-channel
    statistics (training-mode batch norm, biased variance, over every axis
    but the last), so each layer sees the inputs the calibrated layers
    before it give."""
    import torch

    from audio_analysis_torch.models.keras_graph import KerasModel, _layer_name

    stats = {}

    class Calibrating(KerasModel):
        def _build_layer(self, layer):
            if layer["class_name"] != "BatchNormalization":
                return super()._build_layer(layer)
            key = self._prefix + self._h5key[_layer_name(layer)]
            gamma, beta = (torch.from_numpy(np.asarray(a)) for a in self.params[key][:2])
            eps = layer["config"].get("epsilon", 1e-3)

            def bn(args, kwargs):
                x = args[0]
                dims = tuple(range(x.dim() - 1))
                mean, var = x.mean(dim=dims), x.var(dim=dims, unbiased=False)
                stats[key] = {2: mean.numpy(), 3: var.numpy()}
                return (x - mean) * torch.rsqrt(var + eps) * gamma + beta

            return bn

    with torch.inference_mode():
        Calibrating(config, weights)(x)
    return stats


def compare_results(a, b, confidence_tol=1):
    """The contract between two result JSONs of one recording: signals,
    duration, chirps, cacophony index and every track's box and labels
    identical, confidences within ``confidence_tol``. Raises AssertionError
    naming the first difference; returns the largest confidence
    difference."""
    for k in ("duration", "chirps", "cacophony_index", "cacophony_index_version",
              "non_bird_tags", "species_identify_version"):
        if a.get(k) != b.get(k):
            raise AssertionError(f"{k} differs: {a.get(k)!r} vs {b.get(k)!r}")
    ta, tb = a["species_identify"], b["species_identify"]
    worst = 0
    if len(ta) != len(tb):
        raise AssertionError(f"{len(ta)} vs {len(tb)} tracks")
    for i, (x, y) in enumerate(zip(ta, tb)):
        for k in ("begin_s", "end_s", "freq_start", "freq_end"):
            if x[k] != y[k]:
                raise AssertionError(f"track {i} {k}: {x[k]} vs {y[k]}")
        preds = lambda t: [
            (r["model"], p) for r in t.get("model_results", []) for p in r["predictions"]
        ] + [(r["model"], r["raw_prediction"]) for r in t.get("model_results", [])
             if "raw_prediction" in r]
        pa, pb = preds(x), preds(y)
        if [(m, p["label"]) for m, p in pa] != [(m, p["label"]) for m, p in pb]:
            raise AssertionError(f"track {i} labels differ: {pa} vs {pb}")
        for (_, p), (_, q) in zip(pa, pb):
            worst = max(worst, abs(p["confidence"] - q["confidence"]))
            if abs(p["confidence"] - q["confidence"]) > confidence_tol:
                raise AssertionError(f"track {i} confidence {p} vs {q}")
        ma = x.get("master_tag", {}).get("prediction", {}).get("label")
        mb = y.get("master_tag", {}).get("prediction", {}).get("label")
        if ma != mb:
            raise AssertionError(f"track {i} master tag {ma} vs {mb}")
    return worst


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def time_ms(fn, iters):
    """Mean device time of fn() over `iters` calls after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_rel(got, gt):
    """The measure of tests/test_pallas_exact.py: |got - gt| over
    max(|gt|, 1e-3 max|gt|)."""
    import torch

    gt = gt.double()
    den = torch.clamp(gt.abs(), min=1e-3 * float(gt.abs().max()))
    return float(((got.double() - gt).abs() / den).max())


def fft_flops(n_fft):
    """Operations of one real FFT of n_fft points (the usual 2.5 n log2 n)."""
    return 2.5 * n_fft * math.log2(n_fft)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def dft_route(n_fft, bins, mel):
    """The route ("fft", "fft1", "bluestein" or "cluster") the float64 DFT
    wrappers take on this card for n_fft, keeping the first `bins` bins."""
    from audio_analysis_torch.ops import cuda as kcuda
    from audio_analysis_torch.ops import melspec as ms

    return ms.stft_plan(n_fft, bins, mel=mel, cap=kcuda.library().aat_smem_optin())[0]


def cluster_split(n_fft, bins, mel):
    """The cluster route's plan on this card: blocks a cluster, the
    transform's points (a Bluestein length where not n_fft), frames a
    cluster, a block's shared memory and how many such clusters the card
    holds at once (cudaOccupancyMaxActiveClusters)."""
    from audio_analysis_torch.ops import cuda as kcuda
    from audio_analysis_torch.ops import melspec as ms

    lib = kcuda.library()
    c, points, tf = ms.cluster_plan(n_fft, bins, mel=mel, cap=lib.aat_smem_optin())
    active = lib.aat_stft_cluster_occupancy(tf, c, points // c, bins, int(mel),
                                            int(points != n_fft))
    if active <= 0:
        raise AssertionError(f"n_fft {n_fft}: the card holds no cluster of {c} ({active})")
    return {"c": c, "points": points, "frames": tf, "active_clusters": active,
            "smem": ms.cluster_smem(points, c, bins, tf, mel)}


def dft_entry(name, replaces, fn, plain, libraries, out_bytes, in_bytes, frames, n_fft,
              mel_nnz, route, iters):
    """A float64 DFT kernel (stft_mel, stft_mag) against its plain version:
    max rel <= 1e-6 (both take the DFT in float64 and round to float32, so
    they differ by float32 rounding flips at most), two launches bit for
    bit; its time, the plain version's and each PyTorch call's in
    `libraries` {key: fn}, and the bound. Returns the measurement."""
    import torch

    got = fn()
    ref = plain()
    again = fn()
    torch.cuda.synchronize()
    if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(ref.shape)} or non-finite")
    rel = max_rel(got, ref)
    abs_err = float((got.double() - ref.double()).abs().max())
    if not rel <= 1e-6:
        raise AssertionError(f"{name}: max rel {rel:.3g} vs its plain version (limit 1e-6)")
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two launches differ")
    del again
    ops = frames * (fft_flops(n_fft) + 2 * mel_nnz)
    byte_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    op_ms = ops / F32_FLOPS * 1e3
    m = dict(
        name=name, route="cuda", dft_route=route, source="audio_analysis_torch/csrc/stft.cu",
        replaces=replaces, max_abs_err=abs_err, max_rel=rel,
        ms=time_ms(fn, iters), plain_ms=time_ms(plain, iters),
        bound_ms=max(byte_ms, op_ms), bound_by="bytes" if byte_ms >= op_ms else "operations",
        bytes_ms=byte_ms, shape=list(got.shape),
    )
    m["library_ms"] = None
    for key, lib in libraries.items():
        m[key] = time_ms(lib, iters)
    log(json.dumps(m))
    return m


def require_route(m, route):
    if m["dft_route"] != route:
        raise AssertionError(f"{m['name']} took the {m['dft_route']} route, not {route}")
    return m


def mag_entry(name, y, n_fft, hop, iters):
    """stft_mag on signals y [B, T] (n_fft, hop) through dft_entry, with
    torch.stft(...).abs() in float32 (``library_ms``) and in float64
    (``library_ms_f64``) as the library calls."""
    import torch

    from audio_analysis_torch.ops import melspec as ms

    b, t = y.shape
    n_frames = ms.stft_frames(t, n_fft, hop)
    yd = y.double()
    hann = torch.hann_window(n_fft, periodic=True, device=y.device)
    hann_d = hann.double()
    return dft_entry(
        name, "audio_analysis_tpu/ops/pallas/melspec.py:453 (_kernel_dif_mag)",
        lambda: ms.stft_mag(y, n_fft=n_fft, hop_length=hop),
        lambda: ms.stft_mag_plain(y, n_fft=n_fft, hop_length=hop),
        {"library_ms": lambda: torch.stft(y, n_fft, hop, window=hann, center=True,
                                          pad_mode="constant", return_complex=True).abs(),
         "library_ms_f64": lambda: torch.stft(yd, n_fft, hop, window=hann_d, center=True,
                                              pad_mode="constant",
                                              return_complex=True).abs()},
        out_bytes=b * (n_fft // 2 + 1) * n_frames * 4, in_bytes=b * t * 4,
        frames=b * n_frames, n_fft=n_fft, mel_nnz=0,
        route=dft_route(n_fft, n_fft // 2 + 1, False), iters=iters,
    )


def row_medians_entry(name, spec, nvf):
    """row_medians on `spec` [B, bins, T] over the first nvf[b] columns,
    bit for bit against its plain version (and, for the first recording,
    np.median), with its time, the library call's (``torch.nanquantile``)
    and its bound (the spectrogram read once, the medians written once);
    returns the measurement."""
    import torch

    from audio_analysis_torch.ops import medians as md

    got, ref = md.row_medians(spec, nvf), md.row_medians_plain(spec, nvf)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError(f"{name}: {int((got != ref).sum())} medians differ from the "
                             "plain version")
    nv0 = int(nvf[0])
    np_row = np.median(spec[0, :, :nv0].cpu().numpy(), axis=1).astype(np.float32)
    if not np.array_equal(got[0, :, 0].cpu().numpy(), np_row):
        raise AssertionError(f"{name}: differs from np.median")
    # the library call: nanquantile's midpoint over the invalid columns set
    # to NaN (the masking is the input's preparation, outside the timing)
    valid = torch.arange(spec.shape[-1], device=spec.device) < torch.as_tensor(
        nvf, device=spec.device).reshape(-1, 1, 1)
    masked = torch.where(valid, spec, float("nan"))

    def library():
        return torch.nanquantile(masked, 0.5, dim=-1, keepdim=True, interpolation="midpoint")

    m = dict(
        name=name, route="cuda", source="audio_analysis_torch/csrc/medians.cu",
        replaces="audio_analysis_tpu/ops/pallas/medians.py:87 (_kernel_row_medians)",
        max_abs_err=0.0, max_rel=0.0, ms=time_ms(lambda: md.row_medians(spec, nvf), 10),
        plain_ms=time_ms(lambda: md.row_medians_plain(spec, nvf), 3),
        library_ms=time_ms(library, 3), library_equal=bool(torch.equal(library(), got)),
        bound_ms=(spec.numel() + got.numel()) * 4 / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        shape=list(spec.shape), nvf=[int(v) for v in nvf],
    )
    del masked
    log(json.dumps(m))
    return m


def col_medians_entry(name, spec):
    """col_medians on `spec` [B, bins, T] over all rows, bit for bit against
    its plain version (every column, the all-zero tail past the valid frames
    included) and, for the first recording, np.median, with its time, the
    library call's (``torch.quantile``) and its bound (the spectrogram read
    once, the medians written once); returns the measurement."""
    import torch

    from audio_analysis_torch.ops import medians as md

    got, ref = md.col_medians(spec), md.col_medians_plain(spec)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError(f"{name}: {int((got != ref).sum())} medians differ from the "
                             "plain version")
    np_col = np.median(spec[0].cpu().numpy(), axis=0).astype(np.float32)
    if not np.array_equal(got[0, 0].cpu().numpy(), np_col):
        raise AssertionError(f"{name}: differs from np.median")

    def library():  # quantile's midpoint over the rows
        return torch.quantile(spec, 0.5, dim=-2, keepdim=True, interpolation="midpoint")
    m = dict(
        name=name, route="cuda", source="audio_analysis_torch/csrc/medians.cu",
        replaces="audio_analysis_tpu/ops/pallas/medians.py:95 (_kernel_col_medians)",
        max_abs_err=0.0, max_rel=0.0, ms=time_ms(lambda: md.col_medians(spec), 10),
        plain_ms=time_ms(lambda: md.col_medians_plain(spec), 3),
        library_ms=time_ms(library, 3), library_equal=bool(torch.equal(library(), got)),
        bound_ms=(spec.numel() + got.numel()) * 4 / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        shape=list(spec.shape),
    )
    log(json.dumps(m))
    return m


def check_kernels(pcm):
    """Each kernel against its plain version on the card, at the main
    path's shapes; returns {name: measurement}."""
    import torch

    from audio_analysis_torch.detect.signal_noise import (
        _batch_chunk_flatness, _endscan_decision,
    )
    from audio_analysis_torch.ops import medians as md
    from audio_analysis_torch.ops import melspec as ms
    from audio_analysis_torch.ops.mel import filterbank_np, mel_support_bins
    from audio_analysis_torch.ops.scale import normalize_minmax

    dev = torch.device("cuda")
    y = torch.from_numpy(pcm).to(dev)[None]  # [1, T] float32
    t = y.shape[1]
    hop = 281
    res = {}

    # end-scan mel: whole frames of the recording, n_fft sr//10 = 4800
    chunk = SR // hop
    n_keep = ((1 + t // hop) // chunk) * chunk
    kw_end = dict(sr=SR, n_fft=SR // 10, hop_length=hop, n_mels=120, fmin=50.0,
                  fmax=11000.0, break_freq=1750.0, power=1.0, htk=True, frames=n_keep)
    nnz_end = int((filterbank_np(SR, 120, 50.0, 11000.0, SR // 10, 1750.0, True) != 0).sum())
    bins_end = mel_support_bins(SR, 120, 50.0, 11000.0, SR // 10, 1750.0, True)
    res["stft_mel[end-scan]"] = dft_entry(
        "stft_mel[end-scan]", "audio_analysis_tpu/ops/pallas/melspec.py:391 (_kernel_dif)",
        lambda: ms.stft_mel(y, **kw_end), lambda: ms.stft_mel_plain(y, **kw_end), {},
        out_bytes=120 * n_keep * 4, in_bytes=t * 4, frames=n_keep, n_fft=SR // 10,
        mel_nnz=nnz_end, route=dft_route(SR // 10, bins_end, True), iters=5,
    )

    # classify frontend: 64 normalised 3 s windows of the recording's sound
    # (an all-zero window normalises to NaN, as in the reference)
    sample = 3 * SR
    bases = np.arange(64) * ((int(SILENT_FROM * SR) - sample) // 64)
    win = torch.stack([y[0, b : b + sample] for b in bases])
    win = normalize_minmax(win).contiguous()
    kw_cls = dict(sr=SR, n_fft=4096, hop_length=640, n_mels=160, fmin=50.0, fmax=11000.0,
                  break_freq=1750.0, power=2.0, htk=True)
    nnz_cls = int((filterbank_np(SR, 160, 50.0, 11000.0, 4096, 1750.0, True) != 0).sum())
    bins_cls = mel_support_bins(SR, 160, 50.0, 11000.0, 4096, 1750.0, True)
    f_cls = 1 + sample // 640
    res["stft_mel[classify]"] = dft_entry(
        "stft_mel[classify]", "audio_analysis_tpu/ops/pallas/melspec.py:391 (_kernel_dif)",
        lambda: ms.stft_mel(win, **kw_cls), lambda: ms.stft_mel_plain(win, **kw_cls), {},
        out_bytes=64 * 160 * f_cls * 4, in_bytes=64 * sample * 4, frames=64 * f_cls,
        n_fft=4096, mel_nnz=nnz_cls, route=dft_route(4096, bins_cls, True), iters=5,
    )
    # the other routes on the classify grid: 4400 = 2^4 5^2 11 (a radix-11
    # pass, in place), 8192 (one buffer), the prime 4099 (Bluestein), and
    # the cluster: 6301 (prime, Bluestein's 12800 points over two blocks),
    # 12000 and 16384 (two blocks), 32768 (four)
    for n_fft, route, iters in ((4400, "fft1", 5), (8192, "fft1", 5), (4099, "bluestein", 5),
                                (6301, "cluster", 5), (12000, "cluster", 5),
                                (16384, "cluster", 5), (32768, "cluster", 3)):
        kw_n = dict(kw_cls, n_fft=n_fft)
        nnz_n = int((filterbank_np(SR, 160, 50.0, 11000.0, n_fft, 1750.0, True) != 0).sum())
        bins_n = mel_support_bins(SR, 160, 50.0, 11000.0, n_fft, 1750.0, True)
        name = f"stft_mel[{route}, n_fft {n_fft}]"
        res[name] = require_route(dft_entry(
            name, "audio_analysis_tpu/ops/pallas/melspec.py:391 (_kernel_dif)",
            lambda kw_n=kw_n: ms.stft_mel(win, **kw_n),
            lambda kw_n=kw_n: ms.stft_mel_plain(win, **kw_n), {},
            out_bytes=64 * 160 * f_cls * 4, in_bytes=64 * sample * 4, frames=64 * f_cls,
            n_fft=n_fft, mel_nnz=nnz_n, route=dft_route(n_fft, bins_n, True), iters=iters,
        ), route)
        res[name]["vs_classify_4096"] = res[name]["ms"] / res["stft_mel[classify]"]["ms"]
        if route == "cluster":
            res[name]["cluster"] = cluster_split(n_fft, bins_n, True)

    # detection |STFT| of the recording, zeroed past the end-scan's data end
    mx, mn = _batch_chunk_flatness(y, sr=SR, hop_length=hop)
    found, _, mask_valid = _endscan_decision(
        torch.tensor([t], device=dev), mx, mn, sr=SR, hop_length=hop
    )
    if not bool(found[0]):
        raise AssertionError("the end-scan did not find the silent tail")
    mask_valid = int(mask_valid[0])
    fz = y.clone()
    fz[:, mask_valid:] = 0.0
    n_frames = 1 + t // hop
    res["stft_mag"] = mag_entry("stft_mag", fz, 4096, hop, iters=5)
    # the other routes on the whole recording, each beside float64
    # torch.stft (library_ms_f64), as on the classify grid
    for n_fft, route, iters in ((4400, "fft1", 5), (8192, "fft1", 5), (4099, "bluestein", 5),
                                (6301, "cluster", 5), (12800, "cluster", 5),
                                (16384, "cluster", 5), (32768, "cluster", 3)):
        name = f"stft_mag[{route}, n_fft {n_fft}]"
        res[name] = require_route(mag_entry(name, fz, n_fft, hop, iters=iters), route)
        if route == "cluster":
            res[name]["cluster"] = cluster_split(n_fft, n_fft // 2 + 1, False)

    # medians of the a_max-normalised spectrogram over its valid frames
    spec = ms.stft_mag(fz, n_fft=4096, hop_length=hop)
    nvf = torch.tensor([1 + mask_valid // hop], device=dev)
    valid = torch.arange(n_frames, device=dev) < nvf[:, None]
    spec_n = (spec / torch.where(valid[:, None, :], spec, 0.0).amax()).contiguous()
    res["row_medians"] = row_medians_entry("row_medians", spec_n, nvf)
    res["col_medians"] = col_medians_entry("col_medians", spec_n)
    return res


BF16_REPLACES = {"dif": "audio_analysis_tpu/ops/pallas/melspec.py:391 (_kernel_dif)",
                 "direct": "audio_analysis_tpu/ops/pallas/melspec.py:98 (_kernel)"}


def bf16_entry(name, x, kw, compare=False):
    """stft_mel_bf16 against the plain version of its route on the card on
    windows `x` [N, S] with keyword arguments `kw`: max rel <= 1e-2 and,
    two launches bit for bit; returns its measurement. Rows of `x` that are
    not finite are the padding of a window grid (all-zero audio normalises
    to NaN, as in the reference; the per-track means drop them) and are left
    out of the comparison. Also reports, for information, the max rel
    against the float64 ``stft_mel_plain``. With `compare`, times in the
    same run the direct route at the same shape (AAT_PALLAS_ALG=matmul,
    ``direct_ms``, and its max rel against float64, ``direct_max_rel_f64``)
    and the float64 FFT ``stft_mel`` (``stft_mel_ms``)."""
    import torch

    from audio_analysis_torch.ops import melspec as ms
    from audio_analysis_torch.ops.mel import filterbank_np

    route = ms.bf16_route(kw["n_fft"])
    plain = ms.stft_mel_dif_bf16_plain if route == "dif" else ms.stft_mel_bf16_plain
    got = ms.stft_mel_bf16(x, **kw)
    again = ms.stft_mel_bf16(x, **kw)
    ref = plain(x, **kw)
    torch.cuda.synchronize()
    rows = torch.isfinite(x).all(dim=1)
    g, r = got[rows], ref[rows]
    if got.shape != ref.shape or not len(g) or not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(ref.shape)}, "
                             f"{len(g)} finite rows, or non-finite output")
    rel = max_rel(g, r)
    if not rel <= 1e-2:
        raise AssertionError(f"{name}: max rel {rel:.3g} vs its plain version (limit 1e-2)")
    if not torch.equal(got[rows], again[rows]):
        raise AssertionError(f"{name}: two launches differ")
    del again, ref
    # the float64 route frames an odd n_fft as the exact level does, one
    # frame fewer where the hop divides the window: compare the frames both have
    f64 = ms.stft_mel_plain(x, **kw)[rows]
    nf = min(f64.shape[-1], g.shape[-1])
    f64 = f64[..., :nf]
    rel_f64 = max_rel(g[..., :nf], f64)
    n, s = x.shape
    n_fft, n_mels, frames = kw["n_fft"], kw["n_mels"], got.shape[-1]
    nnz = int((filterbank_np(kw["sr"], n_mels, kw["fmin"], kw["fmax"], n_fft,
                             kw["break_freq"], kw.get("htk", True)) != 0).sum())
    byte_ms = (n * s + got.numel()) * 4 / HBM_BYTES_PER_S * 1e3
    op_ms = n * frames * (fft_flops(n_fft) + 2 * nnz) / BF16_FLOPS * 1e3
    m = dict(
        name=name, route="cuda", dft_route=route,
        source="audio_analysis_torch/csrc/stft_bf16.cu", replaces=BF16_REPLACES[route],
        max_abs_err=float((g.double() - r.double()).abs().max()), max_rel=rel,
        max_rel_f64=rel_f64, ms=time_ms(lambda: ms.stft_mel_bf16(x, **kw), 10),
        plain_ms=time_ms(lambda: plain(x, **kw), 3), library_ms=None,
        bound_ms=max(byte_ms, op_ms), bound_by="bytes" if byte_ms >= op_ms else "operations",
        shape=list(got.shape), rows_compared=int(rows.sum()),
    )
    if compare:
        os.environ["AAT_PALLAS_ALG"] = "matmul"
        try:
            d_got, d_again = ms.stft_mel_bf16(x, **kw), ms.stft_mel_bf16(x, **kw)
            d_rel = max_rel(d_got[rows], ms.stft_mel_bf16_plain(x, **kw)[rows])
            if not d_rel <= 1e-2:
                raise AssertionError(f"{name}: the direct route's max rel {d_rel:.3g} vs its "
                                     "plain version (limit 1e-2)")
            if not torch.equal(d_got[rows], d_again[rows]):
                raise AssertionError(f"{name}: two launches of the direct route differ")
            m["direct_max_rel"] = d_rel
            m["direct_max_rel_f64"] = max_rel(d_got[rows][..., :nf], f64)
            m["direct_ms"] = time_ms(lambda: ms.stft_mel_bf16(x, **kw), 10)
            m["direct_plain_ms"] = time_ms(lambda: ms.stft_mel_bf16_plain(x, **kw), 3)
            del d_got, d_again
        finally:
            os.environ.pop("AAT_PALLAS_ALG")
        m["stft_mel_ms"] = time_ms(lambda: ms.stft_mel(x, **kw), 5)
    log(json.dumps(m))
    return m


def check_bf16(pcm):
    """stft_mel_bf16 against the plain version of its route on the card, at
    the slice's shapes (dif route; at classify and the end-scan the direct
    route too, under AAT_PALLAS_ALG=matmul), at more than 320 frames a
    window (the JAX package's VMEM cap, dif route here) and at n_fft % 8 !=
    0 (direct route: n_fft 500, and the prime 4099 on the classify grid);
    returns {name: measurement}."""
    import torch

    from audio_analysis_torch.ops import melspec as ms
    from audio_analysis_torch.ops.scale import normalize_minmax

    y = torch.from_numpy(pcm).to(torch.device("cuda"))
    t = y.shape[0]
    chunk = SR // 281
    n_keep = ((1 + t // 281) // chunk) * chunk

    def windows(n, sample):
        """n normalised windows of the recording's sound."""
        bases = np.arange(n) * ((int(SILENT_FROM * SR) - sample) // n)
        return normalize_minmax(torch.stack([y[b : b + sample] for b in bases])).contiguous()

    cls = dict(sr=SR, n_fft=4096, hop_length=640, n_mels=160, fmin=50.0, fmax=11000.0,
               break_freq=1750.0, power=2.0)
    shapes = {
        "classify": (windows(64, 3 * SR), cls),
        "end-scan": (y[None], dict(sr=SR, n_fft=SR // 10, hop_length=281, n_mels=120, fmin=50.0,
                                   fmax=11000.0, break_freq=1750.0, power=1.0, frames=n_keep)),
        "long": (windows(16, int(4.5 * SR)), cls),
        "nfft500": (windows(16, 16000), dict(sr=16000, n_fft=500, hop_length=125, n_mels=40,
                                             fmin=50.0, fmax=7000.0, break_freq=1750.0,
                                             power=2.0)),
    }
    shapes["nfft4099"] = (shapes["classify"][0], dict(cls, n_fft=4099))
    # the dif split's depths 6 to 8 (n_fft 24000 and 32768 at 160 mels, 6;
    # 32768 over the whole band at 256 mels, 7, no band list; the same with
    # Slaney's bank, whose support takes the Nyquist bin, 8), on 16 windows
    deep = windows(16, 3 * SR)
    shapes["nfft24000"] = (deep, dict(cls, n_fft=24000))
    shapes["nfft32768"] = (deep, dict(cls, n_fft=32768))
    shapes["nfft32768-256mels"] = (deep, dict(cls, n_fft=32768, n_mels=256, fmax=24000.0))
    shapes["nfft32768-slaney"] = (deep, dict(cls, n_fft=32768, n_mels=256, fmax=24000.0,
                                             htk=False))
    res = {f"stft_mel_bf16[{tag}]": bf16_entry(f"stft_mel_bf16[{tag}]", x, kw,
                                               compare=tag in ("classify", "end-scan"))
           for tag, (x, kw) in shapes.items()}
    for tag in ("nfft24000", "nfft32768", "nfft32768-256mels", "nfft32768-slaney"):
        kw = shapes[tag][1]
        res[f"stft_mel_bf16[{tag}]"]["levels"] = ms._dif_consts(
            kw["sr"], kw["n_mels"], kw["fmin"], kw["fmax"], kw["n_fft"], kw["break_freq"],
            kw.get("htk", True), "cpu")[6]
    if [res[f"stft_mel_bf16[{t}]"]["levels"] for t in ("nfft24000", "nfft32768",
                                                       "nfft32768-256mels",
                                                       "nfft32768-slaney")] != [6, 6, 7, 8]:
        raise AssertionError("the deep dif shapes took other depths than 6, 6, 7, 8")
    direct = ("stft_mel_bf16[nfft500]", "stft_mel_bf16[nfft4099]")
    if any(m["dft_route"] != ("direct" if k in direct else "dif") for k, m in res.items()):
        raise AssertionError("stft_mel_bf16 took another route than bf16_route's")
    return res


@contextlib.contextmanager
def capture_inputs(captured):
    """Within the block, record a copy of the first input of each kind that
    a detection path (the fast batch's, or the exact analyse's) passes to
    stft_mel_bf16 (``batch end-scan``: the
    call with a ``frames`` prefix; ``batch classify``: the window grid) and
    to stft_mag (``batch``: the batch's detection signals, zeroed past each
    recording's data end) and to the medians (``batch medians``: the
    normalised [8, 2049, T] spectrogram and its valid frames) into `captured` {tag:
    (kernel name, input, kwargs)}. The kernels still run, and count, once
    per call."""
    from audio_analysis_torch.detect import signal_noise
    from audio_analysis_torch.pipeline import frontend

    bf16, mag = frontend.stft_mel_bf16, signal_noise.stft_mag
    rowcol = signal_noise.masked_medians_rowcol

    def recording_bf16(windows, **kw):
        tag = "batch end-scan" if kw.get("frames") is not None else "batch classify"
        captured.setdefault(tag, ("stft_mel_bf16", windows.clone(), dict(kw)))
        return bf16(windows, **kw)

    def recording_mag(y, **kw):
        captured.setdefault("batch", ("stft_mag", y.clone(), dict(kw)))
        return mag(y, **kw)

    def recording_rowcol(spec, nvf):
        captured.setdefault("batch medians", ("row_medians", spec.clone(), {"nvf": nvf.clone()}))
        return rowcol(spec, nvf)

    frontend.stft_mel_bf16, signal_noise.stft_mag = recording_bf16, recording_mag
    signal_noise.masked_medians_rowcol = recording_rowcol
    try:
        yield captured
    finally:
        frontend.stft_mel_bf16, signal_noise.stft_mag = bf16, mag
        signal_noise.masked_medians_rowcol = rowcol


def counters():
    from audio_analysis_torch.ops import medians as md
    from audio_analysis_torch.ops import melspec as ms

    return {"stft_mel": ms.stft_mel, "stft_mag": ms.stft_mag,
            "row_medians": md.row_medians, "col_medians": md.col_medians,
            "stft_mel_bf16": ms.stft_mel_bf16}


# each DFT wrapper's routes counted as .<route>_launches
ROUTES = {"stft_mel": ("fft", "fft1", "bluestein", "cluster"),
          "stft_mag": ("fft", "fft1", "bluestein", "cluster"), "stft_mel_bf16": ("dif", "direct")}


def reset_counts():
    for name, w in counters().items():
        w.launches = 0
        for route in ROUTES.get(name, ()):
            setattr(w, f"{route}_launches", 0)


def read_counts():
    """Launches per kernel, and per DFT wrapper each route's launches
    under ``<name>.<route>``."""
    got = {k: w.launches for k, w in counters().items()}
    got.update({f"{k}.{route}": getattr(counters()[k], f"{route}_launches")
                for k, routes in ROUTES.items() for route in routes})
    return got


# the one-buffer and cluster routes run on no main path (their n_fft are
# not the main paths'); the n_fft 8192 CLI phase requires stft_mel.fft1,
# the n_fft 16384 one stft_mel.cluster
OFF_MAIN_ROUTES = {"stft_mel.fft1": 0, "stft_mel.bluestein": 0, "stft_mel.cluster": 0,
                   "stft_mag.fft1": 0, "stft_mag.bluestein": 0, "stft_mag.cluster": 0}


def require_launches(tag, launches, expect):
    """`expect` maps a kernel to its least count on the path; 0 means the
    path must not launch it at all."""
    bad = {k: launches[k] for k, least in expect.items()
           if (launches[k] < least if least else launches[k] != 0)}
    if bad:
        raise AssertionError(f"{tag}: launches {launches}, expected {expect}")


def run_cli(wav, models, device, flag="--bird-model"):
    """One CLI run in this process, ``flag`` given once per model dir in
    `models` (one dir or a list); returns (result JSON, wall seconds,
    launches per kernel)."""
    import torch

    from audio_analysis_torch.cli.analyse import run

    argv = ["-o", str(wav), "--seed", "0", "--device", device]
    for m in models if isinstance(models, list) else [models]:
        argv += [flag, str(m)]
    reset_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        run(argv)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    return json.loads(buf.getvalue()), wall, launches


def run_batch_cli(wavs, models, device, timer=None):
    """One batch CLI run in this process (``--batch-size 8 --seed 0``), its
    stages added into `timer` (a StageTimer) when given; returns (result
    JSON list, wall seconds, launches per kernel)."""
    import torch

    from audio_analysis_torch.cli.batch import run

    reset_counts()
    argv = ["-o", "--batch-size", "8", "--seed", "0", "--device", device]
    for m in models:
        argv += ["--bird-model", str(m)]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        run(argv + [str(w) for w in wavs], timer=timer)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    return json.loads(buf.getvalue()), wall, launches


def without_times(results):
    """Batch results without their wall-clock field."""
    return [{"file": r["file"], "analysis": {
        k: v for k, v in r["analysis"].items() if k != "processing_time_seconds"
    }} for r in results]


def profile_device(fn):
    """fn() under torch.profiler, to a synchronize: wall time (host clock),
    device busy time (the union of the device's kernel intervals), idle
    share, kernel count, device time by kernel name and the host's own time
    (self CPU time) by operator."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    busy, end = 0.0, float("-inf")
    for a, b in spans:  # length of the union of the intervals, in us
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:8]
    return dict(
        profiled_wall_ms=wall * 1e3, device_busy_ms=busy / 1e3,
        idle_share=1.0 - busy / 1e3 / (wall * 1e3), device_kernels=len(spans),
        max_pool_kernels=sum(n for name, (n, _) in by_name.items() if "max_pool" in name),
        top=[[name[:70], n, t / 1e3] for name, (n, t) in top],
        host_top=[[a.key[:50], a.count, a.self_cpu_time_total / 1e3] for a in host],
    )


def count_labels(results, model=None):
    """Predictions above threshold over result JSONs (of `model`'s results
    alone, when given)."""
    return sum(len(r["predictions"]) for res in results for t in res["species_identify"]
               for r in t.get("model_results", []) if model in (None, r["model"]))


def effnet_grid(pcm, n=EFFNET_WINDOWS):
    """[n, 160, 226, 3] features of `n` 3 s windows of the recording's
    sound, through the EfficientNet fixture's frontend (exact level) on the
    card."""
    import torch

    from audio_analysis_torch.pipeline.frontend import EXACT, spectrogram_grid

    y = torch.from_numpy(pcm).to(torch.device("cuda"))
    bases = np.arange(n) * ((int(SILENT_FROM * SR) - 3 * SR) // n)
    windows = torch.stack([y[b : b + 3 * SR] for b in bases])
    feats = spectrogram_grid(windows, level=EXACT, sr=SR, hop_length=640, n_fft=4096,
                             n_mels=160, mel_break=1750.0, htk=True, fmin=50, fmax=11000,
                             power=2.0, db_scale=True, normalize=True)
    return feats.repeat_interleave(3, dim=-1).contiguous()


def check_efficientnet(model_dir, grid):
    """EfficientNetB0 alone on `grid` [n, 160, 226, 3]: float32 on the card
    (TF32 off) against float32 on the CPU (max abs <= EFFNET_F32_TOL),
    bfloat16 on the card against float32 on the card (max abs <=
    EFFNET_BF16_MAX, mean <= EFFNET_BF16_MEAN, the same argmax wherever
    float32's top two are more than EFFNET_BF16_MAX apart); ms per forward
    at both dtypes (CUDA events), windows/s, and one profiled forward of
    each: the host's time to enqueue it (``enqueue_ms``) against its wall
    time, device busy time and idle share. Returns the measurement."""
    import torch

    from audio_analysis_torch.models import KerasModel

    path = Path(model_dir) / "audioModel.keras"
    dev = torch.device("cuda")
    nets = {"float32": KerasModel.load(path).to(dev),
            "bfloat16": KerasModel.load(path, compute_dtype="bfloat16").to(dev)}
    m = {"windows": int(grid.shape[0]), "shape": list(grid.shape)}
    with torch.inference_mode():
        probs = {k: net(grid) for k, net in nets.items()}
        torch.cuda.synchronize()
        cpu = KerasModel.load(path)(grid.cpu())
        for k, p in probs.items():
            if p.shape != (grid.shape[0], len(EFFNET_LABELS)) or not bool(torch.isfinite(p).all()):
                raise AssertionError(f"EfficientNetB0 {k}: shape {tuple(p.shape)} or non-finite")
        f32, bf16 = probs["float32"], probs["bfloat16"]
        m["f32_card_vs_cpu_max_abs"] = float((f32.cpu() - cpu).abs().max())
        dev_b = (bf16 - f32).abs()
        m["bf16_vs_f32_max_abs"], m["bf16_vs_f32_mean_abs"] = float(dev_b.max()), float(dev_b.mean())
        top2 = f32.topk(2, dim=1).values
        clear = (top2[:, 0] - top2[:, 1]) > EFFNET_BF16_MAX
        m["argmax_clear"] = int(clear.sum())
        m["argmax_flips_where_clear"] = int(((bf16.argmax(1) != f32.argmax(1)) & clear).sum())
        m["f32_argmax_counts"] = torch.bincount(f32.argmax(1), minlength=8).tolist()
        m["f32_max_prob"] = float(f32.max())
        for k, net in nets.items():
            ms = time_ms(lambda: net(grid), 10)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            net(grid)
            enqueue = time.perf_counter() - t0
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            prof = profile_device(lambda: net(grid))
            m[k] = dict(ms=ms, windows_per_s=grid.shape[0] / ms * 1e3, enqueue_ms=enqueue * 1e3,
                        wall_ms=wall * 1e3, host_share=enqueue / wall,
                        **{key: prof[key] for key in ("profiled_wall_ms", "device_busy_ms",
                                                      "idle_share", "device_kernels", "top",
                                                      "host_top")})
            m[k]["top"] = m[k]["top"][:6]
    log(json.dumps({"efficientnet_b0": m}))
    if not m["f32_card_vs_cpu_max_abs"] <= EFFNET_F32_TOL:
        raise AssertionError(f"EfficientNetB0 float32 card vs CPU: {m['f32_card_vs_cpu_max_abs']:.3g}"
                             f" (limit {EFFNET_F32_TOL})")
    if not (m["bf16_vs_f32_max_abs"] <= EFFNET_BF16_MAX
            and m["bf16_vs_f32_mean_abs"] <= EFFNET_BF16_MEAN):
        raise AssertionError(f"EfficientNetB0 bfloat16 vs float32: {m['bf16_vs_f32_max_abs']:.3g} "
                             f"max, {m['bf16_vs_f32_mean_abs']:.3g} mean")
    if m["argmax_flips_where_clear"]:
        raise AssertionError("EfficientNetB0 bfloat16 changes a clear argmax")
    return m


def check_resample(tmp):
    """The seeded 60 s recording written as 16-bit WAVs at 44.1, 32 and
    96 kHz, each loaded through ``load_recording`` on the card and on the
    CPU: 48 kHz float32 of the same length, card vs CPU within
    RESAMPLE_TOL. Times the card's resample of the decoded PCM (CUDA events
    over 5 runs) beside its bound: the PCM read and written once, and the
    filter's nonzero multiply-adds at the float32 rate (the polyphase bank
    pads every phase to one width with zeros; those products are the
    convolution's waste, not the function's work). Returns {rate: WAV path}."""
    import torch

    from audio_analysis_torch.io.audio import load_audio_mono, load_recording, write_wav
    from audio_analysis_torch.ops.resample import _filter_const, _polyphase_bank, resample

    wavs = {}
    for sr in RESAMPLE_RATES:
        wavs[sr] = tmp / f"rec60_{sr}.wav"
        write_wav(wavs[sr], make_recording(sr=sr), sr)
        card, card_sr = load_recording(wavs[sr], device="cuda")
        cpu, cpu_sr = load_recording(wavs[sr], device="cpu")
        if (card_sr, cpu_sr, card.shape, card.dtype) != (SR, SR, (SECONDS * SR,), np.float32) \
                or cpu.shape != card.shape or not np.isfinite(card).all():
            raise AssertionError(f"load_recording at {sr} Hz: {card_sr} Hz, {card.shape}, "
                                 f"{card.dtype} on the card; {cpu_sr} Hz, {cpu.shape} on the CPU")
        err = float(np.abs(card - cpu).max())
        x = torch.from_numpy(load_audio_mono(wavs[sr])[0]).to(torch.device("cuda"))
        g = math.gcd(SR, sr)
        up, down = SR // g, sr // g
        if up == 1:
            macs = conv_macs = SECONDS * SR * len(_filter_const(up, down))
        else:
            bank = _polyphase_bank(up, down)[0]
            n_blocks = -(-SECONDS * SR // up)
            macs, conv_macs = n_blocks * int(np.count_nonzero(bank)), n_blocks * bank.size
        byte_ms = (x.numel() + SECONDS * SR) * 4 / HBM_BYTES_PER_S * 1e3
        m = dict(rate=sr, up=up, down=down, max_abs_card_vs_cpu=err,
                 ms=time_ms(lambda: resample(x, sr, SR), 5), macs=macs, conv_macs=conv_macs,
                 bound_ms=max(byte_ms, 2 * macs / F32_FLOPS * 1e3))
        log(json.dumps({"resample": m}))
        if not err <= RESAMPLE_TOL:
            raise AssertionError(f"resample at {sr} Hz: card vs CPU {err:.3g} "
                                 f"(limit {RESAMPLE_TOL})")
    return wavs


@contextlib.contextmanager
def capture_sosfilt(stacks):
    """Within the block, append each band-pass call's (coefficients, track
    stack) to `stacks`; the filter still runs."""
    from audio_analysis_torch.pipeline import classify

    real = classify.sosfilt_array

    def recording(sos, x):
        stacks.append((sos, x.clone()))
        return real(sos, x)

    classify.sosfilt_array = recording
    try:
        yield stacks
    finally:
        classify.sosfilt_array = real


def sosfilt_timing(stacks):
    """The band-pass filter on the first captured track stack, on the card:
    rows, samples and ms (CUDA events over 5 runs)."""
    from audio_analysis_torch.ops.filters import sosfilt_array

    sos, x = stacks[0]
    return dict(rows=int(x.shape[0]), samples=int(x.shape[1]),
                sosfilt_ms=time_ms(lambda: sosfilt_array(sos, x), 5))


def check_packed_morphology(path, spec, nvf):
    """The detection mask tail on a path's own normalised spectrogram `spec`
    [B, bins, T] and valid frames `nvf`: the packed-word morphology on the
    card bit for bit against the float max-pool plain version (both as
    packed int32 words), with the device ms of each (CUDA events), the host's
    time to enqueue the packed path (median of 5 calls, each from an idle
    card), and its device kernels (torch.profiler). Returns the
    measurement."""
    import torch

    from audio_analysis_torch.detect import signal_noise as sn
    from audio_analysis_torch.ops.medians import masked_medians_rowcol

    row_m, col_m = masked_medians_rowcol(spec, nvf)
    col_valid = torch.arange(spec.shape[-1], device=spec.device)[None, :] < nvf[:, None]
    kw = dict(sr=SR, hop_length=281, n_fft=4096)
    args = (spec, row_m, col_m, col_valid)
    packed = sn._mask_threshold_morph(*args, **kw)
    plain = sn.pack_words(sn.mask_threshold_morph_plain(*args, **kw))
    torch.cuda.synchronize()
    differ = int((packed != plain).sum())
    m = dict(path=path, shape=list(spec.shape), set_words=int((packed != 0).sum()),
             differing_words=differ,
             ms=time_ms(lambda: sn._mask_threshold_morph(*args, **kw), 5),
             plain_ms=time_ms(lambda: sn.mask_threshold_morph_plain(*args, **kw), 3))
    enqueue = []
    for _ in range(5):
        t0 = time.perf_counter()
        sn._mask_threshold_morph(*args, **kw)
        enqueue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    m["host_enqueue_ms"] = statistics.median(enqueue)
    prof = profile_device(lambda: sn._mask_threshold_morph(*args, **kw))
    m.update(device_kernels=prof["device_kernels"], device_busy_ms=prof["device_busy_ms"],
             profiled_wall_ms=prof["profiled_wall_ms"], max_pool_kernels=prof["max_pool_kernels"])
    log(json.dumps({"packed_morphology": m}))
    if differ or not m["set_words"]:
        raise AssertionError(f"packed morphology ({path}): {differ} words differ from the float "
                             f"max-pool version ({m['set_words']} set)")
    return m


def detection_profile(wavs):
    """One detection of the fast batch's recordings (int16 [B, T] on the
    card, the fast level) under torch.profiler; it must launch no
    max-pool kernel."""
    import torch

    from audio_analysis_torch.detect.signal_noise import detect_batch_dispatch, detect_batch_finish
    from audio_analysis_torch.io.audio import load_recording
    from audio_analysis_torch.pipeline.frontend import frontend_level

    recs = [load_recording(w, prefer_int16=True)[0] for w in wavs]
    frames = torch.from_numpy(np.stack(recs)).to(torch.device("cuda"))
    n_valid = [len(r) for r in recs]
    level = frontend_level()
    detect_batch_finish(detect_batch_dispatch(frames, n_valid, SR, level=level))
    prof = profile_device(lambda: detect_batch_finish(
        detect_batch_dispatch(frames, n_valid, SR, level=level)))
    log(json.dumps({"profile": "batch detection", "device": "cuda", **prof}))
    if prof["max_pool_kernels"]:
        raise AssertionError(f"detection launched {prof['max_pool_kernels']} max-pool kernels")
    return prof


def run_old_index(wav, device):
    """``analyse --old-cacophony-index`` in this process; returns its JSON
    without the wall-clock field."""
    from audio_analysis_torch.cli.analyse import run

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run(["-o", "--old-cacophony-index", str(wav), "--device", device])
    res = json.loads(buf.getvalue())
    res.pop("processing_time_seconds")
    return res


def summary_of(res):
    return dict(
        duration=res["duration"], signals=len(res["chirps"]["signals"]),
        tracks=len(res["species_identify"]), chirps=res["chirps"]["chirps"],
        cacophony_index=res["cacophony_index"], timing=res.get("timing"),
        processing_time_seconds=res["processing_time_seconds"],
    )


def _round3(obj):
    """Floats rounded to 3 places, as tests/test_golden_snapshot.py compares."""
    if isinstance(obj, dict):
        return {k: _round3(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_round3(v) for v in obj]
    return round(obj, 3) if isinstance(obj, float) else obj


def check_golden(device):
    """The port's analysis of the golden recording with the golden model on
    `device`, held to tests/data/golden_snapshot.json: length, duration and
    signals identical, then `compare_results` over the tracks, all with
    floats rounded to 3 places. Raises AssertionError on a difference."""
    from audio_analysis_torch.pipeline.cacophony import (
        calc_cacophony_index, filter_tracks, get_chirps, get_max_chirps,
    )
    from audio_analysis_torch.pipeline.classify import classify_frames

    tracks, length, signals, raw_length, labels = classify_frames(
        golden_recording(), SR, [str(GOLDEN_MODEL)], False, None, rng=None, device=device
    )
    for tr in tracks:
        tr.set_master_tag()
    got = _round3(json.loads(json.dumps({
        "duration": raw_length, "length": length,
        "signals": [s.to_array() for s in signals],
        "chirps": get_chirps(tracks, labels, signals), "max_chirps": get_max_chirps(length),
        "cacophony_index": calc_cacophony_index(filter_tracks(tracks), length)[0],
        "species_identify": [tr.get_meta() for tr in tracks],
    })))
    ref = _round3(json.loads(GOLDEN_SNAPSHOT.read_text()))
    ref["species_identify"] = ref.pop("tracks")
    for k in ("length", "max_chirps", "signals"):
        if got[k] != ref[k]:
            raise AssertionError(f"golden {k}: {got[k]} vs {ref[k]}")
    compare_results(got, ref)


# ---------------------------------------------------------------------------
# the upload path: the wire codec, the stream against one worker, conversion
# and tracing
# ---------------------------------------------------------------------------

# A B B A rounds: the exact CLI's codec on/off in two (A B B A B A A B), the
# backlog's four settings in five (forwards, then backwards: ten runs each)
EXACT_TURNS, BACKLOG_TURNS = 2, 5


def stream_one_worker(analyzer, batches, sr=None, meta_batches=None, analyse_tracks=False,
                      timer=None):
    """``BatchAnalyzer.analyse_stream`` with batch k+1's prepare and
    dispatch on one worker thread while this thread finishes batch k: the
    JAX package's AAT_ASYNC_UPLOAD default
    (audio_analysis_tpu/pipeline/serve.py:187-228), which the port does
    not take; here only to time it against the port's stream. The worker
    makes the analyzer's device its current one; the kernel counters are
    not read after it (two threads count at once)."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from audio_analysis_torch.utils.runtime import StageTimer

    timer = timer or StageTimer()
    metas = iter(meta_batches) if meta_batches is not None else None
    index = analyzer.device.index
    pool = ThreadPoolExecutor(max_workers=1, initializer=torch.cuda.set_device,
                              initargs=(torch.cuda.current_device() if index is None else index,))
    try:
        prev = None
        for batch in batches:
            md = next(metas) if metas is not None else None
            fut = pool.submit(analyzer._dispatch, batch, sr, md, analyse_tracks)
            if prev is not None:
                with timer.stage("dispatch_wait"):
                    handle = prev.result()
                yield analyzer._finish(handle, timer=timer)
            prev = fut
        if prev is not None:
            with timer.stage("dispatch_wait"):
                handle = prev.result()
            yield analyzer._finish(handle, timer=timer)
    finally:
        pool.shutdown(wait=True)


def pair_wins(a, b):
    """How many of the pairs (a[i], b[i]) b wins (ties count for neither),
    the medians and the spread of a's runs (its quartiles' distance)."""
    q = statistics.quantiles(a, n=4)
    return {"pairs": len(a), "wins": sum(y > x for x, y in zip(a, b)),
            "losses": sum(y < x for x, y in zip(a, b)),
            "median_a": statistics.median(a), "median_b": statistics.median(b),
            "spread_a": q[2] - q[0]}


@contextlib.contextmanager
def env(**values):
    """os.environ with `values` set (None: unset), restored after."""
    saved = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def without_volatile(res):
    """A result JSON without its wall-clock fields."""
    return {k: v for k, v in res.items() if k not in ("processing_time_seconds", "timing")}


def in_turns(configs, run, turns):
    """run(config) over `configs` forwards, then backwards, `turns` times
    (A B B A ...); returns {config: [result, ...]}."""
    out = {c: [] for c in configs}
    for i in range(turns):
        for c in (configs if i % 2 == 0 else configs[::-1]):
            out[c].append(run(c))
        for c in (configs[::-1] if i % 2 == 0 else configs):
            out[c].append(run(c))
    return out


def decode_timing(stacked):
    """The wire codec on the int16 [B, T] batch `stacked`: the native
    encode's host ms, the wire ratio, the card's decode (its copy of the
    encoded words included) against the pinned raw int16 copy, each as CUDA
    events over 10 calls and as the host's wall to a synchronize, and the
    device operations one decode queues (torch.profiler)."""
    import torch

    from audio_analysis_torch.io import pcmcodec as pc

    t0 = time.perf_counter()
    enc = pc.encode_pcm(stacked)
    encode_ms = (time.perf_counter() - t0) * 1e3
    encode_ms = min(encode_ms, *(_wall_ms(lambda: pc.encode_pcm(stacked)) for _ in range(3)))
    pinned = torch.from_numpy(stacked).pin_memory()

    def decode():
        return pc.decode_pcm(enc, "cuda")

    def raw():
        return pinned.to("cuda", non_blocking=True)

    prof = profile_device(decode)
    return {"shape": list(stacked.shape), "raw_bytes": int(stacked.nbytes),
            "wire_bytes": int(pc.wire_bytes(enc)),
            "wire_ratio": pc.wire_bytes(enc) / stacked.nbytes, "order": enc.order,
            "tiers": len(enc.tiers), "exceptions": 0 if enc.exceptions is None
            else int(len(enc.exceptions[0])),
            "encode_ms": encode_ms, "decode_ms": time_ms(decode, 10),
            "raw_copy_ms": time_ms(raw, 10),
            "decode_wall_ms": min(_wall_ms(decode) for _ in range(5)),
            "raw_copy_wall_ms": min(_wall_ms(raw) for _ in range(5)),
            "decode_device_ops": prof["device_kernels"],
            "decode_device_busy_ms": prof["device_busy_ms"]}


def _wall_ms(fn):
    import torch

    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def check_upload(tmp, wav, model_dir, wavs, backlog, models, exact_path, fast_path,
                 device="cuda"):
    """The upload path on the card: the native encoder builds; the card's
    decode equals decode_pcm_np bit for bit on the fast batch's eight WAVs
    and on ``codec_edge_case`` at every order; the exact CLI and the fast
    batch give equal results with AAT_WIRE_CODEC 0 and 1, and the backlog
    through the stream and through ``stream_one_worker`` with the codec on
    and off; every stream run's launches checked; the decode's and the
    encode's timings, the exact CLI's warm wall with the codec on and off
    and the backlog's audio-s/s in each of the four settings, in turns, with
    the worker's wins over ten pairs a codec setting; a morepork member with a stale
    conversion raises without tensorflow, a current one loads; and a trace
    of one exact CLI run (the CLI's own under AAT_TRACE_DIR) names the
    detection kernels and the spans. Returns the measurements and the launches."""
    import torch

    from audio_analysis_torch.io import pcmcodec as pc
    from audio_analysis_torch.io.audio import load_recording
    from audio_analysis_torch.native import load_pcmcodec_library
    from audio_analysis_torch.pipeline import morepork as mp
    from audio_analysis_torch.pipeline.serve import BatchAnalyzer
    from audio_analysis_torch.utils.runtime import StageTimer

    t_phase = time.perf_counter()
    if load_pcmcodec_library() is None:
        raise AssertionError("the native PCM encoder (native/pcmcodec.cpp) did not build")
    with env(AAT_WIRE_CODEC=None):
        if pc.wire_codec_enabled():
            raise AssertionError("AAT_WIRE_CODEC unset: the codec must be off")
    stacked = np.stack([load_recording(w, prefer_int16=True)[0] for w in wavs])
    if stacked.dtype != np.int16:
        raise AssertionError(f"the batch's WAVs load as {stacked.dtype}")
    enc = pc.encode_pcm(stacked)
    got = pc.decode_pcm(enc, device).cpu().numpy()
    if not (np.array_equal(got, pc.decode_pcm_np(enc)) and np.array_equal(got, stacked)):
        raise AssertionError("the card's decode of the batch differs from decode_pcm_np")
    for order in range(4):
        e = codec_edge_case(order, seed=order)
        if not np.array_equal(pc.decode_pcm(e, device).cpu().numpy(), pc.decode_pcm_np(e)):
            raise AssertionError(f"the card's decode of codec_edge_case({order}) differs")
    m = {"decode": decode_timing(stacked)}
    log(json.dumps({"upload_decode": m["decode"], "card": card_line()}))
    launches = {}

    # the exact CLI, codec on and off, in turns
    def exact(codec):
        with env(AAT_WIRE_CODEC=codec, AAT_FAST=None):
            res, wall, n = run_cli(wav, model_dir, device)
        require_launches(f"upload exact codec {codec}", n, exact_path)
        launches[f"analyse_exact_codec_{codec}"] = n
        return without_volatile(res), wall

    exact("1"), exact("0")  # warm both
    runs = in_turns(["1", "0"], exact, EXACT_TURNS)
    if any(r != runs["1"][0][0] for c in runs for r, _ in runs[c]):
        raise AssertionError("the exact CLI differs between AAT_WIRE_CODEC 1 and 0")
    m["exact_cli_wall_s"] = {f"codec_{c}": [w for _, w in runs[c]] for c in runs}

    # the fast batch, codec on and off
    with env(AAT_FAST="1"):
        batch = {}
        for codec in ("1", "0"):
            with env(AAT_WIRE_CODEC=codec):
                res, wall, n = run_batch_cli(wavs, models, device)
            require_launches(f"upload batch codec {codec}", n, fast_path)
            launches[f"batch_fast_codec_{codec}"] = n
            batch[codec] = without_times(res)
        if batch["1"] != batch["0"]:
            raise AssertionError("the fast batch differs between AAT_WIRE_CODEC 1 and 0")

        # the backlog through the stream and one worker, codec on and off,
        # in turns
        backlog_path = {k: 3 * least for k, least in fast_path.items()}
        configs = [(mode, codec) for codec in ("0", "1") for mode in ("stream", "worker")]
        stages = {}

        def run_backlog(config):
            mode, codec = config
            timer = StageTimer()
            worker = (mock.patch.object(BatchAnalyzer, "analyse_stream", stream_one_worker)
                      if mode == "worker" else contextlib.nullcontext())
            with env(AAT_WIRE_CODEC=codec), worker:
                res, wall, n = run_batch_cli(backlog, models, device, timer)
            if mode == "stream":
                require_launches(f"upload backlog codec {codec}", n, backlog_path)
                launches[f"backlog_fast_codec_{codec}"] = n
            stages.setdefault(f"{mode}_codec_{codec}", []).append(timer.as_dict())
            return without_times(res), wall

        backlogs = in_turns(configs, run_backlog, BACKLOG_TURNS)
    first = backlogs[configs[0]][0][0]
    if any(r != first for c in configs for r, _ in backlogs[c]):
        raise AssertionError("the backlog differs between stream and worker or codec settings")
    if first[:8] != batch["1"]:
        raise AssertionError("the backlog's first batch differs from the fast batch")
    rate = {c: [len(backlog) * SECONDS / w for _, w in backlogs[c]] for c in configs}
    m["backlog_audio_s_per_s"] = {f"{mode}_codec_{codec}": rate[(mode, codec)]
                                  for mode, codec in configs}
    m["worker_vs_stream"] = {f"codec_{codec}": pair_wins(rate[("stream", codec)],
                                                         rate[("worker", codec)])
                             for codec in ("0", "1")}
    m["codec_on_vs_off"] = pair_wins(rate[("stream", "0")], rate[("stream", "1")])
    log(json.dumps({"upload_turns": {k: m[k] for k in ("exact_cli_wall_s", "backlog_audio_s_per_s",
                                                        "worker_vs_stream", "codec_on_vs_off")},
                    "backlog_stages": stages, "card": card_line()}))

    # conversion: without tensorflow a stale member raises the JAX
    # package's RuntimeError, a current one loads
    ensemble = morepork_ensemble(tmp / "convert-check", members=2)
    stale = tmp / "convert-check-stale"
    shutil.copytree(ensemble / "member0", stale)
    (stale / ".aat_native" / ".stamp").write_text("1")
    hidden = {k: sys.modules.get(k) for k in ("tensorflow", "tf_keras")}
    sys.modules.update({k: None for k in hidden})
    try:
        mp._load_morepork_model(ensemble / "member0", torch.device(device))
        try:
            mp._load_morepork_model(stale, torch.device(device))
        except RuntimeError as e:
            if "requires tensorflow" not in str(e):
                raise
        else:
            raise AssertionError("a stale conversion loaded without tensorflow")
    finally:
        for k, v in hidden.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v

    # tracing: one exact CLI run under AAT_TRACE_DIR, which writes its trace
    with env(AAT_TRACE_DIR=str(tmp / "traces"), AAT_FAST=None):
        run_cli(wav, model_dir, device)
    trace = json.loads((tmp / "traces" / "analyse" / "trace.json").read_text())
    kernels = {e["name"] for e in trace["traceEvents"] if e.get("cat") == "kernel"}
    for name in ("stft_mag_fft_kernel", "row_medians_kernel"):
        if not any(name in k for k in kernels):
            raise AssertionError(f"the trace names no {name}: {sorted(kernels)[:20]}")
    names = {e.get("name") for e in trace["traceEvents"]}
    if not {"span:detect.ccl", "span:infer.forward"} <= names:
        raise AssertionError("the CLI's trace holds no span:detect.ccl or span:infer.forward")
    m["trace_kernels"] = len(kernels)
    m["phase_s"] = time.perf_counter() - t_phase
    return m, launches


# ---------------------------------------------------------------------------
# the side paths: the morepork detector, embeddings groups, the mfcc frontend
# ---------------------------------------------------------------------------


def check_morepork(tmp, wav_by_rate, device="cuda"):
    """``analyse --morepork-model`` with a three-member ensemble
    (``morepork_ensemble``) on the 60 s fixture at each rate of
    `wav_by_rate`: cold and warm on `device` and once on the CPU, the spans
    and likelihoods identical, at least one span, no kernel of the repo
    launched (the |STFT| is ``torch.fft``, as the JAX package's is XLA's
    rfft); then on `device` the |STFT|'s and the samples' ms, each member's
    ms over the samples (CUDA events) and one warm run profiled. Returns
    the measurements and the launches."""
    import torch

    from audio_analysis_torch.io.audio import load_audio_mono
    from audio_analysis_torch.pipeline import morepork as mp

    t0 = time.perf_counter()
    ensemble = morepork_ensemble(tmp / "morepork")
    m = {"fixture_s": time.perf_counter() - t0, "spans": {}}
    none = {k: 0 for k in counters()}

    def run(wav, dev):
        res, wall, launches = run_cli(wav, ensemble, dev, flag="--morepork-model")
        res.pop("processing_time_seconds")
        return res, wall, launches

    for rate, wav in wav_by_rate.items():
        runs = {}
        for tag, dev in (("cold", device), ("warm", device), ("cpu", "cpu")):
            runs[tag], wall, launches = run(wav, dev)
            log(json.dumps({"morepork_run": f"{rate} Hz {tag}", "device": dev, "wall_s": wall,
                            "spans": len(runs[tag]["morepork"]), "launches": launches}))
            require_launches(f"morepork {rate} Hz {tag}", launches, none)
            if rate == SR and tag == "warm":
                m["launches"] = launches
        if not runs["cold"] == runs["warm"] == runs["cpu"]:
            raise AssertionError(f"morepork at {rate} Hz: the card's spans differ from the "
                                 f"CPU's: {runs['cold']} vs {runs['cpu']}")
        spans = runs["cold"]["morepork"]
        if not spans:
            raise AssertionError(f"morepork at {rate} Hz: no span")
        m["spans"][rate] = [[e["begin_s"], e["end_s"], e["predictions"][0]["likelihood"][0]]
                            for e in spans]
    dev = torch.device(device)
    frames, sr = load_audio_mono(wav_by_rate[SR])
    x = torch.from_numpy(frames).to(dev)
    nets = [mp._load_morepork_model(p, dev) for p in mp.model_paths(str(ensemble))]
    with torch.inference_mode():
        spec = mp._spectrogram_program(x, sr=sr)
        lows, lengths, _ = mp._sample_grid(int(spec.shape[1]))
        lows, lengths = torch.from_numpy(lows).to(dev), torch.from_numpy(lengths).to(dev)
        samples = mp._samples_program(spec, lows, lengths)
        m["samples_shape"] = list(samples.shape)
        m["stft_ms"] = time_ms(lambda: mp._spectrogram_program(x, sr=sr), 10)
        m["samples_ms"] = time_ms(lambda: mp._samples_program(spec, lows, lengths), 10)
        m["member_ms"] = [time_ms(lambda: net(samples), 10) for net in nets]
    prof = profile_device(lambda: run(wav_by_rate[SR], device))
    m["profile"] = {k: prof[k] for k in ("profiled_wall_ms", "device_busy_ms", "idle_share",
                                         "device_kernels", "top")}
    log(json.dumps({"morepork": m}))
    return m


@contextlib.contextmanager
def capture_embeddings(captured):
    """Within the block, record the arguments of the first embeddings group
    call (the PCM, its rate, the tracks, the stride, the embedder) into
    `captured["args"]`; the call still runs."""
    from audio_analysis_torch.pipeline import classify

    chirp = classify.chirp_embeddings

    def recording(frames, sr, tracks, stride, embedder):
        captured.setdefault("args", (frames.clone(), sr, list(tracks), stride, embedder))
        return chirp(frames, sr, tracks, stride, embedder)

    classify.chirp_embeddings = recording
    try:
        yield captured
    finally:
        classify.chirp_embeddings = chirp


def embeddings_timing(frames, sr, tracks, stride, embedder):
    """ms (CUDA events) of an embeddings group's steps on one recording's
    captured arguments: the 48 -> 32 kHz resample, the window gather (host
    starts included) and the embedder's forward over all the windows."""
    import torch

    from audio_analysis_torch.ops.resample import resample
    from audio_analysis_torch.pipeline.classify import float_pcm
    from audio_analysis_torch.pipeline.embeddings import EMBED_SR, get_chirp_samples

    x = float_pcm(frames)
    with torch.inference_mode():
        rec = resample(x, sr, EMBED_SR)
        windows, _ = get_chirp_samples(rec, tracks, stride=stride)
        return {"tracks": len(tracks), "windows": list(windows.shape),
                "resample_ms": time_ms(lambda: resample(x, sr, EMBED_SR), 5),
                "gather_ms": time_ms(lambda: get_chirp_samples(rec, tracks, stride=stride), 5),
                "embedder_ms": time_ms(lambda: embedder(windows), 5)}


def check_embeddings(tmp, wav, wavs, pre_model, exact_path, fast_path, device="cuda"):
    """Embeddings groups (``embedder_fixture``, ``embeddings_head``):
    with a full-width float32 TuiNet as a second (pre-model) group, the
    exact analyse CLI cold and warm on `device` and on the CPU (equal as
    ``compare_results`` holds them, confidences within 1; embeddings labels
    present), its embeddings steps timed (``embeddings_timing``); then
    under AAT_FAST=1 the batch CLI on the eight WAVs with the batch's
    bfloat16 `pre_model`, cold and warm, the first two on the CPU
    (confidences within 2), and with the embeddings group alone (one
    end-scan, no frontend). Returns the measurements and the launches."""
    from audio_analysis_torch.utils.runtime import StageTimer

    t0 = time.perf_counter()
    head = embeddings_head(tmp / "embeddings",
                           embedder_fixture(tmp / "embedder" / "audioModel.keras"))
    tui_pre = write_tuinet_model(tmp / "tuinet-pre", name="tuinet-pre", pre_model=True)
    m = {"fixture_s": time.perf_counter() - t0, "launches": {}}
    runs, captured = {}, {}
    for tag in ("cold", "warm"):
        with capture_embeddings(captured) if tag == "cold" else contextlib.nullcontext():
            runs[tag], wall, launches = run_cli(wav, [head, tui_pre], device)
        log(json.dumps({"cli_run": f"embeddings {tag}", "device": device, "wall_s": wall,
                        "launches": launches, "labels": count_labels([runs[tag]], "embeddings"),
                        **summary_of(runs[tag])}))
        require_launches(f"embeddings {tag} run", launches, exact_path)
    m["launches"]["analyse_exact_embeddings"] = launches
    if runs["warm"]["species_identify"] != runs["cold"]["species_identify"]:
        raise AssertionError("the warm embeddings run differs from the cold run")
    cpu, wall, _ = run_cli(wav, [head, tui_pre], "cpu")
    worst = compare_results(runs["cold"], cpu, confidence_tol=1)
    if not count_labels([cpu], "embeddings") or not count_labels([cpu], "tuinet-pre"):
        raise AssertionError(f"the embeddings CLI run on the CPU labels too little: "
                             f"{summary_of(cpu)}")
    m["exact"] = {"cpu_wall_s": wall, "max_confidence_diff": worst,
                  "labels": count_labels([cpu], "embeddings"),
                  **embeddings_timing(*captured["args"])}
    log(json.dumps({"embeddings_exact": m["exact"]}))

    os.environ["AAT_FAST"] = "1"
    for tag, group in (("batch_fast_embeddings", [head, pre_model]),
                       ("batch_fast_embeddings_alone", [head])):
        batch = {}
        for run in ("cold", "warm"):
            timer = StageTimer()
            batch[run], wall, launches = run_batch_cli(wavs, group, device, timer)
            log(json.dumps({"batch_run": f"{tag} {run}", "device": device,
                            "recordings": len(batch[run]), "wall_s": wall,
                            "audio_s_per_s": len(batch[run]) * SECONDS / wall,
                            "launches": launches, "timing": timer.as_dict(),
                            "labels": count_labels([r["analysis"] for r in batch[run]])}))
            # alone: the end-scan's stft_mel_bf16 and no frontend
            require_launches(f"{tag} {run} run", launches,
                             fast_path if len(group) > 1 else {**fast_path, "stft_mel_bf16": 1})
        m["launches"][tag] = launches
        if without_times(batch["warm"]) != without_times(batch["cold"]):
            raise AssertionError(f"{tag}: the warm batch differs from the cold batch")
        cpu_batch, wall, _ = run_batch_cli(wavs[:2], group, "cpu")
        worst = max(compare_results(g["analysis"], c["analysis"], confidence_tol=2)
                    for g, c in zip(batch["cold"], cpu_batch))
        if not count_labels([r["analysis"] for r in cpu_batch], "embeddings"):
            raise AssertionError(f"{tag}: no embeddings label on the CPU")
        m[tag] = {"cpu_wall_s": wall, "max_confidence_diff": worst}
        log(json.dumps({f"{tag}_card_vs_cpu": len(cpu_batch), **m[tag]}))
    os.environ.pop("AAT_FAST")
    return m


def check_mfcc(tmp, wav, wavs, pcm, exact_path, fast_path, device="cuda"):
    """A full-width TuiNet with ``"use_mfcc": true``: the exact analyse CLI
    cold and warm on `device` and on the CPU (confidences within 1, labels
    present), the AAT_FAST=1 batch CLI on the eight WAVs (bfloat16 TuiNet)
    cold and warm, the first two on the CPU (within 2); then the frontend's
    ms (CUDA events) over [64, 144000] windows at both levels with mfcc off
    and on. Returns the measurements and the launches."""
    import torch

    from audio_analysis_torch.pipeline.frontend import EXACT, FAST, spectrogram_grid
    from audio_analysis_torch.utils.runtime import StageTimer

    exact_model = write_tuinet_model(tmp / "tuinet-mfcc", name="tuinet-mfcc", use_mfcc=True)
    fast_model = write_tuinet_model(tmp / "bird-mfcc", net_dtype=None, name="bird-mfcc",
                                    use_mfcc=True)
    m = {"launches": {}}
    runs = {}
    for tag in ("cold", "warm"):
        runs[tag], wall, launches = run_cli(wav, exact_model, device)
        log(json.dumps({"cli_run": f"mfcc {tag}", "device": device, "wall_s": wall,
                        "launches": launches, "labels": count_labels([runs[tag]]),
                        **summary_of(runs[tag])}))
        require_launches(f"mfcc {tag} run", launches, exact_path)
    m["launches"]["analyse_exact_mfcc"] = launches
    if runs["warm"]["species_identify"] != runs["cold"]["species_identify"]:
        raise AssertionError("the warm mfcc run differs from the cold run")
    cpu, wall, _ = run_cli(wav, exact_model, "cpu")
    if not count_labels([cpu]):
        raise AssertionError("the mfcc CLI run on the CPU labels no track")
    m["exact"] = {"cpu_wall_s": wall,
                  "max_confidence_diff": compare_results(runs["cold"], cpu, confidence_tol=1)}

    os.environ["AAT_FAST"] = "1"
    batch = {}
    for tag in ("cold", "warm"):
        timer = StageTimer()
        batch[tag], wall, launches = run_batch_cli(wavs, [fast_model], device, timer)
        log(json.dumps({"batch_run": f"mfcc {tag}", "device": device,
                        "recordings": len(batch[tag]), "wall_s": wall,
                        "audio_s_per_s": len(batch[tag]) * SECONDS / wall,
                        "launches": launches, "timing": timer.as_dict(),
                        "labels": count_labels([r["analysis"] for r in batch[tag]])}))
        require_launches(f"mfcc batch {tag} run", launches, fast_path)
    m["launches"]["batch_fast_mfcc"] = launches
    if without_times(batch["warm"]) != without_times(batch["cold"]):
        raise AssertionError("the warm mfcc batch differs from the cold batch")
    cpu_batch, wall, _ = run_batch_cli(wavs[:2], [fast_model], "cpu")
    m["fast"] = {"cpu_wall_s": wall, "max_confidence_diff": max(
        compare_results(g["analysis"], c["analysis"], confidence_tol=2)
        for g, c in zip(batch["cold"], cpu_batch))}
    os.environ.pop("AAT_FAST")

    y = torch.from_numpy(pcm).to(torch.device(device))
    bases = np.arange(64) * ((int(SILENT_FROM * SR) - 3 * SR) // 64)
    windows = torch.stack([y[b : b + 3 * SR] for b in bases])
    kw = dict(sr=SR, hop_length=640, n_fft=4096, n_mels=160, mel_break=1750.0, htk=True,
              fmin=50, fmax=11000, power=2.0, db_scale=False, normalize=True)
    m["frontend_ms"] = {f"{level} mfcc {'on' if mfcc else 'off'}": time_ms(
        lambda: spectrogram_grid(windows, level=level, use_mfcc=mfcc, **kw), 5)
        for level in (EXACT, FAST) for mfcc in (False, True)}
    log(json.dumps({"mfcc": m}))
    return m


TRAIN_BATCH = 64  # TuiNet training: [64, 144000] PCM, 3 s windows
TRAIN_STEPS = 5  # timed steps a configuration
TRAIN_LOSS_RTOL = 1e-4  # card vs CPU, the first step's loss
TRAIN_GRAD_TOL = 1e-3  # card vs CPU, each gradient leaf, relative L2
FINETUNE_BATCH = 32  # EfficientNetB0 fine-tuning: [32, 160, 226, 3]
FINETUNE_LABELS = ["kiwi", "morepork", "tui", "noise"]


def train_windows(pcm, n, seed):
    """`n` 3 s windows of the recording's sound at seeded starts, and
    seeded labels (4 classes), on the card."""
    import torch

    rng = np.random.RandomState(seed)
    starts = rng.randint(0, int(SILENT_FROM * SR) - 3 * SR, n)
    windows = np.stack([pcm[s : s + 3 * SR] for s in starts])
    labels = rng.randint(0, 4, n)
    dev = torch.device("cuda")
    return torch.from_numpy(windows).to(dev), torch.from_numpy(labels).to(dev)


def grads_against_cpu(tag, net, forward, batch):
    """`forward(net, order)` -> loss over the batch taken in `order` (a
    permutation of range(`batch`)), run on the card's `net` and on its CPU
    copy in the natural order, and on a second CPU copy in a seeded
    permutation; backward on each. The losses must agree within
    TRAIN_LOSS_RTOL, and each parameter's gradient within TRAIN_GRAD_TOL in
    relative L2 norm, ||card - CPU|| / ||CPU||, or within 3x the CPU's own
    relative difference under the permutation where that is larger (the
    float32 noise of its sums: training-mode BatchNorm turns the gradients
    of the layers before it into sums that cancel). TF32 off. Also reports
    each leaf's max abs difference over its max abs. Returns the worst
    ratios and the losses."""
    import copy

    import torch

    natural = torch.arange(batch)
    shuffled = torch.from_numpy(np.random.RandomState(8).permutation(batch))
    cpu, cpu_p = copy.deepcopy(net).cpu(), copy.deepcopy(net).cpu()
    losses = [forward(net, natural), forward(cpu, natural), forward(cpu_p, shuffled)]
    for loss in losses:
        loss.backward()
    loss_g, loss_c, loss_p = (loss.item() for loss in losses)
    worst = {"over_tol": 0.0, "rel_l2": 0.0, "max_abs_over_max": 0.0, "cpu_noise_rel_l2": 0.0}
    for (name, g), (_, c), (_, q) in zip(net.named_parameters(), cpu.named_parameters(),
                                         cpu_p.named_parameters()):
        norm = float(c.grad.norm()) or 1.0
        rel = float((g.grad.cpu() - c.grad).norm()) / norm
        noise = float((q.grad - c.grad).norm()) / norm
        tol = max(TRAIN_GRAD_TOL, 3 * noise)
        if rel > tol:
            raise AssertionError(f"{tag}: gradient {name} card vs CPU {rel:.3g} in relative L2 "
                                 f"(tolerance {tol:.3g}; the CPU under a permutation {noise:.3g})")
        big = float(c.grad.abs().max()) or 1.0
        for k, v in (("over_tol", rel / tol), ("rel_l2", rel), ("cpu_noise_rel_l2", noise),
                     ("max_abs_over_max", float((g.grad.cpu() - c.grad).abs().max()) / big)):
            worst[k] = max(worst[k], v)
    rel = abs(loss_g - loss_c) / abs(loss_c)
    if rel > TRAIN_LOSS_RTOL:
        raise AssertionError(f"{tag}: loss card {loss_g} vs CPU {loss_c}")
    net.zero_grad(set_to_none=True)
    return {"loss": loss_g, "loss_cpu": loss_c, "loss_cpu_permuted": loss_p, "loss_rel": rel,
            **{f"worst_{k}": v for k, v in worst.items()},
            "zero_grad_params": sum(int(not p.grad.any()) for p in cpu.parameters())}


def timed_steps(one_step, windows):
    """One step to warm up, then TRAIN_STEPS timed with CUDA events (ms a
    step, windows/s), the peak memory over them, one profiled step (device
    busy, idle share) and one step with the kernel counts reset around
    it."""
    import torch

    one_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(one_step, TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated()
    prof = profile_device(one_step)
    reset_counts()
    one_step()
    torch.cuda.synchronize()
    return dict(ms=ms, windows_per_s=windows / ms * 1e3, peak_mem_bytes=peak,
                **{k: prof[k] for k in ("profiled_wall_ms", "device_busy_ms", "idle_share",
                                        "device_kernels")},
                top=prof["top"][:5], launches=read_counts())


def check_training(tmp, wav, pcm, effnet_dir):
    """The training path: TuiNet at full width trained from seeded
    weights carried in, and EfficientNetB0 fine-tuned with a new head; each
    served by the exact analyse CLI on the card and on the CPU. Returns the
    measurements and the launches of each path."""
    import torch

    from audio_analysis_torch.cli.train import checkpoint_meta
    from audio_analysis_torch.io.checkpoint import load_checkpoint_params, save_checkpoint
    from audio_analysis_torch.io.keras_export import write_keras_archive
    from audio_analysis_torch.io.modelconfig import ModelConfig
    from audio_analysis_torch.models import KerasModel
    from audio_analysis_torch.models.birdnet import TuiNet, TuiNetConfig
    from audio_analysis_torch.parallel import finetune, train
    from audio_analysis_torch.pipeline.classify import features_for_config

    dev = torch.device("cuda")
    m, launches = {"card": card_line()}, {}
    carried = load_checkpoint_params(write_tuinet_model(tmp / "train-init", seed=5))
    windows, labels = train_windows(pcm, TRAIN_BATCH, seed=5)
    os.environ.pop("AAT_FAST", None)

    # the first step against the CPU: through loss_fn (dB features, which
    # TuiNet's clamp zeroes: no conv gradient) and on positive features
    cfg32 = TuiNetConfig(num_classes=len(LABELS), dtype="float32")
    net = TuiNet.from_jax_params(carried, cfg32).to(dev).train()
    t0 = time.perf_counter()
    m["first_step_vs_cpu"] = grads_against_cpu(
        "TuiNet loss_fn", net,
        lambda n, order: train.loss_fn(n, windows[order.to(dev)].to(next(n.parameters()).device),
                                       labels[order.to(dev)].to(next(n.parameters()).device),
                                       SR, 640)[0], TRAIN_BATCH)
    x = torch.from_numpy(np.abs(np.random.RandomState(6).randn(16, 160, 226, 1))
                         .astype(np.float32) * 3.0).to(dev)
    y = labels[:16]

    def positive(n, order):
        d = next(n.parameters()).device
        logits = n(x[order.to(dev)].to(d))
        return -torch.log_softmax(logits, 1).gather(
            1, y[order.to(dev)].to(d).long()[:, None]).mean()

    m["positive_features_vs_cpu"] = grads_against_cpu("TuiNet positive features", net,
                                                      positive, 16)
    if m["positive_features_vs_cpu"]["zero_grad_params"]:
        raise AssertionError("a TuiNet parameter has no gradient on positive features")
    m["cpu_check_s"] = time.perf_counter() - t0

    for tag, dtype, fast in (("float32", "float32", False), ("bfloat16", "bfloat16", False),
                             ("bfloat16 fast", "bfloat16", True)):
        if fast:
            os.environ["AAT_FAST"] = "1"
        net = TuiNet.from_jax_params(carried, TuiNetConfig(num_classes=len(LABELS),
                                                           dtype=dtype)).to(dev)
        opt = train.make_optimizer(net, lr=1e-3)
        step = train.make_train_step(sr=SR, hop_length=640)
        losses = []

        def one_step():
            loss, _ = step(net, opt, windows, labels)
            losses.append(loss)

        m[tag] = timed_steps(one_step, TRAIN_BATCH)
        m[tag]["losses"] = [float(l) for l in losses[:3]]
        if not all(math.isfinite(l) for l in m[tag]["losses"]):
            raise AssertionError(f"TuiNet training {tag}: losses {m[tag]['losses']}")
        launches[f"train_tuinet_{'fast' if fast else 'exact'}"] = m[tag]["launches"]
        os.environ.pop("AAT_FAST", None)
        if tag == "float32":
            trained = net
    require_launches("TuiNet training step (exact)", launches["train_tuinet_exact"],
                     {"stft_mel": 1, "stft_mel.cluster": 0, "stft_mel_bf16": 0,
                      "stft_mag": 0, "row_medians": 0, "col_medians": 0})
    require_launches("TuiNet training step (fast)", launches["train_tuinet_fast"],
                     {"stft_mel_bf16": 1, "stft_mel_bf16.direct": 0, "stft_mel": 0,
                      "stft_mag": 0, "row_medians": 0, "col_medians": 0})

    # the trained checkpoint, served by the exact analyse CLI
    trained_dir = save_checkpoint(tmp / "trained-tuinet", trained.to_jax_params(),
                                  checkpoint_meta(LABELS, 160, 640, cfg32.channels))
    res, wall, launches["analyse_exact_trained_tuinet"] = run_cli(wav, trained_dir, "cuda")
    cpu_res, cpu_wall, _ = run_cli(wav, trained_dir, "cpu")
    m["trained_cli"] = {"wall_s": wall, "cpu_wall_s": cpu_wall,
                        "max_confidence_diff": compare_results(res, cpu_res, confidence_tol=1),
                        **summary_of(res)}
    require_launches("analyse with the trained TuiNet", launches["analyse_exact_trained_tuinet"],
                     {"stft_mel": 2, "stft_mag": 1, "row_medians": 1, "col_medians": 1,
                      "stft_mel_bf16": 0, "stft_mel.cluster": 0, "stft_mag.cluster": 0})

    # EfficientNetB0: a new 4-label head, fine-tuned in float32 at batch 32
    cfg = ModelConfig.load(effnet_dir)
    km = KerasModel.load(effnet_dir / "audioModel.keras")
    head = finetune.replace_head(km, len(FINETUNE_LABELS), seed=0)
    params, opt, step = finetune.build_finetune(km, dev, lr=1e-4)
    ft_windows, ft_labels = train_windows(pcm, FINETUNE_BATCH, seed=7)
    gen = torch.Generator(device=dev).manual_seed(0)
    losses = []

    def ft_step():
        with torch.no_grad():
            feats = features_for_config(ft_windows, SR, cfg).repeat_interleave(3, dim=-1)
        loss, _ = step(params, opt, feats, ft_labels, gen)
        losses.append(loss)

    m["finetune_efficientnet"] = timed_steps(ft_step, FINETUNE_BATCH)
    m["finetune_efficientnet"]["losses"] = [float(l) for l in losses[:3]]
    launches["finetune_efficientnet"] = m["finetune_efficientnet"]["launches"]
    require_launches("EfficientNetB0 fine-tune step", launches["finetune_efficientnet"],
                     {"stft_mel": 1, "stft_mel.cluster": 0, "stft_mel_bf16": 0, "stft_mag": 0,
                      "row_medians": 0, "col_medians": 0})
    if not all(math.isfinite(l) for l in m["finetune_efficientnet"]["losses"]):
        raise AssertionError(f"EfficientNetB0 fine-tune losses {losses}")

    # exported without h5py, reloaded by the port's reader, served
    tuned = tmp / "effnet-tuned"
    write_keras_archive(effnet_dir, params, tuned / "audioModel.keras", config=km.config)
    meta = {**cfg.raw, "labels": FINETUNE_LABELS}
    meta.pop("ebird_ids", None)
    meta.pop("bird_labels", None)
    (tuned / "metadata.txt").write_text(json.dumps(meta, indent=4, sort_keys=True))
    back = KerasModel.load(tuned / "audioModel.keras")
    if [a.shape for a in back.params[head]] != [tuple(p.shape) for p in params[head]]:
        raise AssertionError("the exported head reads back at another shape")
    for key, leaves in params.items():
        for i, t in enumerate(leaves):
            if not np.array_equal(back.params[key][i], t.detach().cpu().numpy()):
                raise AssertionError(f"exported {key}/{i} reads back different")
    res, wall, launches["analyse_exact_tuned_efficientnet"] = run_cli(wav, tuned, "cuda")
    cpu_res, cpu_wall, _ = run_cli(wav, tuned, "cpu")
    m["tuned_cli"] = {"wall_s": wall, "cpu_wall_s": cpu_wall,
                      "max_confidence_diff": compare_results(res, cpu_res, confidence_tol=1),
                      "labels": count_labels([res]), **summary_of(res)}
    require_launches("analyse with the tuned EfficientNetB0",
                     launches["analyse_exact_tuned_efficientnet"],
                     {"stft_mel": 2, "stft_mag": 1, "row_medians": 1, "col_medians": 1,
                      "stft_mel_bf16": 0, "stft_mel.cluster": 0, "stft_mag.cluster": 0})
    log(json.dumps({"training": m}))
    return m, launches


SCALEOUT_RANKS = 2  # two gloo ranks on the one card: a correctness check
SCALEOUT_NOTE = "two ranks sharing one card: not a scaling figure"
SCALEOUT_DEADLINE = 300  # s; a rank still running then fails the phase


def _scaleout_rank(wav, wavs, exact_model, fast_models, init_dir):
    """One rank of the scale-out phase (gloo, on the card beside the other
    rank): mesh serving of its half of `wavs` at the exact level with
    `exact_model` and under AAT_FAST=1 with `fast_models` (cold, then warm
    with the kernel counts reset around it and a StageTimer), then the
    full-width float32 TuiNet's first step at global batch 64 on linear
    mel power (the weights in `init_dir`, the windows ``train_windows``
    cuts from `wav`) on a data=2 and a model=2 mesh: its loss, its
    gradients (the head gathered whole), its running statistics' change
    and the step's ms."""
    import torch
    import torch.distributed as dist

    from audio_analysis_torch.io.audio import load_recording
    from audio_analysis_torch.io.checkpoint import load_checkpoint_params
    from audio_analysis_torch.models.birdnet import TuiNet, TuiNetConfig
    from audio_analysis_torch.parallel import train
    from audio_analysis_torch.parallel.mesh import data_index, make_mesh, rank_device
    from audio_analysis_torch.pipeline.serve import BatchAnalyzer
    from audio_analysis_torch.utils.runtime import StageTimer

    os.environ.pop("AAT_TIMINGS", None)
    rank, n = dist.get_rank(), dist.get_world_size()
    mesh = make_mesh()
    dev = rank_device(mesh)
    per = len(wavs) // n
    recs = [load_recording(w, prefer_int16=True)[0] for w in wavs[rank * per:(rank + 1) * per]]
    out = {"rank": rank, "device": str(dev)}
    for level, models in (("exact", [exact_model]), ("fast", fast_models)):
        if level == "fast":
            os.environ["AAT_FAST"] = "1"
        else:
            os.environ.pop("AAT_FAST", None)
        analyzer = BatchAnalyzer(models, sr=SR, rng=None, mesh=mesh)
        t0 = time.perf_counter()
        analyzer.analyse_recordings(recs)
        cold = time.perf_counter() - t0
        timer = StageTimer()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = analyzer.analyse_recordings(recs, timer=timer)
        torch.cuda.synchronize()
        out[level] = {"results": res, "cold_wall_s": cold, "warm_wall_s": time.perf_counter() - t0,
                      "gather_ms": 1e3 * timer.stages.get("gather", 0.0),
                      "timing": timer.as_dict(), "launches": read_counts()}
    os.environ.pop("AAT_FAST", None)

    pcm16, _ = load_recording(wav, prefer_int16=True)
    windows, labels = train_windows(pcm16.astype(np.float32) / 32768.0, TRAIN_BATCH, seed=5)
    carried = load_checkpoint_params(init_dir)
    cfg32 = TuiNetConfig(num_classes=len(LABELS), dtype="float32")
    with linear_power_features(train):
        for name, mp in (("data=2", 1), ("model=2", 2)):
            mesh = make_mesh(model_parallel=mp)
            net = train.shard_params(TuiNet.from_jax_params(carried, cfg32), mesh).to(dev)
            opt = train.make_optimizer(net, lr=1e-3)
            step = train.make_train_step(sr=SR, hop_length=640, mesh=mesh)
            b = TRAIN_BATCH // mesh.size(0)
            rows = slice(data_index(mesh) * b, (data_index(mesh) + 1) * b)
            before = bn_stats_of(net)
            loss, acc = step(net, opt, windows[rows], labels[rows])
            grads = train.gather_head({k: p.grad for k, p in net.named_parameters()}, mesh)
            moved = {k: v - before[k] for k, v in bn_stats_of(net).items()}
            ms = time_ms(lambda: step(net, opt, windows[rows], labels[rows]), TRAIN_STEPS)
            out[name] = {"loss": float(loss), "acc": float(acc), "grads": grads,
                         "bn_moved": moved, "step_ms": ms, "rows": b}
    return out


def linear_power_features(train):
    """Context: parallel/train.py's ``features`` on linear mel power
    (db_scale off) while it lasts. The trainer's dB features are all <= 0,
    and TuiNet clamps its input at 0 (ROADMAP Queue 3): on them every
    activation below the head is the same for any batch split, and the
    convolutions and BatchNorm get no gradient, so a check of the sharded
    step on them could not see BatchNorm's statistics."""
    import contextlib

    import torch

    from audio_analysis_torch.pipeline.frontend import spectrogram_grid

    def linear(pcm, n_mels, sr, hop_length, level=None):
        with torch.no_grad():
            return spectrogram_grid(pcm, sr=sr, hop_length=hop_length, n_fft=4096,
                                    n_mels=n_mels, mel_break=1750.0, htk=True, power=2.0,
                                    db_scale=False, normalize=True, level=level)

    @contextlib.contextmanager
    def swapped():
        saved, train.features = train.features, linear
        try:
            yield
        finally:
            train.features = saved

    return swapped()


def bn_stats_of(net):
    """{buffer name: numpy copy}: TuiNet's BatchNorm running statistics."""
    return {k: b.detach().cpu().numpy().copy() for k, b in net.named_buffers()}


def scaleout_train_reference(init_dir, wav):
    """The single-process first step on the card at batch 64 on linear mel
    power (``make_train_step``), the windows in their order and in a seeded
    permutation: (loss, {parameter: gradient}, {buffer: running statistic's
    change}, {leaf: relative L2 difference of the permuted batch's}). Fails
    when a parameter's gradient is all zero."""
    import torch

    from audio_analysis_torch.io.audio import load_recording
    from audio_analysis_torch.io.checkpoint import load_checkpoint_params
    from audio_analysis_torch.models.birdnet import TuiNet, TuiNetConfig
    from audio_analysis_torch.parallel import train

    pcm16, _ = load_recording(wav, prefer_int16=True)
    windows, labels = train_windows(pcm16.astype(np.float32) / 32768.0, TRAIN_BATCH, seed=5)
    cfg32 = TuiNetConfig(num_classes=len(LABELS), dtype="float32")
    runs = []
    with linear_power_features(train):
        for order in (np.arange(TRAIN_BATCH), np.random.RandomState(8).permutation(TRAIN_BATCH)):
            net = TuiNet.from_jax_params(load_checkpoint_params(init_dir), cfg32).cuda()
            opt = train.make_optimizer(net, lr=1e-3)
            order = torch.from_numpy(order).cuda()
            before = bn_stats_of(net)
            loss, _ = train.make_train_step(sr=SR, hop_length=640)(net, opt, windows[order],
                                                                   labels[order])
            runs.append((float(loss),
                         {k: p.grad.cpu().numpy() for k, p in net.named_parameters()},
                         {k: v - before[k] for k, v in bn_stats_of(net).items()}))
    (loss, grads, moved), (_, grads_p, moved_p) = runs
    zero = [k for k, g in grads.items() if not g.any()]
    if zero:
        raise AssertionError(f"the one-process step leaves {zero} without a gradient")
    noise = {k: rel_l2(b[k], a[k]) for a, b in ((grads, grads_p), (moved, moved_p)) for k in a}
    return loss, grads, moved, noise


def rel_l2(got, ref):
    """||got - ref|| / ||ref|| (over 1 where ref is all zero)."""
    return float(np.linalg.norm(got - ref) / (np.linalg.norm(ref) or 1.0))


def check_scaleout(tmp, wav, wavs, exact_model, fast_models, exact_path, fast_path):
    """The scale-out phase: (a) a world of one rank on NCCL, mesh serving of
    the 8 WAVs under AAT_FAST=1 against the meshless analyzer in this
    process, byte for byte; (b) two spawned gloo ranks on the card, each
    fed 4 of the 8 WAVs at the exact level and under AAT_FAST=1: the
    gathered list (on both ranks) equals this process's analyzer fed the
    same two 4-WAV batches, bit for bit, and one 8-WAV batch within the
    result contract (confidences within 1, 2 for the bf16 models), and
    every rank launched the path's kernels; (c) in the same ranks, the
    full-width TuiNet's first step at global batch 64 in float32 on a
    data=2 and a model=2 mesh against this process's step, on linear mel
    power: loss within TRAIN_LOSS_RTOL, each gradient and each BatchNorm
    running statistic's change within TRAIN_GRAD_TOL in relative L2 or 3x
    the permuted batch's difference. Returns the summary and each rank's
    launches by path."""
    import threading

    import torch

    from audio_analysis_torch.io.audio import load_recording
    from audio_analysis_torch.parallel import distributed
    from audio_analysis_torch.parallel.mesh import make_mesh
    from audio_analysis_torch.pipeline.serve import BatchAnalyzer

    t_phase = time.perf_counter()
    timings = os.environ.pop("AAT_TIMINGS", None)
    recs = [load_recording(w, prefer_int16=True)[0] for w in wavs]
    summary = {"card": card_line(), "note": SCALEOUT_NOTE}

    # (a) NCCL, a world of one rank
    os.environ["AAT_FAST"] = "1"
    distributed.initialize(backend="nccl")
    try:
        mesh = make_mesh()
        meshless = BatchAnalyzer(fast_models, sr=SR, rng=None, device="cuda")
        meshed = BatchAnalyzer(fast_models, sr=SR, rng=None, mesh=mesh)
        ref = meshless.analyse_recordings(recs)
        t0 = time.perf_counter()
        got = meshed.analyse_recordings(recs)
        torch.cuda.synchronize()
        summary["nccl_world_of_1"] = {"wall_s": time.perf_counter() - t0,
                                      "equal": json.dumps(got) == json.dumps(ref)}
    finally:
        distributed.shutdown()
    log(json.dumps({"scaleout": "nccl world of 1", **summary["nccl_world_of_1"]}))
    if not summary["nccl_world_of_1"]["equal"]:
        raise AssertionError("the NCCL world of one differs from the meshless analyzer")
    os.environ.pop("AAT_FAST")

    # (b), (c): two gloo ranks on the card, while this process computes the
    # single-process results
    init_dir = write_tuinet_model(tmp / "train-init", seed=5)
    box = {}

    def run_ranks():
        try:
            box["ranks"] = distributed.spawn(
                _scaleout_rank, SCALEOUT_RANKS,
                args=(str(wav), [str(w) for w in wavs], str(exact_model),
                      [str(m) for m in fast_models], str(init_dir)),
                backend="gloo", deadline=SCALEOUT_DEADLINE)
        except Exception as e:  # noqa: BLE001  (raised below, in this thread)
            box["error"] = e

    t0 = time.perf_counter()
    ranks_thread = threading.Thread(target=run_ranks, daemon=True)
    ranks_thread.start()
    single = {}
    for level, models in (("exact", [exact_model]), ("fast", fast_models)):
        if level == "fast":
            os.environ["AAT_FAST"] = "1"
        a = BatchAnalyzer(models, sr=SR, rng=None, device="cuda")
        half = len(recs) // SCALEOUT_RANKS
        single[level] = {"halves": a.analyse_recordings(recs[:half])
                         + a.analyse_recordings(recs[half:]),
                         "whole": a.analyse_recordings(recs)}
        os.environ.pop("AAT_FAST", None)
    train_ref = scaleout_train_reference(init_dir, wav)
    ranks_thread.join(SCALEOUT_DEADLINE + 60)
    if ranks_thread.is_alive():
        raise AssertionError("the scale-out ranks outlived their deadline")
    if "error" in box:
        raise box["error"]
    ranks = box["ranks"]
    summary["ranks_wall_s"] = time.perf_counter() - t0

    launches = {}
    for level, tol, expect in (("exact", 1, exact_path), ("fast", 2, fast_path)):
        for r in ranks:
            m = r[level]
            got = m["results"]
            if json.dumps(got) != json.dumps(single[level]["halves"]):
                raise AssertionError(f"rank {r['rank']} {level}: the gathered list differs "
                                     "from the same two batches in one process")
            worst = max(compare_results(g, w, confidence_tol=tol)
                        for g, w in zip(got, single[level]["whole"]))
            require_launches(f"scale-out rank {r['rank']} {level}", m["launches"], expect)
            launches[f"scaleout_{level}_rank{r['rank']}"] = m["launches"]
            row = {"rank": r["rank"], "device": r["device"], "level": level,
                   "recordings_fed": len(recs) // SCALEOUT_RANKS, "gathered": len(got),
                   "cold_wall_s": m["cold_wall_s"], "warm_wall_s": m["warm_wall_s"],
                   "gather_ms": m["gather_ms"], "timing": m["timing"],
                   "max_confidence_diff_vs_one_batch": worst, "card": summary["card"],
                   "note": SCALEOUT_NOTE}
            summary.setdefault(level, []).append(row)
            log(json.dumps({"scaleout_serving": row, "launches": m["launches"]}))

    loss1, grads1, moved1, noise = train_ref
    for mesh_name in ("data=2", "model=2"):
        for r in ranks:
            m = r[mesh_name]
            rel_loss = abs(m["loss"] - loss1) / abs(loss1)
            if rel_loss > TRAIN_LOSS_RTOL:
                raise AssertionError(f"scale-out {mesh_name} rank {r['rank']}: loss "
                                     f"{m['loss']} vs one process {loss1}")
            # the worst rel / tol over the head's gradients, the other
            # gradients (convolutions, BatchNorm, mag_a) and the running
            # statistics' change
            worst = {"head": 0.0, "body": 0.0, "bn_stats": 0.0}
            for what, got, ref in (("gradient", m["grads"], grads1),
                                   ("running statistic", m["bn_moved"], moved1)):
                for k, g in ref.items():
                    rel = rel_l2(got[k], g)
                    tol = max(TRAIN_GRAD_TOL, 3 * noise[k])
                    if got[k].shape != g.shape or rel > tol:
                        raise AssertionError(f"scale-out {mesh_name} rank {r['rank']}: {what} "
                                             f"{k} {rel:.3g} in relative L2 (tolerance "
                                             f"{tol:.3g})")
                    kind = ("bn_stats" if what != "gradient"
                            else "head" if k.startswith("head_") else "body")
                    worst[kind] = max(worst[kind], rel / tol)
            row = {"mesh": mesh_name, "rank": r["rank"], "rows": m["rows"],
                   "global_batch": TRAIN_BATCH, "loss": m["loss"], "loss_one_process": loss1,
                   "loss_rel": rel_loss,
                   **{f"worst_{k}_over_tol": v for k, v in worst.items()},
                   "step_ms": m["step_ms"], "card": summary["card"], "note": SCALEOUT_NOTE}
            summary.setdefault("train", []).append(row)
            log(json.dumps({"scaleout_train": row}))
    summary["phase_s"] = time.perf_counter() - t_phase
    if timings is not None:
        os.environ["AAT_TIMINGS"] = timings
    return summary, launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    # what this machine has; the port reads .keras with neither
    log("importable: " + ", ".join(
        f"{m} {'yes' if importlib.util.find_spec(m) else 'no'}" for m in ("h5py", "tensorflow")))
    from audio_analysis_torch.io.audio import write_wav
    from audio_analysis_torch.ops import cuda as kcuda

    log(f"card: {card_line()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    kcuda.library()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"({kcuda.build_dir().relative_to(REPO)})")
    for line in kcuda.build_log().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log("  " + line.strip())

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        wav = tmp / "rec60.wav"
        write_wav(wav, make_recording(), SR)
        model_dir = write_tuinet_model(tmp / "tuinet")
        from audio_analysis_torch.io.audio import load_recording

        pcm16, _ = load_recording(wav, prefer_int16=True)
        pcm = pcm16.astype(np.float32) / 32768.0
        log(f"fixtures written in {tmp}: {SECONDS} s WAV, full-width TuiNet")

        t0 = time.perf_counter()
        kernels = check_kernels(pcm)
        kernels.update(check_bf16(pcm))
        log(f"kernel checks done in {time.perf_counter() - t0:.1f} s")

        # the exact level's single-recording path
        os.environ["AAT_TIMINGS"] = "1"
        for knob in ("AAT_FAST", "AAT_PALLAS"):
            os.environ.pop(knob, None)
        exact_path = {"stft_mel": 2, "stft_mag": 1, "row_medians": 1, "col_medians": 1,
                      "stft_mel.fft": 2, "stft_mag.fft": 1, "stft_mel_bf16": 0,
                      "stft_mel_bf16.direct": 0, **OFF_MAIN_ROUTES}
        runs, exact_captured = {}, {}
        for tag in ("cold", "warm"):
            with capture_inputs(exact_captured) if tag == "cold" else contextlib.nullcontext():
                res, wall, launches = run_cli(wav, model_dir, "cuda")
            runs[tag] = (res, launches)
            log(json.dumps({"cli_run": tag, "device": "cuda", "wall_s": wall,
                            "launches": launches, **summary_of(res)}))
            require_launches(f"{tag} run", launches, exact_path)
        gpu_res, launches = runs["cold"]
        if runs["warm"][0]["species_identify"] != gpu_res["species_identify"]:
            raise AssertionError("warm run differs from the cold run")
        if gpu_res["duration"] != SECONDS or not gpu_res["chirps"]["signals"]:
            raise AssertionError(f"unexpected result: {summary_of(gpu_res)}")

        log(json.dumps({"profile": "warm", "device": "cuda",
                        **profile_device(lambda: run_cli(wav, model_dir, "cuda"))}))
        _, spec_1, kw_1 = exact_captured["batch medians"]  # the exact path's [1, 2049, T]
        morphology = {"analyse_exact": check_packed_morphology("analyse_exact", spec_1,
                                                               kw_1["nvf"])}
        del exact_captured, spec_1, kw_1

        t0 = time.perf_counter()
        check_golden("cuda")
        log(f"golden snapshot reproduced on the card ({time.perf_counter() - t0:.1f} s)")

        cpu_res, wall, cpu_launches = run_cli(wav, model_dir, "cpu")
        log(json.dumps({"cli_run": "cpu", "device": "cpu", "wall_s": wall,
                        "launches": cpu_launches, **summary_of(cpu_res)}))
        if any(cpu_launches.values()):
            raise AssertionError(f"the CPU run launched kernels: {cpu_launches}")
        compare_results(gpu_res, cpu_res)
        log("card result equals the CPU result")

        # a full-width TuiNet whose metadata sets n_fft 8192: its classify
        # frontend runs stft_mel on the one-buffer FFT (fft1); warm against
        # the CPU
        t0 = time.perf_counter()
        nfft_dir = write_tuinet_model(tmp / "tuinet-nfft8192", name="tuinet-nfft8192", n_fft=8192)
        nfft_path = dict(exact_path, **{"stft_mel.fft": 1, "stft_mel.fft1": 1})
        for tag in ("cold", "warm"):
            res8k, wall, nfft_launches = run_cli(wav, nfft_dir, "cuda")
            log(json.dumps({"cli_run": f"n_fft 8192 {tag}", "device": "cuda", "wall_s": wall,
                            "launches": nfft_launches, "labels": count_labels([res8k]),
                            **summary_of(res8k)}))
            require_launches(f"n_fft 8192 {tag} run", nfft_launches, nfft_path)
        cpu8k, wall, _ = run_cli(wav, nfft_dir, "cpu")
        worst = compare_results(res8k, cpu8k, confidence_tol=1)
        log(json.dumps({"cli_run": "n_fft 8192 cpu", "device": "cpu", "wall_s": wall,
                        "max_confidence_diff": worst, "phase_s": time.perf_counter() - t0}))
        if not res8k["species_identify"]:
            raise AssertionError("the n_fft 8192 TuiNet classified no track")

        # a full-width TuiNet whose metadata sets n_fft 16384 (a 341 ms
        # window): its classify frontend runs stft_mel on the cluster route
        # (two blocks of 8192 points); warm against the CPU
        t0 = time.perf_counter()
        n16_dir = write_tuinet_model(tmp / "tuinet-nfft16384", name="tuinet-nfft16384",
                                     n_fft=16384)
        n16_path = dict(exact_path, **{"stft_mel.fft": 1, "stft_mel.cluster": 1})
        n16_walls = {}
        for tag in ("cold", "warm"):
            res16k, n16_walls[tag], nfft16k_launches = run_cli(wav, n16_dir, "cuda")
            log(json.dumps({"cli_run": f"n_fft 16384 {tag}", "device": "cuda",
                            "wall_s": n16_walls[tag], "launches": nfft16k_launches,
                            "labels": count_labels([res16k]), **summary_of(res16k)}))
            require_launches(f"n_fft 16384 {tag} run", nfft16k_launches, n16_path)
        cpu16k, wall, _ = run_cli(wav, n16_dir, "cpu")
        worst = compare_results(res16k, cpu16k, confidence_tol=1)
        log(json.dumps({"cli_run": "n_fft 16384 cpu", "device": "cpu", "wall_s": wall,
                        "max_confidence_diff": worst, "phase_s": time.perf_counter() - t0}))
        if not res16k["species_identify"]:
            raise AssertionError("the n_fft 16384 TuiNet classified no track")
        nfft16k_profile = profile_device(lambda: run_cli(wav, n16_dir, "cuda"))
        log(json.dumps({"profile": "n_fft 16384 warm", "device": "cuda", **nfft16k_profile}))

        # recordings at other rates: the resampler, then the exact analyse
        # of the 44.1 kHz WAV (cold, warm, CPU)
        t0 = time.perf_counter()
        rate_wavs = check_resample(tmp)
        runs44 = {}
        for tag in ("cold", "warm"):
            res, wall, launches44 = run_cli(rate_wavs[44100], model_dir, "cuda")
            runs44[tag] = res
            log(json.dumps({"cli_run": f"44.1 kHz {tag}", "device": "cuda", "wall_s": wall,
                            "launches": launches44, **summary_of(res)}))
            require_launches(f"44.1 kHz {tag} run", launches44, exact_path)
        if runs44["warm"]["species_identify"] != runs44["cold"]["species_identify"]:
            raise AssertionError("the warm 44.1 kHz run differs from the cold run")
        if runs44["cold"]["duration"] != SECONDS or not runs44["cold"]["chirps"]["signals"]:
            raise AssertionError(f"unexpected 44.1 kHz result: {summary_of(runs44['cold'])}")
        cpu44, wall, _ = run_cli(rate_wavs[44100], model_dir, "cpu")
        worst = compare_results(runs44["cold"], cpu44, confidence_tol=1)
        log(json.dumps({"cli_run": "44.1 kHz cpu", "device": "cpu", "wall_s": wall,
                        "max_confidence_diff": worst, "phase_s": time.perf_counter() - t0}))

        # band-pass models (every track of the fixture ends below 9 kHz)
        bp_launches = None
        for kind, meta in (("filter_below", dict(filter_below=9000)),
                           ("filter_freq", dict(filter_freq=True))):
            bp_dir = write_tuinet_model(tmp / f"bandpass-{kind}", name=f"bandpass-{kind}",
                                        threshold=BANDPASS_THRESHOLD, **meta)
            stacks = []
            with capture_sosfilt(stacks):
                res, wall, bl = run_cli(wav, bp_dir, "cuda")
            require_launches(f"band-pass {kind} run", bl, exact_path)
            bp_launches = bp_launches or bl
            cpu_bp, cpu_wall, _ = run_cli(wav, bp_dir, "cpu")
            worst = compare_results(res, cpu_bp, confidence_tol=1)
            labels = count_labels([res])
            log(json.dumps({"cli_run": f"band-pass {kind}", "device": "cuda", "wall_s": wall,
                            "cpu_wall_s": cpu_wall, "tracks": len(res["species_identify"]),
                            "labels": labels, "max_confidence_diff": worst, "launches": bl,
                            **(sosfilt_timing(stacks) if stacks else {})}))
            if not stacks or not labels:
                raise AssertionError(f"band-pass {kind}: {len(stacks)} filter calls, "
                                     f"{labels} labels")

        # the fast level's batch path: 8 x 60 s, AAT_FAST=1
        from audio_analysis_torch.utils.runtime import StageTimer

        t0 = time.perf_counter()
        wavs = []
        for i in range(BACKLOG):
            wavs.append(tmp / f"batch{i}.wav")
            silent_from = BATCH_SILENT_FROM[i % len(BATCH_SILENT_FROM)]
            write_wav(wavs[-1], make_recording(silent_from=silent_from, seed=i), SR)
        backlog, wavs = wavs, wavs[:8]
        models = [write_tuinet_model(tmp / "bird-model", seed=0, net_dtype=None,
                                     name="bird-model"),
                  write_tuinet_model(tmp / "pre-model", seed=2, labels=PRE_LABELS,
                                     net_dtype=None, pre_model=True, name="pre-model")]
        log(f"batch fixtures written in {time.perf_counter() - t0:.1f} s: "
            f"{len(backlog)} x {SECONDS} s WAVs, bird and pre TuiNets (bfloat16)")
        os.environ["AAT_FAST"] = "1"
        fast_path = {"stft_mel_bf16": 2, "stft_mag": 1, "row_medians": 1, "col_medians": 1,
                     "stft_mag.fft": 1, "stft_mel": 0, "stft_mel_bf16.direct": 0,
                     **OFF_MAIN_ROUTES}
        batch_runs, captured = {}, {}
        for tag in ("cold", "warm"):
            timer = StageTimer()
            with capture_inputs(captured) if tag == "cold" else contextlib.nullcontext():
                res, wall, batch_launches = run_batch_cli(wavs, models, "cuda", timer)
            batch_runs[tag] = res
            log(json.dumps({"batch_run": tag, "device": "cuda", "recordings": len(res),
                            "wall_s": wall, "audio_s_per_s": len(res) * SECONDS / wall,
                            "launches": batch_launches, "timing": timer.as_dict(),
                            "results": [summary_of(r["analysis"]) for r in res]}))
            require_launches(f"batch {tag} run", batch_launches, fast_path)
        if without_times(batch_runs["warm"]) != without_times(batch_runs["cold"]):
            raise AssertionError("the warm batch differs from the cold batch")
        durations = [r["analysis"]["duration"] for r in batch_runs["cold"]]
        if len(durations) != len(wavs) or any(d != SECONDS for d in durations):
            raise AssertionError(f"unexpected batch durations: {durations}")
        if not all(r["analysis"]["chirps"]["signals"] for r in batch_runs["cold"]):
            raise AssertionError("a batch recording has no signals")
        if sorted(captured) != ["batch", "batch classify", "batch end-scan", "batch medians"]:
            raise AssertionError(f"kernel inputs captured: {sorted(captured)}")
        for tag, (kernel, x, kw) in sorted(captured.items()):
            name = f"{kernel}[{tag}]"
            if kernel == "stft_mag":  # [8, 2.88M], each recording's own silent tail
                kernels[name] = mag_entry(name, x, kw["n_fft"], kw["hop_length"], iters=3)
            elif kernel == "row_medians":  # [8, 2049, T], each recording's valid frames
                kernels[name] = row_medians_entry(name, x, kw["nvf"])
                col = f"col_medians[{tag}]"  # the same input, over all rows
                kernels[col] = col_medians_entry(col, x)
            else:
                kernels[name] = bf16_entry(name, x, kw, compare=True)
        _, spec_b, kw_b = captured["batch medians"]
        morphology["batch_fast"] = check_packed_morphology("batch_fast", spec_b, kw_b["nvf"])
        del captured, spec_b, kw_b
        detection = detection_profile(wavs)

        # a backlog of three batches through the pipelined stream
        timer = StageTimer()
        res, wall, backlog_launches = run_batch_cli(backlog, models, "cuda", timer)
        log(json.dumps({"batch_run": "backlog", "device": "cuda", "recordings": len(res),
                        "batches": -(-len(res) // 8), "wall_s": wall,
                        "audio_s_per_s": len(res) * SECONDS / wall,
                        "launches": backlog_launches, "timing": timer.as_dict()}))
        require_launches("backlog run", backlog_launches,
                         {k: 3 * least for k, least in fast_path.items()})
        if without_times(res[:8]) != without_times(batch_runs["warm"]):
            raise AssertionError("the backlog's first batch differs from the warm batch")
        log(json.dumps({"profile": "batch warm", "device": "cuda",
                        **profile_device(lambda: run_batch_cli(wavs, models, "cuda"))}))

        cpu_batch, wall, cpu_launches = run_batch_cli(wavs[:4], models, "cpu")
        log(json.dumps({"batch_run": "cpu", "device": "cpu", "recordings": len(cpu_batch),
                        "wall_s": wall, "launches": cpu_launches}))
        if any(cpu_launches.values()):
            raise AssertionError(f"the CPU batch launched kernels: {cpu_launches}")
        worst = 0
        for g, c in zip(batch_runs["cold"], cpu_batch):
            worst = max(worst, compare_results(g["analysis"], c["analysis"], confidence_tol=2))
        log(json.dumps({"fast_card_vs_cpu": len(cpu_batch), "max_confidence_diff": worst}))

        # the fast batch with a band-pass bird model and the pre-model
        bp_models = [write_tuinet_model(tmp / "bandpass-bird", seed=0, net_dtype=None,
                                        name="bandpass-bird", filter_below=9000,
                                        threshold=BANDPASS_FAST_THRESHOLD), models[1]]
        bp_batch = {}
        for tag in ("cold", "warm"):
            timer, stacks = StageTimer(), []
            with capture_sosfilt(stacks):
                res, wall, bp_batch_launches = run_batch_cli(wavs, bp_models, "cuda", timer)
            bp_batch[tag] = res
            log(json.dumps({"batch_run": f"band-pass {tag}", "device": "cuda",
                            "recordings": len(res), "wall_s": wall,
                            "audio_s_per_s": len(res) * SECONDS / wall,
                            "launches": bp_batch_launches, "timing": timer.as_dict(),
                            "labels": count_labels([r["analysis"] for r in res]),
                            **(sosfilt_timing(stacks) if stacks else {})}))
            require_launches(f"band-pass batch {tag} run", bp_batch_launches, fast_path)
            if not stacks:
                raise AssertionError("the band-pass batch filtered no track")
        if without_times(bp_batch["warm"]) != without_times(bp_batch["cold"]):
            raise AssertionError("the warm band-pass batch differs from the cold batch")
        cpu_bp, wall, _ = run_batch_cli(wavs[:2], bp_models, "cpu")
        worst = 0
        for g, c in zip(bp_batch["cold"], cpu_bp):
            worst = max(worst, compare_results(g["analysis"], c["analysis"], confidence_tol=2))
        log(json.dumps({"bandpass_fast_card_vs_cpu": len(cpu_bp), "cpu_wall_s": wall,
                        "max_confidence_diff": worst}))
        if not count_labels([r["analysis"] for r in bp_batch["cold"]]):
            raise AssertionError("the band-pass batch labels no track")

        # a bird TuiNet whose metadata sets n_fft 4410 (not a multiple of 8):
        # its classify frontend takes stft_mel_bf16's direct route, the
        # end-scan the dif route
        t0 = time.perf_counter()
        nfft_models = [write_tuinet_model(tmp / "bird-nfft4410", seed=0, net_dtype=None,
                                          name="bird-nfft4410", n_fft=4410)]
        nfft_fast_path = dict(fast_path, **{"stft_mel_bf16.direct": 1, "stft_mel_bf16.dif": 1})
        nfft_batch, nfft_captured = {}, {}
        for tag in ("cold", "warm"):
            timer = StageTimer()
            with capture_inputs(nfft_captured) if tag == "cold" else contextlib.nullcontext():
                res, wall, nfft_batch_launches = run_batch_cli(wavs, nfft_models, "cuda", timer)
            nfft_batch[tag] = res
            log(json.dumps({"batch_run": f"n_fft 4410 {tag}", "device": "cuda",
                            "recordings": len(res), "wall_s": wall,
                            "audio_s_per_s": len(res) * SECONDS / wall,
                            "launches": nfft_batch_launches, "timing": timer.as_dict(),
                            "labels": count_labels([r["analysis"] for r in res])}))
            require_launches(f"n_fft 4410 batch {tag} run", nfft_batch_launches, nfft_fast_path)
        if without_times(nfft_batch["warm"]) != without_times(nfft_batch["cold"]):
            raise AssertionError("the warm n_fft 4410 batch differs from the cold batch")
        if not all(r["analysis"]["species_identify"] for r in nfft_batch["cold"][:2]):
            raise AssertionError("the n_fft 4410 batch classified no track in a recording")
        cpu_nfft, wall, _ = run_batch_cli(wavs[:2], nfft_models, "cpu")
        worst = 0
        for g, c in zip(nfft_batch["cold"], cpu_nfft):
            worst = max(worst, compare_results(g["analysis"], c["analysis"], confidence_tol=2))
        log(json.dumps({"nfft4410_fast_card_vs_cpu": len(cpu_nfft), "cpu_wall_s": wall,
                        "max_confidence_diff": worst, "phase_s": time.perf_counter() - t0}))
        _, x, kw = nfft_captured["batch classify"]
        if kw["n_fft"] != 4410:
            raise AssertionError(f"the n_fft 4410 batch's classify grid came with {kw}")
        name = "stft_mel_bf16[batch classify, n_fft 4410]"
        kernels[name] = bf16_entry(name, x, kw)
        del nfft_captured, x
        os.environ.pop("AAT_FAST")

        # the upload path: the wire codec, the stream against one worker,
        # conversion without tensorflow, a trace of the exact CLI
        upload, upload_launches = check_upload(tmp, wav, model_dir, wavs, backlog, models,
                                               exact_path, fast_path)
        log(f"upload phase {upload['phase_s']:.1f} s")

        # EfficientNetB0 (the reference's flagship classifier), read from
        # .keras by the port's HDF5 reader: alone, then through the exact
        # analyse CLI and the fast batch
        t0 = time.perf_counter()
        effnet = efficientnet_fixture(tmp / "effnet", seed=0)
        effnet_fast = tmp / "effnet-fast"
        shutil.copytree(effnet, effnet_fast)
        meta = json.loads((effnet_fast / "metadata.txt").read_text())
        (effnet_fast / "metadata.txt").write_text(json.dumps(
            {**meta, "threshold": EFFNET_FAST_THRESHOLD}, indent=4, sort_keys=True))
        log(f"EfficientNetB0 fixture written in {time.perf_counter() - t0:.1f} s")
        effnet_model = check_efficientnet(effnet, effnet_grid(pcm))

        eff_runs = {}
        for tag in ("cold", "warm"):
            res, wall, eff_launches = run_cli(wav, effnet, "cuda")
            eff_runs[tag] = res
            log(json.dumps({"cli_run": f"efficientnet {tag}", "device": "cuda", "wall_s": wall,
                            "launches": eff_launches, "labels": count_labels([res]),
                            **summary_of(res)}))
            require_launches(f"efficientnet {tag} run", eff_launches, exact_path)
        if eff_runs["warm"]["species_identify"] != eff_runs["cold"]["species_identify"]:
            raise AssertionError("the warm EfficientNet run differs from the cold run")
        cpu_res, wall, cpu_launches = run_cli(wav, effnet, "cpu")
        log(json.dumps({"cli_run": "efficientnet cpu", "device": "cpu", "wall_s": wall,
                        "labels": count_labels([cpu_res]), **summary_of(cpu_res)}))
        if any(cpu_launches.values()):
            raise AssertionError(f"the CPU run launched kernels: {cpu_launches}")
        if not count_labels([cpu_res]):
            raise AssertionError("the EfficientNet CLI run on the CPU labels no track")
        worst = compare_results(eff_runs["cold"], cpu_res, confidence_tol=1)
        log(json.dumps({"efficientnet_cli_card_vs_cpu": True, "max_confidence_diff": worst}))

        from audio_analysis_torch.io.modelconfig import ModelConfig
        from audio_analysis_torch.models.registry import _resolved_compute_dtype

        os.environ["AAT_FAST"] = "1"
        if _resolved_compute_dtype(ModelConfig.load(effnet_fast)) != "bfloat16":
            raise AssertionError("AAT_FAST does not resolve the Keras model to bfloat16")
        eff_batch = {}
        for tag in ("cold", "warm"):
            timer = StageTimer()
            res, wall, eff_batch_launches = run_batch_cli(wavs, [effnet_fast], "cuda", timer)
            eff_batch[tag] = res
            log(json.dumps({"batch_run": f"efficientnet {tag}", "device": "cuda",
                            "recordings": len(res), "wall_s": wall,
                            "audio_s_per_s": len(res) * SECONDS / wall,
                            "launches": eff_batch_launches, "timing": timer.as_dict(),
                            "labels": count_labels([r["analysis"] for r in res])}))
            require_launches(f"efficientnet batch {tag} run", eff_batch_launches, fast_path)
        if without_times(eff_batch["warm"]) != without_times(eff_batch["cold"]):
            raise AssertionError("the warm EfficientNet batch differs from the cold batch")
        eff_prof = profile_device(lambda: run_batch_cli(wavs, [effnet_fast], "cuda"))
        log(json.dumps({"profile": "efficientnet batch warm", "device": "cuda", **eff_prof}))
        if eff_prof["max_pool_kernels"]:  # EfficientNetB0 has no max-pool; detection none
            raise AssertionError(f"the EfficientNet batch launched "
                                 f"{eff_prof['max_pool_kernels']} max-pool kernels")
        cpu_batch, wall, cpu_launches = run_batch_cli(wavs[:2], [effnet_fast], "cpu")
        log(json.dumps({"batch_run": "efficientnet cpu", "device": "cpu",
                        "recordings": len(cpu_batch), "wall_s": wall,
                        "labels": count_labels([r["analysis"] for r in cpu_batch])}))
        if any(cpu_launches.values()):
            raise AssertionError(f"the CPU batch launched kernels: {cpu_launches}")
        if not count_labels([r["analysis"] for r in cpu_batch]):
            raise AssertionError("the EfficientNet batch on the CPU labels no track")
        worst = 0
        for g, c in zip(eff_batch["cold"], cpu_batch):
            worst = max(worst, compare_results(g["analysis"], c["analysis"], confidence_tol=2))
        log(json.dumps({"efficientnet_fast_card_vs_cpu": len(cpu_batch),
                        "max_confidence_diff": worst}))
        os.environ.pop("AAT_FAST")

        # the legacy cacophony index at 48 and at 44.1 kHz (resampled to 16 kHz)
        for rate, w in ((SR, wav), (44100, rate_wavs[44100])):
            t0 = time.perf_counter()
            card = run_old_index(w, "cuda")
            card_s = time.perf_counter() - t0
            cpu = run_old_index(w, "cpu")
            log(json.dumps({"old_index": rate, "wall_s": card_s, "entries":
                            card["cacophony_index_old"], "card_equals_cpu": card == cpu}))
            if card != cpu or not card["cacophony_index_old"]:
                raise AssertionError(f"old index at {rate} Hz: card {card} vs CPU {cpu}")

        # the side paths: the morepork detector, embeddings groups, mfcc
        side = {"morepork": check_morepork(tmp, {SR: wav, 44100: rate_wavs[44100]}),
                "embeddings": check_embeddings(tmp, wav, wavs, models[1], exact_path,
                                               fast_path),
                "mfcc": check_mfcc(tmp, wav, wavs, pcm, exact_path, fast_path)}
        side_launches = {"analyse_morepork": side["morepork"]["launches"],
                         **side["embeddings"]["launches"], **side["mfcc"]["launches"],
                         **upload_launches}

        # training: TuiNet from seeded weights, EfficientNetB0 fine-tuned,
        # each served by the exact CLI
        t0 = time.perf_counter()
        training, train_launches = check_training(tmp, wav, pcm, effnet)
        side_launches.update(train_launches)
        log(f"training phase {time.perf_counter() - t0:.1f} s")

        # scale-out: mesh serving and sharded training over torch.distributed
        scaleout, scaleout_launches = check_scaleout(tmp, wav, wavs, model_dir, models,
                                                     exact_path, fast_path)
        side_launches.update(scaleout_launches)
        log(f"scale-out phase {scaleout['phase_s']:.1f} s")

    out = []
    for name, m in kernels.items():
        base = name.split("[")[0]
        # a DFT row counts its route's launches, <base>.<route>
        route = m.get("dft_route")
        key = f"{base}.{route}" if route in ROUTES.get(base, ()) else base
        # each kernel's count on this slice's path where it runs there,
        # else on the single-recording path; the float64 one-buffer routes'
        # on the n_fft 8192 CLI, the cluster route's on the n_fft 16384 CLI,
        # the bf16 direct route's on the n_fft 4410 fast batch
        if base == "stft_mel_bf16" and route == "direct":
            n = nfft_batch_launches[key]
        elif route == "cluster":
            n = nfft16k_launches[key]
        elif route in ("fft1", "bluestein"):
            n = nfft_launches[key]
        else:
            n = batch_launches[key] if fast_path[base] else launches[key]
        out.append({k: m.get(k) for k in (
            "name", "route", "source", "replaces")} | {"launches": n} | {
            "launches_by_path": {"analyse_exact": launches[key],
                                 "analyse_exact_nfft8192": nfft_launches[key],
                                 "analyse_exact_nfft16384": nfft16k_launches[key],
                                 "batch_fast": batch_launches[key],
                                 "backlog_fast": backlog_launches[key],
                                 "analyse_exact_efficientnet": eff_launches[key],
                                 "batch_fast_efficientnet": eff_batch_launches[key],
                                 "analyse_exact_44k1": launches44[key],
                                 "analyse_exact_bandpass": bp_launches[key],
                                 "batch_fast_bandpass": bp_batch_launches[key],
                                 "batch_fast_nfft4410": nfft_batch_launches[key],
                                 **{path: n[key] for path, n in side_launches.items()}}} | {
            k: m.get(k) for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms", "max_rel", "shape")})
        if "library_equal" in m:  # the medians: the library call bit for bit?
            out[-1]["library_equal"] = m["library_equal"]
        if base in ROUTES:  # the DFTs: which route (the bf16 direct route's main-path count)
            out[-1] |= {"dft_route": m["dft_route"], "library_ms_f64": m.get("library_ms_f64")}
            if base == "stft_mel_bf16":
                out[-1]["direct_launches"] = batch_launches["stft_mel_bf16.direct"]
            out[-1] |= {k: m[k] for k in ("direct_ms", "direct_plain_ms", "direct_max_rel",
                                          "stft_mel_ms", "max_rel_f64", "direct_max_rel_f64",
                                          "vs_classify_4096", "cluster", "levels") if k in m}
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"efficientnet_b0": {k: effnet_model[k] for k in (
        "f32_card_vs_cpu_max_abs", "bf16_vs_f32_max_abs", "bf16_vs_f32_mean_abs")} | {
        k: {q: effnet_model[k][q] for q in ("ms", "windows_per_s", "host_share", "idle_share")}
        for k in ("float32", "bfloat16")}}))
    log(json.dumps({"packed_morphology": {path: {k: m[k] for k in (
        "shape", "ms", "plain_ms", "host_enqueue_ms", "device_kernels")}
        for path, m in morphology.items()},
        "detection_max_pool_kernels": detection["max_pool_kernels"]}))
    log(json.dumps({"side_paths": {
        "morepork": {k: side["morepork"][k] for k in ("stft_ms", "samples_ms", "member_ms")} | {
            k: side["morepork"]["profile"][k] for k in ("device_busy_ms", "idle_share",
                                                        "device_kernels")},
        "embeddings": {k: side["embeddings"]["exact"][k] for k in (
            "windows", "resample_ms", "gather_ms", "embedder_ms")},
        "mfcc_frontend_ms": side["mfcc"]["frontend_ms"]}}))
    log(json.dumps({"training_summary": {
        k: {q: training[k][q] for q in ("ms", "windows_per_s", "peak_mem_bytes",
                                        "device_busy_ms", "idle_share", "launches")}
        for k in ("float32", "bfloat16", "bfloat16 fast", "finetune_efficientnet")} | {
        "first_step_vs_cpu": training["first_step_vs_cpu"],
        "positive_features_vs_cpu": training["positive_features_vs_cpu"],
        "trained_cli": training["trained_cli"]["max_confidence_diff"],
        "tuned_cli": training["tuned_cli"]["max_confidence_diff"],
        "card": training["card"]}}))
    log(json.dumps({"scaleout_summary": {
        "card": scaleout["card"], "note": scaleout["note"],
        "nccl_world_of_1": scaleout["nccl_world_of_1"], "ranks_wall_s": scaleout["ranks_wall_s"],
        "phase_s": scaleout["phase_s"]} | {
        level: [{k: r[k] for k in ("rank", "warm_wall_s", "gather_ms",
                                   "max_confidence_diff_vs_one_batch")} for r in scaleout[level]]
        for level in ("exact", "fast")} | {
        "train": [{k: r[k] for k in ("mesh", "rank", "loss_rel", "worst_head_over_tol",
                                     "worst_body_over_tol", "worst_bn_stats_over_tol",
                                     "step_ms")} for r in scaleout["train"]]}}))
    log(json.dumps({"upload_summary": {
        "decode": {k: upload["decode"][k] for k in (
            "wire_ratio", "encode_ms", "decode_ms", "raw_copy_ms", "decode_wall_ms",
            "raw_copy_wall_ms", "decode_device_ops")},
        "exact_cli_wall_s_median": {k: statistics.median(v)
                                    for k, v in upload["exact_cli_wall_s"].items()},
        "backlog_audio_s_per_s_median": {k: statistics.median(v) for k, v in
                                         upload["backlog_audio_s_per_s"].items()},
        "worker_vs_stream": upload["worker_vs_stream"],
        "codec_on_vs_off": upload["codec_on_vs_off"],
        "trace_kernels": upload["trace_kernels"], "phase_s": upload["phase_s"]}}))
    log(json.dumps({"kernels": out}))
    log(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
