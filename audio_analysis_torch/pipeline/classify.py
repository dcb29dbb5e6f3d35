"""Recording classification: the reference's ``classify``
(src/identify_tracks.py:416-573) as a host orchestrator around the device
work (the JAX package's pipeline/classify.py).

Detection (end-scan, |STFT|, medians, morphology) runs on the device and
one mask comes back for the host CCL. Then, per model group, every window
of every track is gathered into one [n_windows, sample_size] grid, and the
frontend, each model's forward pass, the ensemble mean and the per-track
means run as one pass over that grid (``run_group``, which batch serving
shares). The frontend level (``frontend_level``) is resolved once per
recording and holds for its end-scan and its classify frontend.

Tracks of models whose metadata sets ``filter_freq`` or ``filter_below``
are band-passed first (reference src/identify_tracks.py:152-161): each such
track's samples are cut out, stacked [n_filtered, max_len] on the device
and filtered by ``ops/filters.py::sosfilt_array`` with one Butterworth
filter a row, and the track's windows in the grid are gathered again from
its filtered samples (``filter_windows``).

An embeddings group (``"name": "embeddings"``) plans no windows: its models
classify the embeddings of each track's 5 s windows of the raw PCM
(``run_embeddings_group``, pipeline/embeddings.py).
"""

import logging
from pathlib import Path

import numpy as np
import torch

from audio_analysis_torch.detect.signal import (
    MAX_FREQUENCY,
    ModelResult,
    Prediction,
    Signal,
    get_tracks_from_signals,
)
from audio_analysis_torch.detect.signal_noise import detect
from audio_analysis_torch.device import resolve_device, to_device_async
from audio_analysis_torch.io.audio import load_recording
from audio_analysis_torch.io.modelconfig import ModelConfig
from audio_analysis_torch.io.pcmcodec import upload_pcm, wire_codec_enabled
from audio_analysis_torch.models.registry import load_classifier
from audio_analysis_torch.ops.filters import butter_bandpass_sos, sosfilt_array
from audio_analysis_torch.pipeline.embeddings import chirp_embeddings, load_embedder
from audio_analysis_torch.pipeline.frontend import frontend_level, spectrogram_grid
from audio_analysis_torch.pipeline.samples import (
    gather_windows,
    pad_plan_to_bucket,
    plan_windows,
)
from audio_analysis_torch.utils.profiling import span
from audio_analysis_torch.utils.runtime import StageTimer


def plan_for_config(length, sr, tracks, cfg: ModelConfig, rng=np.random):
    """The one place a ModelConfig's planning knobs map onto plan_windows."""
    return plan_windows(
        int(length),
        sr,
        tracks,
        cfg.segment_length,
        cfg.segment_stride,
        fmin=cfg.fmin,
        fmax=cfg.fmax,
        filter_freqs=cfg.filter_freq,
        filter_below=cfg.filter_below,
        pad_short_tracks=cfg.pad_short_tracks,
        rng=rng,
    )


def features_for_config(grid, sr, cfg: ModelConfig, level=None):
    """Frontend over the grid (reference get_spect semantics) at ``level``
    (None: the frontend level resolved now)."""
    return spectrogram_grid(
        grid,
        level=level,
        sr=int(sr),
        hop_length=int(cfg.hop_length),
        n_fft=int(cfg.n_fft),
        n_mels=int(cfg.n_mels),
        mel_break=float(cfg.break_freq),
        htk=bool(cfg.htk),
        fmin=cfg.fmin,
        fmax=cfg.fmax,
        power=float(cfg.power),
        db_scale=bool(cfg.db_scale),
        normalize=bool(cfg.normalize),
        mean_sub=bool(cfg.mean_sub),
        use_mfcc=bool(cfg.use_mfcc),
        channels=int(cfg.channels),
    )


def float_pcm(frames: torch.Tensor) -> torch.Tensor:
    """int16 PCM -> float32 /32768 (the 16-bit decode scaling); float PCM
    as float32."""
    if frames.dtype == torch.int16:
        return frames.to(torch.float32) / 32768.0
    return frames.to(torch.float32)


def _track_segment(frames, g0, g1):
    """frames[g0:g1] of a [T] tensor, the start clamped so that the slice
    fits, as the JAX package's ``dynamic_slice`` takes it."""
    start = max(0, min(g0, frames.shape[-1] - (g1 - g0)))
    return frames[start : start + g1 - g0]


def filter_windows(grid, recordings, sr):
    """Band-pass the windows of filtered tracks (the JAX package's
    ``_apply_track_filters`` and ``_overwrite_filtered_rows``).

    ``recordings`` lists (frames [T] float32, plan, row0): a recording's
    PCM, its window plan (``plan.filter_specs`` names the filtered tracks
    and their bands, ``plan.track_bounds`` their samples) and the grid row
    of the plan's first window. Every filtered track's samples are stacked
    [n_filtered, max_len] (zero-padded) and filtered in one
    ``sosfilt_array`` call, one Butterworth filter a row (identity sections
    pad shorter filters); then each of the track's windows is gathered
    again from its filtered samples, in the track's own coordinates, and
    zeroed outside [valid_lo, valid_hi). Returns the grid, unchanged when no
    track is filtered."""
    segs, sos, rows, bases, vlo, vhi, which = [], [], [], [], [], [], []
    for frames, plan, row0 in recordings:
        for ti, low, high in plan.filter_specs:
            g0, g1 = plan.track_bounds[ti]
            sel = np.nonzero(plan.track_index == ti)[0]
            segs.append(_track_segment(frames, g0, g1))
            sos.append(butter_bandpass_sos(float(low), float(high), float(sr)))
            rows.append(row0 + sel)
            bases.append(plan.base[sel].astype(np.int64) - g0)
            vlo.append(plan.valid_lo[sel])
            vhi.append(plan.valid_hi[sel])
            which.append(np.full(len(sel), len(segs) - 1))
    if not segs:
        return grid
    max_len = max(len(x) for x in segs)
    n_sections = max(len(s) for s in sos)
    sos_arr = np.zeros((len(sos), n_sections, 5))
    sos_arr[:, :, 0] = 1.0  # identity sections for padding
    for i, s in enumerate(sos):
        sos_arr[i, : len(s)] = s
    stack = torch.stack([torch.nn.functional.pad(x, (0, max_len - len(x))) for x in segs])
    filtered = sosfilt_array(sos_arr, stack)

    dev = grid.device
    rows, bases, lo, hi, which = to_device_async(torch.from_numpy(np.stack(
        [np.concatenate(a).astype(np.int64) for a in (rows, bases, vlo, vhi, which)])), dev)
    j = torch.arange(grid.shape[-1], device=dev)
    idx = (bases[:, None] + j[None, :]).clamp_(0, max_len - 1)
    win = filtered[which[:, None], idx]
    valid = (j[None, :] >= lo[:, None]) & (j[None, :] < hi[:, None])
    grid = grid.clone()
    grid[rows] = torch.where(valid, win, 0.0)
    return grid


def _track_means(per_window_probs, track_index, n_tracks):
    """Mean over each track's windows (reference: np.mean(predictions,
    axis=0) per track, :551). Windows indexed n_tracks (the bucket padding)
    are summed apart and dropped, so their values never reach a track."""
    seg = to_device_async(torch.from_numpy(np.asarray(track_index, np.int64)),
                          per_window_probs.device)
    sums = torch.zeros(
        (n_tracks + 1, per_window_probs.shape[1]), dtype=per_window_probs.dtype,
        device=per_window_probs.device,
    ).index_add_(0, seg, per_window_probs)
    counts = torch.zeros(n_tracks + 1, dtype=per_window_probs.dtype,
                         device=per_window_probs.device)
    counts.index_add_(0, seg, torch.ones_like(seg, dtype=per_window_probs.dtype))
    return sums[:n_tracks] / torch.clamp(counts[:n_tracks], min=1.0)[:, None]


def run_group(models, feat_cfg, frames_flat, padded_plan, n_tracks, is_efficientnet, *,
              sr, level=None, feats=None):
    """One model group over a window plan, on the frames' device: window
    gather -> frontend (``feat_cfg``'s settings, at ``level``) -> every
    model -> ensemble mean -> per-track means [n_tracks, n_labels].

    ``frames_flat`` is [T] int16 or float PCM (a batch's recordings laid end
    to end); plan windows with track index ``n_tracks`` are bucket padding
    and are dropped. ``feats`` reuses an earlier group's features: the
    reference feeds the first group's features to every later group
    verbatim (src/identify_tracks.py:525-528), and only the EfficientNet
    3-channel repeat follows the current group (:539-540). Returns
    (track means, features)."""
    if feats is None:
        with span("infer.gather"):
            grid = gather_windows(float_pcm(frames_flat), padded_plan)
        with span("infer.frontend"):
            feats = features_for_config(grid, sr, feat_cfg, level=level)
    with span("infer.forward"):
        x = feats.repeat_interleave(3, dim=-1) if is_efficientnet else feats
        probs = None
        for model in models:
            p = model(x)
            probs = p if probs is None else probs + p
        probs = probs / len(models)
        means = _track_means(probs, padded_plan.track_index, n_tracks)
    return means, feats


def run_embeddings_group(models, cfg: ModelConfig, embedder, frames, sr, tracks):
    """One embeddings group over one recording's tracks (the JAX package's
    embeddings branch): every window's embedding from the PCM `frames` [T]
    (never band-passed), every model over the embeddings, the ensemble
    mean, the per-track means, then the thresholds."""
    embs, counts = chirp_embeddings(frames, sr, tracks, cfg.segment_stride, embedder)
    probs = None
    for model in models:
        p = model(embs)
        probs = p if probs is None else probs + p
    probs = probs / len(models)
    seg = np.repeat(np.arange(len(tracks)), counts)
    track_probs = _track_means(probs, seg, len(tracks)).cpu().numpy()
    apply_thresholds(tracks, track_probs, np.asarray(counts), cfg)


def classify(file, models, analyse_tracks, meta_data=None, rng=np.random, timer=None,
             device=None):
    """Reference-compatible entry: returns
    (tracks, length, signals, raw_length, bird_labels)."""
    timer = timer or StageTimer()
    with timer.stage("decode"):
        frames, sr = load_recording(file, prefer_int16=True, device=device)
    return classify_frames(
        frames, sr, models, analyse_tracks, meta_data, rng=rng, timer=timer, device=device
    )


@torch.inference_mode()
def classify_frames(frames, sr, models, analyse_tracks, meta_data=None, rng=np.random,
                    timer=None, device=None):
    dev = resolve_device(device)
    timer = timer or StageTimer()
    level = frontend_level()  # one level for the whole recording
    raw_length = len(frames) / sr
    frames_np = np.asarray(frames)
    if frames_np.dtype != np.int16:
        frames_np = frames_np.astype(np.float32)
    # int16 PCM uploads at half the bytes and converts (/32768) on device;
    # with the wire codec on it goes through the lossless codec (exact)
    with span("upload"):
        if frames_np.dtype == np.int16 and wire_codec_enabled():
            frames_dev = upload_pcm(frames_np, dev)[0, : len(frames_np)]
        else:
            frames_dev = torch.from_numpy(np.ascontiguousarray(frames_np)).to(dev)
    with timer.stage("detect"):
        length, signals = detect(frames_dev, sr, level=level)

    if analyse_tracks:
        if meta_data is None:
            return None
        tracks = []
        for t in meta_data["Tracks"]:
            signal = Signal(
                t["start"], t["end"], t.get("minFreq", 0), t.get("maxFreq", MAX_FREQUENCY)
            )
            signal.track_id = t["id"]
            tracks.append(signal)
    else:
        tracks = [s.copy() for s in signals]
        tracks = get_tracks_from_signals(tracks, length)
    if len(tracks) == 0:
        return [], length, [], raw_length, []

    # group models: pre-filter models run after the main ensemble group
    # (reference :444-455)
    pre_models, mean_models = [], []
    with span("models"):
        for model_file in models:
            cfg = ModelConfig.load(Path(model_file))
            if cfg.pre_model:
                pre_models.append((model_file, cfg))
            else:
                mean_models.append((model_file, cfg))
    grouped_models = [mean_models]
    if pre_models:
        grouped_models.append(pre_models)

    track_data = None  # (plan, has_windows) shared across groups like the reference
    feats_cache = None  # the first group's features, reused verbatim
    bird_labels = set()

    for model_group in grouped_models:
        if not model_group:
            continue
        if len(model_group) > 1:
            logging.info("Meaning predictions as have multiple models")
        with span("models"):
            predict_models = [
                (load_classifier(Path(mf), cfg, dev), cfg) for mf, cfg in model_group
            ]
        cfg = predict_models[0][1]
        bird_labels.update(cfg.bird_labels)

        if cfg.name == "embeddings":
            # embedding vectors per track window, classified by the group's
            # models (reference src/identify_tracks.py:498-499, 536-551);
            # no window plan: a later spectral group plans its own
            with timer.stage("infer"):
                embedder = load_embedder(cfg.raw.get("embedding_model"), dev)
                run_embeddings_group([m for m, _ in predict_models], cfg, embedder,
                                     frames_dev, sr, tracks)
            continue

        if track_data is None:
            with span("plan"):
                plan = plan_for_config(frames_dev.shape[-1], sr, tracks, cfg, rng=rng)
                has_windows = len(plan.base) > 0
                track_data = (pad_plan_to_bucket(plan), has_windows, cfg)
        else:
            logging.info(
                "Re using track data this will cuase problems if the STFT "
                "settings are not the same for multiple models"
            )
        plan, has_windows, feat_cfg = track_data
        if not has_windows:
            # every track is out of the model's band: skip inference for THIS
            # group, keep iterating so later groups add their bird_labels
            # (src/identify_tracks.py:494, 537-538)
            continue

        with timer.stage("infer"):
            if plan.filter_specs and feats_cache is None:
                # the filtered tracks' windows come from their band-passed
                # samples; later groups reuse these features as they are
                with span("infer.gather"):
                    framesf = float_pcm(frames_dev)
                    grid = filter_windows(gather_windows(framesf, plan), [(framesf, plan, 0)],
                                          sr)
                with span("infer.frontend"):
                    feats_cache = features_for_config(grid, sr, feat_cfg, level=level)
            # like the reference's ``data = track_data`` (:525-528): later
            # groups reuse the FIRST group's features verbatim
            track_probs, feats_cache = run_group(
                [m for m, _ in predict_models], feat_cfg, frames_dev, plan, plan.n_tracks,
                cfg.is_efficientnet, sr=sr, level=level, feats=feats_cache,
            )
            with span("infer.wait"):
                track_probs = track_probs.cpu().numpy()

        windows_per_track = np.bincount(plan.track_index, minlength=plan.n_tracks)
        apply_thresholds(tracks, track_probs, windows_per_track, cfg)

    return tracks, length, signals, raw_length, list(bird_labels)


def apply_thresholds(tracks, track_probs, windows_per_track, cfg: ModelConfig):
    """Turn per-track mean probabilities into Prediction/ModelResult objects
    (reference: src/identify_tracks.py:553-571): labels above threshold keep
    their ebird ids; otherwise the argmax becomes a raw below-threshold
    prediction."""
    labels = cfg.labels
    ebird_ids = cfg.ebird_ids
    prob_thresh = cfg.threshold
    for ti, t in enumerate(tracks):
        if windows_per_track[ti] == 0:
            continue  # skipped/out-of-band track (reference :537-538)
        prediction = track_probs[ti]
        max_p = None
        result = ModelResult(cfg.name, cfg.pre_model)
        t.results.append(result)
        for i, p in enumerate(prediction):
            if max_p is None or p > max_p[1]:
                max_p = (i, p)
            if p >= prob_thresh:
                ebird_id = ebird_ids[i] if ebird_ids is not None else None
                result.add_prediction(labels[i], p, ebird_id, prob_thresh)
        if len(result.predictions) == 0:
            ebird_id = ebird_ids[max_p[0]] if ebird_ids is not None else None
            result.raw_prediction = Prediction(labels[max_p[0]], max_p[1], ebird_id)
