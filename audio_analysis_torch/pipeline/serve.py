"""Batch-of-recordings serving (the JAX package's pipeline/serve.py).

A ``BatchAnalyzer`` keeps its models warm on one device and analyses B
recordings at a time:

1. the recordings, stacked [B, T_bucket] in pinned host memory, go to the
   device in one queued copy, and one batched detection is queued
   (end-scan, |STFT|, medians, masks packed to words and copied back to
   pinned memory: ``detect_batch_dispatch``); nothing here waits for the
   device;
2. host (``_queue``): wait for the packed masks, the CCL of each
   recording in a host thread, track merging, and one combined window plan
   over the flattened [B*T] PCM with the track ids renumbered across the
   batch;
3. queued by ``_queue``, per model group, one pass over the whole batch's
   window grid: gather, frontend, models, ensemble mean, per-track means
   (``run_group``), and the per-track means' copy to pinned host memory;
   the windows of band-passed tracks (models whose metadata sets
   ``filter_freq`` or ``filter_below``) are gathered again from their
   filtered samples before the frontend (``classify.filter_windows``, one
   filter call for the batch), from the plans the queue step drew; every
   host array on the way goes to the device through pinned memory,
   queued, so nothing here waits for the device's queue to drain;
4. host (``_collect``): wait for the copied means, then thresholds, eBird
   filter, master tags, chirps and cacophony index per recording.

The frontend level (``frontend_level``: AAT_FAST / AAT_PALLAS) is resolved
once per batch, at dispatch, and holds for its end-scan and its classify
frontend. ``_finish`` is ``_queue`` then ``_collect``. ``analyse_stream``
keeps two batches in flight ahead of the one it collects: at step k it
dispatches batch k+1, queues batch k's classify and collects batch k-1,
so the host stacks, labels and plans while the device runs the classify
queued a step before.

The JAX package band-passes a batch with filtered tracks one recording at
a time (its ``_infer_with_filters``); windows are independent, so the one
combined pass gives the same windows, features and track means.

An embeddings group (``"name": "embeddings"``, decided by its first
model's config) runs per recording at its place in the listed group order
(``classify.run_embeddings_group``: one embedder forward a recording, from
the raw PCM, never band-passed); window planning serves the spectral
groups alone, so an analyzer with embeddings groups only plans nothing.
The embedder is loaded once per analyzer.

Over a mesh (``BatchAnalyzer(mesh=make_mesh())``, parallel/mesh.py: one
process a device, joined by torch.distributed) each rank analyses the
recordings it is fed on its own device, through the single-device path
above: detection, the window plan, the frontend, the models and the track
means all stay on the rank, because a track's windows all come from one
recording. In a world of several ranks the ranks exchange host values
only: the per-rank batch sizes and longest recordings, checked as the JAX
package's ``_prepare`` checks them (equal, non-empty batches, recordings no
longer than the bucket; every rank raises the same ValueError), and the
results, gathered over 'data' in rank order so that every rank returns the
global list (the reference CLI's single-writer contract). Ranks that share
a data index (a 'model' dim above 1) replicate: they are fed the same
recordings and each gathers the same list. The JAX package also shards the
global window grid along 'data', which balances windows across chips; that
is not carried over: the results do not depend on it, and it comes back
only if a measurement shows an imbalance (ROADMAP).

Upload (the JAX package's ``_prepare`` / ``_dispatch_prepared``):
``_prepare`` is host-only (stack the recordings; with the wire codec on,
``io/pcmcodec.py``, encode them, the bucket rounded up to the codec's
BLOCK), ``_dispatch_prepared`` queues the copy (or the codec's copy and
decode) and the detection. The codec is off on a mesh. ``analyse_stream``
prepares and dispatches batch k+1 on the caller's thread, whatever
``AAT_ASYNC_UPLOAD`` and ``AAT_ENCODE_AHEAD`` say: the JAX package's
worker threads for them measured no gain on an H100 (ROADMAP Queue 3).
The device halves run under ``torch.inference_mode``.
"""

from pathlib import Path

import numpy as np
import torch

from audio_analysis_torch.detect.signal import get_tracks_from_signals
from audio_analysis_torch.detect.signal_noise import detect_batch_dispatch, detect_batch_finish
from audio_analysis_torch.device import resolve_device, to_device_async, to_host_async
from audio_analysis_torch.io.pcmcodec import (
    BLOCK,
    encode_pcm,
    upload_pcm_encoded,
    wire_codec_enabled,
)
from audio_analysis_torch.models.registry import load_classifier
from audio_analysis_torch.pipeline.analysis import recording_result
from audio_analysis_torch.pipeline.classify import (
    apply_thresholds,
    features_for_config,
    filter_windows,
    float_pcm,
    model_groups,
    plan_for_config,
    run_embeddings_group,
    run_group,
    sidecar_tracks,
)
from audio_analysis_torch.pipeline.embeddings import load_embedder
from audio_analysis_torch.pipeline.frontend import frontend_level
from audio_analysis_torch.pipeline.samples import WindowPlan, gather_windows, pad_plan_to_bucket
from audio_analysis_torch.utils.profiling import recording, span, span_args
from audio_analysis_torch.utils.runtime import StageTimer, timings_on


def _is_embeddings(group):
    """The first model's config decides (the JAX package's ``_is_embeddings``;
    reference src/identify_tracks.py:498-499)."""
    return group[0][1].name == "embeddings"


class BatchAnalyzer:
    """Warm serving handle: analyse lists of recordings in batches."""

    def __init__(self, models, sr=48000, bucket_seconds=60, rng=np.random, mesh=None,
                 device=None):
        """`device`: None means ``cuda`` (``device.resolve_device``). `mesh`:
        a ('data', 'model') ``DeviceMesh`` (parallel/mesh.py), which decides
        the device: this rank's."""
        if mesh is not None:
            from audio_analysis_torch.parallel.mesh import rank_device

            if device is not None:
                raise ValueError("pass a mesh or a device: the mesh decides the device")
            device = rank_device(mesh)
        self.mesh = mesh
        self.device = resolve_device(device)
        self.sr = int(sr)
        self.bucket = int(bucket_seconds * sr)
        self.rng = rng
        self.groups = [[(load_classifier(Path(mf), cfg, self.device), cfg) for mf, cfg in group]
                       for group in model_groups(models)]
        self._embedders = {}

    # -- public -------------------------------------------------------------

    def prewarm(self, batch_size=8, seed=0):
        """Run a synthetic bucket-length batch with tonal content (tones
        detect as real tracks, so every stage runs, not just detection)
        through ``analyse_recordings`` and discard its results: the CUDA
        context, the kernel library, cuDNN's plans and the caching allocator
        are warm before the first real batch.

        Runs on a PRIVATE rng: a seeded analyzer produces the same stream of
        results whether or not it was prewarmed. Returns the warm-up batch's
        per-stage seconds."""
        prng = np.random.RandomState(seed)
        t = np.arange(self.bucket, dtype=np.float32) / self.sr
        recs = []
        for i in range(int(batch_size)):
            y = 0.01 * prng.randn(self.bucket).astype(np.float32)
            # a few well-separated tones -> a handful of tracks per recording
            for k, f0 in enumerate((900.0, 2600.0, 4800.0)):
                t0 = (2.0 + 7.0 * k + 0.5 * i) % max(1.0, t[-1] - 2.0)
                m = (t >= t0) & (t < t0 + 1.0)
                y[m] += 0.4 * np.sin(2 * np.pi * (f0 + 37.0 * i) * t[m]).astype(np.float32)
            recs.append((np.clip(y, -1, 1) * 32767).astype(np.int16))
        timer = StageTimer()
        saved_rng = self.rng
        self.rng = np.random.RandomState(seed)
        try:
            self.analyse_recordings(recs, timer=timer)
        finally:
            self.rng = saved_rng
        return timer.as_dict()

    def analyse_recordings(self, recordings, sr=None, timer=None, meta_data=None,
                           analyse_tracks=False):
        """recordings: list of mono float32/int16 numpy arrays at self.sr.
        Returns a list of result dicts (species_identify schema).

        `meta_data`: optional list (len B) of per-recording sidecar dicts
        (or None entries); location metadata drives eBird filtering before
        the master tags, as on the single-recording path. With
        `analyse_tracks=True` the tracks come from each entry's "Tracks"
        list, detection is skipped, and results carry per-track labels only;
        a recording with no metadata yields an empty track list.

        `timer`: optional StageTimer; with AAT_TIMINGS=1 each result carries
        the batch's per-stage wall clock under "timing"."""
        timer = timer or StageTimer()
        with timer.stage("dispatch"):
            handle = self._dispatch(recordings, sr, meta_data, analyse_tracks)
        return self._finish(handle, timer=timer, timed=timings_on())

    def analyse_stream(self, batches, sr=None, meta_batches=None, analyse_tracks=False,
                       timer=None):
        """Pipelined serving: yields one result list per batch, in batch
        order. At step k the stream dispatches batch k+1 (stacks it and
        queues its detection), queues batch k's classify (``_queue``: its
        masks were queued before batch k-1's classify, so they are back)
        and then collects batch k-1 (``_collect``: readback, thresholds,
        post) and yields it. The device runs classify k-1, detection k+1,
        classify k in that order, and the host stacks, labels and plans
        the next batches while classify k-1 runs; no host-device wait lies
        between queueing a batch's classify and reading it back.

        `meta_batches`: optional iterable zipped with `batches`, each item a
        list of per-recording sidecar dicts (see analyse_recordings).
        `timer`: optional StageTimer that every batch's stages add into.

        Batches are prepared and dispatched on this thread: the JAX
        package's AAT_ASYNC_UPLOAD and AAT_ENCODE_AHEAD worker threads are
        not ported (ROADMAP Queue 3), and both variables are ignored. An
        exception raised while a batch is pulled, dispatched or queued
        reaches the caller after the results of every batch queued before
        it; the batch dispatched but not yet queued is lost with it.
        Under a recording profiler every mark of batch k (its stages and
        spans) carries ``batch=k`` (``utils/profiling.py::span_args``)."""
        timer = timer or StageTimer()
        metas = iter(meta_batches) if meta_batches is not None else None

        def queue(k, handle):
            with span_args(batch=k):
                return k, self._queue(handle, timer)

        def collect(k, handle):
            with span_args(batch=k):
                return self._collect(handle, timer)

        pulled = enumerate(batches)
        queued = []  # (k, ``_queue``'s handle) not yet collected, oldest first
        dispatched = None  # (k, ``_dispatch``'s handle) not yet queued
        while True:
            try:
                step = next(pulled, None)
                if step is None:
                    if dispatched is not None:
                        queued.append(queue(*dispatched))
                    break
                k, batch = step
                md = next(metas) if metas is not None else None
                with span_args(batch=k), timer.stage("dispatch"):
                    handle = self._dispatch(batch, sr, md, analyse_tracks)
                if dispatched is not None:
                    queued.append(queue(*dispatched))
                dispatched = (k, handle)
            except Exception:
                # the batches queued before the failure are still collected
                # and yielded, in order, before it reaches the caller
                for entry in queued:
                    yield collect(*entry)
                raise
            if len(queued) == 2:
                yield collect(*queued.pop(0))
        for entry in queued:
            yield collect(*entry)

    # -- two-phase internals --------------------------------------------------

    @property
    def _multihost(self):
        from audio_analysis_torch.parallel.distributed import is_multihost

        return self.mesh is not None and is_multihost()

    def _check_feeds(self, recordings):
        """Every rank runs the same collectives, so per-rank batches must
        agree: equal and non-empty, and no recording longer than the
        bucket. Checked collectively (the JAX package's ``_prepare``), so
        that every rank raises the same error instead of one waiting on
        the others."""
        from audio_analysis_torch.parallel.distributed import allgather_host_values

        counts = set(allgather_host_values(len(recordings)))
        longest = max(allgather_host_values(max((len(r) for r in recordings), default=0)))
        if len(counts) != 1 or 0 in counts:
            raise ValueError(
                "multi-host serving requires equal non-empty per-host "
                f"batches; got per-process sizes {sorted(counts)}"
            )
        if longest > self.bucket:
            raise ValueError(
                f"multi-host serving requires recordings <= bucket_seconds"
                f" ({longest} > {self.bucket} samples)"
            )

    def _gather(self, results, timer):
        """The global result list, in rank order, on every rank of this
        rank's 'data' group."""
        from audio_analysis_torch.parallel.distributed import allgather_results
        from audio_analysis_torch.parallel.mesh import data_group

        group = data_group(self.mesh)
        if group is None:  # one data index: this rank's list is the global one
            return results
        with timer.stage("gather"):
            return allgather_results(results, group=group)

    def _dispatch(self, recordings, sr=None, meta_data=None, analyse_tracks=False):
        """Queue a batch's copy to the device and its detection (skipped
        under analyse_tracks: the tracks come from the metadata). Does not
        wait for the device."""
        return self._dispatch_prepared(self._prepare(recordings, sr, meta_data, analyse_tracks))

    def _prepare(self, recordings, sr=None, meta_data=None, analyse_tracks=False):
        """Host half of `_dispatch`: stack the recordings into one
        [B, T_bucket] tensor (int16 when every recording is int16: half the
        bytes to copy, converted /32768 on the device; in pinned memory for
        a CUDA device, so the copy is queued), their valid lengths, and with
        the wire codec on the encoding of the int16 stack."""
        if self._multihost:
            self._check_feeds(recordings)
        if len(recordings) == 0:
            return None
        t_bucket = max(self.bucket, max(-(-len(r) // self.sr) * self.sr for r in recordings))
        all_i16 = all(np.asarray(r).dtype == np.int16 for r in recordings)
        # the codec decodes onto one device: off on a mesh (which multi-rank
        # serving implies), as in the JAX package
        use_codec = all_i16 and self.mesh is None and wire_codec_enabled()
        if use_codec:
            # the codec works on BLOCK-sample blocks; n_valid masks the
            # slightly longer bucket everywhere downstream
            t_bucket = -(-t_bucket // BLOCK) * BLOCK
        with span("dispatch.stack"):
            stacked = torch.zeros((len(recordings), t_bucket),
                                  dtype=torch.int16 if all_i16 else torch.float32,
                                  pin_memory=self.device.type == "cuda")
            rows = stacked.numpy()
            n_valid = np.zeros(len(recordings), np.int32)
            for i, r in enumerate(recordings):
                rows[i, : len(r)] = r
                n_valid[i] = len(r)
            enc = encode_pcm(rows) if use_codec else None
        return (stacked, enc, n_valid, t_bucket, int(sr or self.sr), meta_data, analyse_tracks)

    @torch.inference_mode()
    def _dispatch_prepared(self, prep):
        """Device half of `_dispatch`: the copy (or the codec's copy and
        decode) and the detection."""
        if prep is None:
            return None
        stacked, enc, n_valid, t_bucket, sr, meta_data, analyse_tracks = prep
        level = frontend_level()
        with span("dispatch.copy"):
            if enc is not None:
                frames_dev = upload_pcm_encoded(stacked, enc, self.device)
            else:
                frames_dev = to_device_async(stacked, self.device)
        detect_handle = (
            None if analyse_tracks
            else detect_batch_dispatch(frames_dev, n_valid, sr, level=level)
        )
        return (detect_handle, frames_dev, n_valid, t_bucket, len(n_valid), sr, level, meta_data,
                analyse_tracks)

    def _finish(self, handle, timer=None, timed=False):
        """The batch's results (over a mesh, the global list): ``_queue``
        followed at once by ``_collect``. `timed`: each result carries its
        own rank's stage times under "timing", attached before the
        gather."""
        timer = timer or StageTimer()
        return self._collect(self._queue(handle, timer), timer, timed=timed)

    @torch.inference_mode()
    def _queue(self, handle, timer):
        """The first half of finishing a batch: wait for its packed masks,
        label and plan on the host, and queue every spectral group's
        gather, frontend, models, ensemble mean and per-track means, and the
        copy of each group's track probabilities to pinned host memory. No
        other wait for the device: the host copies on the way are pinned and
        queued, so work queued before the batch's classify keeps the device
        busy while this runs. Returns the handle ``_collect`` reads."""
        if handle is None:
            return None
        (detect_handle, frames_dev, n_valid, t_bucket, b_count, sr, level, meta_data,
         analyse_tracks) = handle
        rng = self.rng
        # window planning is a concern of the spectral groups alone; an
        # analyzer with embeddings groups only draws nothing from the rng
        spectral = [g for g in self.groups if not _is_embeddings(g)]
        cfg0 = spectral[0][0][1] if spectral else None
        per_rec_tracks = []
        all_tracks = []
        plans = []
        if analyse_tracks:
            # tracks from sidecar metadata (reference --analyse-tracks,
            # src/identify_tracks.py:422-433); no detection ran
            with timer.stage("plan"):
                for b in range(b_count):
                    md = meta_data[b] if meta_data is not None else None
                    tracks = sidecar_tracks(md) if md is not None else []
                    per_rec_tracks.append((int(n_valid[b]) / sr, [], tracks))
                    if cfg0 is not None:
                        plans.append(plan_for_config(n_valid[b], sr, tracks, cfg0, rng=rng))
                    all_tracks.append(tracks)
        else:
            with timer.stage("detect"):
                detections = detect_batch_finish(detect_handle)
            with timer.stage("plan"):
                for b, (length, signals) in enumerate(detections):
                    tracks = get_tracks_from_signals([s.copy() for s in signals], length)
                    per_rec_tracks.append((length, signals, tracks))
                    if cfg0 is not None:
                        plans.append(plan_for_config(n_valid[b], sr, tracks, cfg0, rng=rng))
                    all_tracks.append(tracks)

        track_offset = np.cumsum([0] + [len(t) for t in all_tracks])
        n_total = int(track_offset[-1])
        padded = windows_per_track = None
        if spectral and n_total > 0:
            with timer.stage("plan"):
                combined = self._combine_plans(plans, t_bucket)
                if len(combined.base) > 0:
                    padded = pad_plan_to_bucket(WindowPlan(
                        base=combined.base, valid_lo=combined.valid_lo,
                        valid_hi=combined.valid_hi, track_index=combined.track_index,
                        n_tracks=n_total, sample_size=combined.sample_size,
                    ))
                    windows_per_track = np.bincount(padded.track_index, minlength=n_total)
        pending = []
        if padded is not None:
            flat = frames_dev.reshape(-1)
            with timer.stage("infer"):
                # queue every group before reading any result back; the
                # frontend uses the FIRST group's config and its features
                # are reused verbatim by later groups (reference
                # src/identify_tracks.py:525-528); only the EfficientNet
                # channel repeat follows the current group (:539-540)
                feats = None
                if any(p.filter_specs for p in plans):
                    # band-passed tracks: their windows from their filtered
                    # samples, in each recording's own row of the batch
                    row0 = np.cumsum([0] + [len(p.base) for p in plans])
                    with span("infer.gather"):
                        flatf = float_pcm(flat)
                        rec = flatf.reshape(b_count, t_bucket)
                        grid = filter_windows(
                            gather_windows(flatf, padded),
                            [(rec[b], p, int(row0[b])) for b, p in enumerate(plans)
                             if p.filter_specs],
                            sr,
                        )
                    with span("infer.frontend"):
                        feats = features_for_config(grid, sr, cfg0, level=level)
                for group in spectral:
                    cfg = group[0][1]
                    probs, feats = run_group(
                        [m for m, _ in group], cfg0, flat, padded, n_total,
                        cfg.is_efficientnet, sr=sr, level=level, feats=feats,
                    )
                    # the probabilities' copy back is queued behind them
                    pending.append((cfg, to_host_async(probs)))
        done = None
        if pending and frames_dev.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(frames_dev.device))
        return (per_rec_tracks, all_tracks, track_offset, windows_per_track, pending, done,
                frames_dev, n_valid, sr, meta_data, analyse_tracks)

    @torch.inference_mode()
    def _collect(self, queued, timer, timed=False):
        """The second half: wait for the queued probabilities
        (``infer.wait``; under a recording profiler its arg ``ready`` is 1
        when they were already back, the device ahead of the host, else 0),
        apply each group's thresholds in the listed order (an embeddings
        group runs at its place), then post; over a mesh the gather."""
        results = []
        if queued is not None:
            (per_rec_tracks, all_tracks, track_offset, windows_per_track, pending, done,
             frames_dev, n_valid, sr, meta_data, analyse_tracks) = queued
            if track_offset[-1] > 0:
                # results are consumed in the listed group order, embeddings
                # groups at their place: each track's results keep the single
                # path's order, which the master tag reads
                probs = iter(pending)
                with timer.stage("infer"):
                    if pending:
                        ready = ({"ready": int(done.query())}
                                 if done is not None and recording() else {})
                        with span("infer.wait", **ready):
                            if done is not None:
                                done.synchronize()
                    for group in self.groups:
                        if _is_embeddings(group):
                            self._infer_embeddings(group, frames_dev, n_valid, sr, all_tracks)
                            continue
                        if not pending:  # no spectral window in the batch
                            continue
                        cfg, track_probs = next(probs)
                        track_probs = track_probs.numpy()
                        for b in range(len(all_tracks)):
                            lo, hi = track_offset[b], track_offset[b + 1]
                            apply_thresholds(all_tracks[b], track_probs[lo:hi],
                                             windows_per_track[lo:hi], cfg)
            with timer.stage("post"):
                results = self._post(per_rec_tracks, n_valid, sr, meta_data=meta_data,
                                     analyse_tracks=analyse_tracks)
        if timed:
            for r in results:
                r["timing"] = timer.as_dict()
        return self._gather(results, timer) if self._multihost else results

    def _post(self, per_rec_tracks, n_valid, sr, meta_data=None, analyse_tracks=False):
        """Each recording's result (``analysis.recording_result``), with
        the bird labels of every group."""
        bird_labels = {label for group in self.groups for _, cfg in group
                       for label in cfg.bird_labels}
        return [
            recording_result(tracks, signals, length, int(n_valid[b]) / sr, bird_labels,
                             meta_data[b] if meta_data is not None else None, analyse_tracks)
            for b, (length, signals, tracks) in enumerate(per_rec_tracks)
        ]

    # -- internals ----------------------------------------------------------

    def _infer_embeddings(self, group, frames_dev, n_valid, sr, all_tracks):
        """An embeddings group over every recording with tracks, one
        recording at a time (the JAX package's ``_infer_embeddings``), with
        the analyzer's embedder for the group's ``embedding_model``."""
        cfg = group[0][1]
        key = cfg.raw.get("embedding_model")
        if key not in self._embedders:
            self._embedders[key] = load_embedder(key, self.device)
        for b, tracks in enumerate(all_tracks):
            if tracks:
                run_embeddings_group([m for m, _ in group], cfg, self._embedders[key],
                                     frames_dev[b, : int(n_valid[b])], sr, tracks)

    @staticmethod
    def _combine_plans(plans, t_bucket):
        """Merge per-recording plans into one plan over the [B*T_bucket]
        flattened PCM: recording b's bases shift by b*T_bucket and its track
        ids by the tracks before it."""
        bases, vlo, vhi, tidx = [], [], [], []
        track_base = 0
        sample_size = plans[0].sample_size if plans else 0
        for b, plan in enumerate(plans):
            bases.append(plan.base.astype(np.int64) + b * t_bucket)
            vlo.append(plan.valid_lo)
            vhi.append(plan.valid_hi)
            tidx.append(plan.track_index + track_base)
            track_base += plan.n_tracks
            sample_size = plan.sample_size
        if not bases:
            return WindowPlan(
                base=np.zeros(0, np.int64), valid_lo=np.zeros(0, np.int32),
                valid_hi=np.zeros(0, np.int32), track_index=np.zeros(0, np.int32),
                n_tracks=0, sample_size=sample_size,
            )
        return WindowPlan(
            base=np.concatenate(bases), valid_lo=np.concatenate(vlo),
            valid_hi=np.concatenate(vhi), track_index=np.concatenate(tidx),
            n_tracks=track_base, sample_size=sample_size,
        )

