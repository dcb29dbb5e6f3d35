"""Batch serving CLI: analyse many recordings through the warm
BatchAnalyzer (the JAX package's cli/batch.py: same flags, defaults, stdout
JSON, sidecar writes and exit codes, plus ``--device``).

Unlike the reference (one process per recording), this keeps the models and
the kernel library warm, streams batches through the device pipeline, and
merges each result into its sidecar (or prints a JSON array with -o).
``AAT_FAST=1`` selects the fast frontend level (the bf16 tensor-core
DFT -> mel) for the end-scan and the classify frontend.

Usage:
  python -m audio_analysis_torch.cli.batch [-o] --bird-model M [--bird-model M2]
      [--batch-size 8] [--seed N] [--device cuda|cpu] FILE [FILE ...]
"""

import argparse
import itertools
import json
import logging
import sys
import time

import numpy as np

from audio_analysis_torch.cli.analyse import init_logging, none_or_str, str2bool
from audio_analysis_torch.io.audio import load_recording
from audio_analysis_torch.io.metadata import jsdump, read_sidecar, write_sidecar_result
from audio_analysis_torch.utils.runtime import rss_mb as _rss_mb


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-o", "--meta-to-stdout", action="count")
    p.add_argument("--bird-model", type=none_or_str, action="append")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument(
        "--watch",
        action="store_true",
        help="daemon mode: FILES is one spool directory; poll it and analyse "
        "new recordings as they appear, writing each result into its "
        "sidecar. Restart-safe: files whose sidecar already carries "
        "analysis_result are skipped.",
    )
    p.add_argument("--poll-interval", type=float, default=2.0)
    p.add_argument("--max-polls", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument(
        "--recycle-rss-mb",
        type=int,
        default=0,
        help="watch mode: re-exec the daemon when host RSS exceeds this "
        "(MB). The sidecar completion records make a restart lossless — "
        "this bounds the footprint under host-memory leaks outside the "
        "framework. 0 disables.",
    )
    p.add_argument(
        "--prewarm",
        action="store_true",
        help="run a synthetic batch before touching real work (CUDA "
        "context, kernel library, cuDNN plans), so the first real batch runs "
        "at warm latency. Carried through --recycle-rss-mb re-execs, which "
        "therefore also restart warm.",
    )
    p.add_argument(
        "--analyse-tracks",
        type=str2bool,
        default=False,
        help="classify the tracks listed in each recording's sidecar "
        "metadata instead of running signal detection (reference "
        "--analyse-tracks); results carry per-track labels only.",
    )
    p.add_argument(
        "--device",
        default="cuda",
        help="Device to run on: cuda (default) or cpu",
    )
    p.add_argument("files", nargs="+")
    args = p.parse_args(argv)
    args.raw_argv = list(sys.argv[1:] if argv is None else argv)
    if not args.bird_model:
        args.bird_model = [
            "/models/pre-model/audioModel.keras",
            "/models/bird-model-v2m/audioModel.keras",
        ]
    return args


AUDIO_EXTS = {".wav", ".mp3", ".ogg", ".opus", ".flac", ".m4a", ".aac"}


def _pending(root, min_age, done, fail_counts, max_fails=3):
    """Spool files awaiting analysis: audio extensions, not already in the
    in-memory `done` set, no analysis_result in the sidecar yet, not
    modified within `min_age` seconds (a file still being uploaded has a
    fresh mtime), under the failure budget. Completed paths enter `done` so
    a long-lived daemon does not re-read every old sidecar each poll; a
    restart re-derives the set from the sidecars themselves."""
    from pathlib import Path

    now = time.time()
    out = []
    for f in sorted(Path(root).iterdir()):
        if f.suffix.lower() not in AUDIO_EXTS or f in done:
            continue
        if fail_counts.get(f, 0) >= max_fails:
            done.add(f)  # give up permanently; bounds fail_counts too
            continue
        try:
            if min_age and now - f.stat().st_mtime < min_age:
                continue
        except OSError:
            continue  # vanished between listing and stat
        try:
            meta = read_sidecar(f)
        except Exception:
            # a corrupt/truncated sidecar (e.g. a writer killed mid-dump)
            # must not crash-loop the daemon: treat the file as failed
            fail_counts[f] = fail_counts.get(f, 0) + 1
            logging.error("unreadable sidecar for %s", f, exc_info=True)
            continue
        if meta and "analysis_result" in meta:
            done.add(f)
            continue
        out.append(f)
    return out


def _reexec(args):
    """Replace this daemon with a fresh copy of itself (same argv). Sidecar
    completion records carry all progress, so the only cost is the restart
    (model load, CUDA context, kernel library load). Per-file failure budgets
    reset — a poison file regains its 3 attempts per daemon lifetime."""
    logging.warning(
        "rss %.0f MB over --recycle-rss-mb %d: re-exec'ing for a fresh heap",
        _rss_mb(), args.recycle_rss_mb,
    )
    logging.shutdown()
    import os

    os.execv(
        sys.executable,
        [sys.executable, "-m", "audio_analysis_torch.cli.batch", *args.raw_argv],
    )


def watch(args, analyzer, t0):
    """Poll the spool directory forever (or --max-polls times, for tests),
    analysing new recordings in warm batches. The per-file sidecar is the
    completion record, so a restarted daemon resumes where it stopped —
    the same unit-of-retry contract as the reference's one-container-per-
    recording deployment, without the cold start per file. No single bad
    input may take the daemon down: decode, analysis, and sidecar-write
    failures are logged and budgeted per file (3 attempts), then skipped.

    --recycle-rss-mb N bounds the host footprint: checked between chunks
    (a large backlog must not OOM inside one poll) and after each poll;
    over the threshold the daemon re-execs itself (see _reexec). Only
    after analysis work has happened since exec — a fresh idle process
    over the threshold is just its baseline footprint, and restarting
    would loop without shrinking anything."""
    root = args.files[0]
    fail_counts = {}
    done = set()
    polls = 0
    worked = False
    while args.max_polls is None or polls < args.max_polls:
        todo = _pending(root, args.poll_interval, done, fail_counts)
        for i in range(0, len(todo), args.batch_size):
            if worked and args.recycle_rss_mb and _rss_mb() > args.recycle_rss_mb:
                _reexec(args)
            chunk = todo[i : i + args.batch_size]
            t_batch = time.time()
            recs, good, metas = [], [], []
            for f in chunk:
                try:
                    frames, _ = load_recording(
                        f, resample=analyzer.sr, prefer_int16=True
                    )
                    recs.append(frames)
                    good.append(f)
                    metas.append(_safe_sidecar(f))
                except Exception:
                    fail_counts[f] = fail_counts.get(f, 0) + 1
                    logging.error("failed to decode %s", f, exc_info=True)
            if not good:
                continue
            _analyse_chunk(
                analyzer, good, recs, fail_counts, done, t_batch,
                metas=metas, analyse_tracks=args.analyse_tracks,
            )
            worked = True
        polls += 1
        if worked and args.recycle_rss_mb and _rss_mb() > args.recycle_rss_mb:
            _reexec(args)
        if args.max_polls is None or polls < args.max_polls:
            time.sleep(args.poll_interval)


def _analyse_chunk(
    analyzer, files, recs, fail_counts, done, t_batch, metas=None,
    analyse_tracks=False,
):
    """Analyse `files` and write each sidecar, isolating failures per file.

    A batch-level analysis failure bisects down to the offending
    recording(s): a single poison input must not strike the 3-attempt
    budget of its healthy neighbours (which would otherwise re-form the
    same sorted chunk every poll and be permanently skipped together).
    A sidecar-write failure likewise strikes only its own file — the
    remaining results in the batch are still written."""
    try:
        results = analyzer.analyse_recordings(
            recs, meta_data=metas, analyse_tracks=analyse_tracks
        )
    except Exception:
        if len(files) == 1:
            f = files[0]
            fail_counts[f] = fail_counts.get(f, 0) + 1
            logging.error("analysis failed for %s", f, exc_info=True)
            return
        logging.error(
            "analysis failed for batch of %d; bisecting to isolate",
            len(files),
            exc_info=True,
        )
        mid = len(files) // 2
        _analyse_chunk(
            analyzer, files[:mid], recs[:mid], fail_counts, done, t_batch,
            metas=metas[:mid] if metas else None, analyse_tracks=analyse_tracks,
        )
        _analyse_chunk(
            analyzer, files[mid:], recs[mid:], fail_counts, done, t_batch,
            metas=metas[mid:] if metas else None, analyse_tracks=analyse_tracks,
        )
        return
    for fname, result in zip(files, results):
        result["processing_time_seconds"] = round(time.time() - t_batch, 1)
        try:
            write_sidecar_result(fname, result)
        except Exception:
            fail_counts[fname] = fail_counts.get(fname, 0) + 1
            logging.error("failed to write sidecar for %s", fname, exc_info=True)
            continue
        done.add(fname)
        logging.info("analysed %s", fname)


def run(argv=None, timer=None):
    """Run the CLI on `argv` (None: sys.argv); returns the results.
    `timer`: optional StageTimer that every batch's stages add into."""
    from audio_analysis_torch.pipeline.serve import BatchAnalyzer

    args = parse_args(argv)
    init_logging()
    t0 = time.time()
    rng = np.random.RandomState(args.seed) if args.seed is not None else np.random
    analyzer = BatchAnalyzer(args.bird_model, rng=rng, device=args.device)
    if args.prewarm:
        t_warm = time.time()
        stages = analyzer.prewarm(batch_size=args.batch_size)
        logging.info(
            "prewarm: %.1fs (%s)",
            time.time() - t_warm,
            ", ".join(f"{k} {v:.2f}s" for k, v in stages.items()),
        )
    if args.watch:
        watch(args, analyzer, t0)
        return []
    args.files = _expand_dirs(args.files)

    def batches():
        for i in range(0, len(args.files), args.batch_size):
            chunk = args.files[i : i + args.batch_size]
            recs, metas = [], []
            for f in chunk:
                frames, _ = load_recording(f, resample=analyzer.sr, prefer_int16=True)
                recs.append(frames)
                metas.append(_safe_sidecar(f))
            yield chunk, recs, metas

    all_results = []
    names = []
    # recs and metas are split from ONE underlying iterator: pairing holds
    # regardless of the order analyse_stream pulls the two generators in
    # (tee buffers at most one batch while the pulls are in lockstep)
    b_recs, b_metas = itertools.tee(batches())

    def rec_gen():
        for chunk, recs, _metas in b_recs:
            names.append(chunk)
            yield recs

    stream = analyzer.analyse_stream(
        rec_gen(),
        meta_batches=(metas for _chunk, _recs, metas in b_metas),
        analyse_tracks=args.analyse_tracks,
        timer=timer,
    )
    for batch_results in stream:
        for fname, result in zip(names.pop(0), batch_results):
            result["processing_time_seconds"] = round(time.time() - t0, 1)
            all_results.append({"file": fname, "analysis": result})
            if not args.meta_to_stdout:
                write_sidecar_result(fname, result)
                logging.info("wrote sidecar for %s", fname)
    if args.meta_to_stdout:
        print(jsdump(all_results))
    return all_results


def _expand_dirs(paths):
    """Non-watch mode accepts directories too (the documented FILES_OR_DIR
    contract): each expands to its audio files, sorted, non-recursive —
    the same membership rule as the --watch spool scan."""
    from pathlib import Path

    out = []
    for f in paths:
        p = Path(f)
        if p.is_dir():
            out.extend(
                str(q) for q in sorted(p.iterdir())
                if q.is_file() and q.suffix.lower() in AUDIO_EXTS
            )
        else:
            out.append(f)
    return out


def _safe_sidecar(f):
    """Sidecar metadata for location filtering / --analyse-tracks; an
    unreadable sidecar degrades to None (same as no sidecar) rather than
    failing the whole batch."""
    try:
        return read_sidecar(f)
    except Exception:
        logging.warning("unreadable sidecar for %s; analysing without", f)
        return None


def main():
    try:
        run()
    except Exception:
        logging.error("Terminated with error", exc_info=True)
        sys.exit(1)


if __name__ == "__main__":
    main()
