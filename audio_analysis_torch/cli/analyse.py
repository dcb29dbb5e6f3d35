"""CLI: argument-compatible with the reference's ``analyse.py``
(src/analyse.py:376-487) — same flags, default model paths, stderr log
format, sidecar merge semantics, and exit-code contract (trap everything,
log, exit 1) — as the JAX package's cli/analyse.py, plus ``--device``
(default ``cuda``; ``cpu`` runs the plain PyTorch versions of the kernels).

    python -m audio_analysis_torch.cli.analyse -o FILE --bird-model DIR
"""

import argparse
import logging
import sys
import time

from audio_analysis_torch.io.metadata import jsdump, write_sidecar_result


def none_or_str(value):
    if value.lower() in ["none", "null"]:
        return None
    return value


def str2bool(v):
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    elif v.lower() in ("no", "false", "f", "n", "0"):
        return False
    else:
        raise argparse.ArgumentTypeError("Boolean value expected.")


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "-o",
        "--meta-to-stdout",
        action="count",
        help="Print metadata to stdout instead of saving to file.",
    )
    parser.add_argument(
        "--old-cacophony-index",
        action="count",
        help="Calculate old cacophony index on this file",
    )
    parser.add_argument(
        "--bird-model",
        type=none_or_str,
        action="append",
        help="Path to bird model",
    )
    parser.add_argument("file", help="Audio file to run on")
    parser.add_argument(
        "--analyse-tracks",
        type=str2bool,
        default=False,
        help="Classify human made tracks marked with classify flag, in metadata file",
    )
    parser.add_argument(
        "--morepork-model",
        default=None,
        help="Run the legacy morepork detector with models under this directory",
    )
    parser.add_argument(
        "--seed",
        type=int,
        default=None,
        help="Seed window-padding randomness (framework extension; "
        "omit for reference-like nondeterminism)",
    )
    parser.add_argument(
        "--device",
        default="cuda",
        help="Device to run on: cuda (default) or cpu",
    )
    args = parser.parse_args(argv)
    if args.bird_model is None or len(args.bird_model) == 0:
        args.bird_model = [
            "/models/pre-model/audioModel.keras",
            "/models/bird-model-v2m/audioModel.keras",
        ]
    return args


def init_logging():
    fmt = "%(process)d %(thread)s:%(levelname)7s %(message)s"
    logging.basicConfig(
        stream=sys.stderr, level=logging.INFO, format=fmt, datefmt="%Y-%m-%d %H:%M:%S"
    )


def run(argv=None):
    args = parse_args(argv)
    init_logging()
    t0 = time.time()

    if args.old_cacophony_index:
        raise NotImplementedError(
            "--old-cacophony-index is not ported yet (ROADMAP Queue 1, item 10)"
        )
    elif args.morepork_model:
        raise NotImplementedError(
            "--morepork-model is not ported yet (ROADMAP Queue 1, item 10)"
        )
    else:
        from audio_analysis_torch.pipeline.analysis import examine
        import numpy as np

        rng = np.random.RandomState(args.seed) if args.seed is not None else np.random
        summary = examine(
            args.file, args.bird_model, analyse_tracks=args.analyse_tracks, rng=rng,
            device=args.device,
        )

    t1 = time.time()
    summary["processing_time_seconds"] = round(t1 - t0, 1)
    if args.meta_to_stdout:
        print(jsdump(summary))
    else:
        metadata_file = write_sidecar_result(args.file, summary)
        logging.info("Writing metadata to %s", metadata_file)
    return summary


def main():
    try:
        run()
    except Exception:
        logging.error("Terminated with error", exc_info=True)
        sys.exit(1)


if __name__ == "__main__":
    main()
