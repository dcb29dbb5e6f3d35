"""What the serving drivers (``drivers/backlog.py``, ``drivers/cli.py``)
share: the mix's environment set before the program is imported (the
frontend level, ``AAT_FAST``), the pool of seeded recordings written as
WAVs, the models drawn from the seed and written where the program loads
them, the seeded sample of completed recordings that the check judges, and
the check itself.

A driver (any module ``drivers/<name>.py`` with a class ``Driver``) is
built as ``Driver(cell, seed, device, workdir, trace)``, which is set-up,
and then gives ``window(seconds)`` (the end-to-end metrics it measures),
``stretch(units)`` (``self.profile``, whole units of work profiled after
the window), ``judge()`` (the numbers its check compares, after freeing
the program's state), ``attempted``, ``window_s`` and, for the per-layer
readers, ``stage_ms(stage)`` and ``completed_results()``.
"""

import os

import numpy as np

from benchlib import check, traffic
from benchlib.fixtures import build_models
from benchlib.tracing import Timer

LEVEL_ENV = ("AAT_FAST", "AAT_PALLAS", "AAT_PALLAS_ALG", "AAT_KERAS_BF16", "AAT_WIRE_CODEC",
             "AAT_TIMINGS")


def seed_of(seed, *path):
    return int(np.random.SeedSequence([seed, *path]).generate_state(1)[0])


class Serving:
    cli = False

    def __init__(self, cell, seed, device, workdir, trace):
        self.cell, self.seed, self.device = cell, seed, device
        self.mix = cell.mix
        for k in LEVEL_ENV:
            os.environ.pop(k, None)
        os.environ.update(self.mix.get("env", {}))
        rec = self.mix["recording"]
        self.sr = int(rec["sr"])
        self.pool = traffic.make_pool(rec, int(self.mix["pool"]), seed)
        pool_dir = workdir / "pool"
        pool_dir.mkdir(parents=True, exist_ok=True)
        self.files = [traffic.write_wav(pool_dir / f"rec{i:03d}.wav", pcm, self.sr)
                      for i, pcm in enumerate(self.pool)]
        made = build_models(cell.config, cell.root, workdir / "models", seed, device, self.pool[0])
        self.model_dirs = [str(d) for d, _ in made]
        self.ref_models = [m for _, m in made]
        self.timer = Timer()
        self.profile = None

    def sample_ids(self, n_done):
        k = min(int(self.mix["check"]["recordings"]), n_done)
        rng = np.random.default_rng(seed_of(self.seed, 7))
        return sorted(rng.choice(n_done, size=k, replace=False).tolist())

    def judge(self):
        samples = self.samples()
        self.release()
        check.free_device()
        return check.judge(samples, self.ref_models, self.device, cli=self.cli)
