"""One caller in a closed loop over ``cli/analyse.py::run`` in this
process, the sidecar written beside the WAV. End to end:
``latency_p50_ms`` and ``latency_p95_ms``, the median and the 95th
percentile over every request in the window. With
``--trace 1`` the program runs under ``AAT_TIMINGS=1``, so each result
carries its stage times. The window plan takes the CLI's ``--seed``.
"""

import os
import statistics
import time

import numpy as np

from benchlib.check import ProbCapture
from benchlib.serving import Serving, seed_of
from benchlib.tracing import Timer, profile_stretch


class Driver(Serving):
    cli = True

    def __init__(self, cell, seed, device, workdir, trace):
        super().__init__(cell, seed, device, workdir, trace)
        if trace:
            os.environ["AAT_TIMINGS"] = "1"
        from audio_analysis_torch.cli import analyse
        from audio_analysis_torch.pipeline import classify

        self.run_cli = analyse.run
        self.capture = ProbCapture(classify)
        self.cli_seed = seed_of(seed, 3) % (2 ** 31)
        for f in self.files:  # every recording once: shapes warm, sidecars written
            self._request(f)

    def _request(self, f):
        argv = [str(f), "--seed", str(self.cli_seed), "--device", self.device]
        for d in self.model_dirs:
            argv += ["--bird-model", d]
        return self.run_cli(argv)

    def window(self, seconds):
        self.done = []  # (file id, result, captured calls, latency s)
        with self.capture:
            t0 = time.perf_counter()
            i = 0
            while time.perf_counter() < t0 + seconds:
                fid = i % len(self.files)
                a = time.perf_counter()
                result = self._request(self.files[fid])
                lat = time.perf_counter() - a
                self.done.append((fid, result, self.capture.take(), lat))
                i += 1
        self.next_request = i
        self.window_s = seconds
        self.attempted = len(self.done)
        ms = [1e3 * d[3] for d in self.done]
        return {"latency_p50_ms": statistics.median(ms),
                "latency_p95_ms": float(np.percentile(ms, 95))}

    def stretch(self, units):
        timer = Timer()

        def requests():
            for i in range(units):
                with timer.span("request"):
                    self._request(self.files[(self.next_request + i) % len(self.files)])

        self.profile = profile_stretch(requests, timer, units)

    def stage_ms(self, stage):
        """Mean ms a request of the window spent in the CLI's `stage`: the
        result's ``timing`` (traced runs only)."""
        t = [r["timing"][stage] for r, _ in self.completed_results()
             if stage in r.get("timing", {})]
        return 1e3 * sum(t) / len(t) if t else None

    def release(self):
        pass

    def samples(self):
        return [{"pcm": self.pool[self.done[i][0]], "result": self.done[i][1],
                 "groups": self.done[i][2], "rng": self.cli_seed}
                for i in self.sample_ids(len(self.done))]

    def completed_results(self):
        return [(d[1], len(self.pool[d[0]])) for d in self.done]
