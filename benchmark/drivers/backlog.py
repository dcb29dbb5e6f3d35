"""A closed backlog through ``BatchAnalyzer.analyse_stream``, fed as
``cli/batch.py::run`` feeds it, each recording decoded by
``load_recording(prefer_int16=True)``; the stream pulls its next batch as
soon as it wants one. End to end: ``audio_s_per_s``.

The pool is decoded in set-up, not in the window: on an H100 host whose
file system is remote (9p), the decode took 26-41 ms of a 60-100 ms batch
and spread the throughput of one seed by +-11% from run to run. The window
plan runs with ``rng=None`` (offset-0 placement: the same windows in
number as any draw).
"""

import time

from benchlib.check import ProbCapture
from benchlib.serving import Serving
from benchlib.tracing import Timer, profile_stretch
from benchref.analyse import groups_of


class Driver(Serving):
    def __init__(self, cell, seed, device, workdir, trace):
        super().__init__(cell, seed, device, workdir, trace)
        from audio_analysis_torch.io.audio import load_recording
        from audio_analysis_torch.pipeline import serve

        self.batch = int(self.mix["batch"])
        self.analyzer = serve.BatchAnalyzer(self.model_dirs, sr=self.sr, rng=None, device=device)
        self.capture = ProbCapture(serve)
        self.decoded = [load_recording(f, resample=self.sr, prefer_int16=True,
                                       device=self.analyzer.device)[0] for f in self.files]
        self.analyzer.prewarm(batch_size=self.batch)
        # every batch the window sends, once: the pool is cycled in order
        for _ in self._stream(Timer(), len(self.files) // self.batch):
            pass

    def _batches(self, deadline=None, count=None, start=0):
        i = start
        while (count is None or i - start < count) and (deadline is None
                                                          or time.perf_counter() < deadline):
            ids = [(i * self.batch + j) % len(self.files) for j in range(self.batch)]
            self.fed.append(ids)
            yield [self.decoded[k] for k in ids]
            i += 1

    def _stream(self, timer, count=None, deadline=None, start=0):
        self.fed = []
        for results in self.analyzer.analyse_stream(self._batches(deadline, count, start),
                                                    timer=timer):
            yield results

    def window(self, seconds):
        self.done = []  # (file ids, results, captured calls, completion time)
        with self.capture:
            t0 = time.perf_counter()
            deadline = t0 + seconds
            k = 0
            for results in self._stream(self.timer, deadline=deadline):
                t = time.perf_counter()
                self.done.append((self.fed[k], results, self.capture.take(), t))
                k += 1
        self.window_s = seconds
        self.completed = [d for d in self.done if d[3] <= deadline]
        self.attempted = sum(len(d[1]) for d in self.done)
        audio = sum(r["duration"] for d in self.completed for r in d[1])
        self.next_batch = k
        return {"audio_s_per_s": audio / seconds}

    def stretch(self, units):
        timer = Timer()
        self.profile = profile_stretch(
            lambda: [None for _ in self._stream(timer, count=units, start=self.next_batch)],
            timer, units)

    def stage_ms(self, stage):
        """Mean host ms a batch of the window spent in the stream's `stage`."""
        return self.timer.mean_ms(stage)

    def release(self):
        del self.analyzer

    def samples(self):
        flat = [(ids[b], results[b], calls, b) for ids, results, calls, _ in self.completed
                for b in range(len(results))]
        groups = len(groups_of(self.ref_models))
        out = []
        for i in self.sample_ids(len(flat)):
            fid, result, calls, b = flat[i]
            mine = [calls[g * self.batch + b] for g in range(groups)] if calls else []
            out.append({"pcm": self.pool[fid], "result": result, "groups": mine, "rng": None})
        return out

    def completed_results(self):
        return [(r, len(self.pool[ids[b]])) for ids, results, _, _ in self.completed
                for b, r in enumerate(results)]
