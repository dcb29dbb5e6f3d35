#!/usr/bin/env python3
"""The parts of the direct bf16 route's time on one GPU: its pre-pass and
its GEMM, at the shapes that chip_smoke.py holds it to.

    python3 chip_direct_breakdown.py

The direct route (``csrc/stft_bf16.cu``) launches two kernels a call: the
pre-pass ``direct_frames_kernel``, which writes P = 8 / gcd(hop, 8) bf16
copies of each window into a scratch tensor, and the GEMM
``stft_mel_bf16_kernel``. For each shape (the n_fft-4410 and n_fft-4096
classify grids [64, 144000] at hop 640, the batch end-scan [8, 2880000] at
n_fft 4800 and hop 281, and n_fft 500 on [16, 16000] at hop 125) this
script calls ``stft_mel_bf16`` under ``AAT_PALLAS_ALG=matmul``, checks the
output against ``stft_mel_bf16_plain`` (max rel <= 1e-2), and prints one
JSON line: the time a call by CUDA events (10 calls after a warm-up), each
kernel's device time a call from torch.profiler over 10 more calls, and
the scratch's bytes. Then the card's name and power limit.
"""

import json
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_direct_breakdown: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from audio_analysis_torch.ops import melspec as ms

    os.environ["AAT_PALLAS_ALG"] = "matmul"
    dev = torch.device("cuda")
    y = torch.from_numpy(cs.make_recording()).to(dev)
    sr, t = cs.SR, y.shape[0]
    chunk = sr // 281
    n_keep = ((1 + t // 281) // chunk) * chunk
    grid = torch.stack([y[i * 24000: i * 24000 + 3 * sr] for i in range(64)]).contiguous()
    cls = dict(sr=sr, n_fft=4410, hop_length=640, n_mels=160, fmin=50.0, fmax=11000.0,
               break_freq=1750.0, power=2.0)
    shapes = {
        "classify nfft4410": (grid, cls),
        "classify nfft4096": (grid, dict(cls, n_fft=4096)),
        "batch end-scan": (torch.stack([y.roll(i * sr) for i in range(8)]).contiguous(),
                           dict(sr=sr, n_fft=4800, hop_length=281, n_mels=120, fmin=50.0,
                                fmax=11000.0, break_freq=1750.0, power=1.0, frames=n_keep)),
        "nfft500": (grid[:16, :16000].contiguous(),
                    dict(sr=16000, n_fft=500, hop_length=125, n_mels=40, fmin=50.0,
                         fmax=7000.0, break_freq=1750.0, power=2.0)),
    }
    for tag, (x, kw) in shapes.items():
        if ms.bf16_route(kw["n_fft"]) != "direct":
            raise AssertionError(f"{tag}: the direct route was not taken")
        got = ms.stft_mel_bf16(x, **kw)
        rel = cs.max_rel(got, ms.stft_mel_bf16_plain(x, **kw))
        if not rel <= 1e-2:
            raise AssertionError(f"{tag}: max rel {rel:.3g} (limit 1e-2)")
        n_out = got.shape[-1]
        _, lrow = ms.direct_tiles(n_out, kw["n_fft"], kw["hop_length"])
        scratch = x.shape[0] * ms.direct_classes(kw["hop_length"]) * lrow * 2
        event_ms = cs.time_ms(lambda x=x, kw=kw: ms.stft_mel_bf16(x, **kw), 10)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                ms.stft_mel_bf16(x, **kw)
            torch.cuda.synchronize()
        dev_ms = {}
        for e in prof.key_averages():
            for part, name in (("pre-pass", "direct_frames_kernel"),
                               ("gemm", "stft_mel_bf16_kernel")):
                if name in e.key:
                    dev_ms[part] = dev_ms.get(part, 0.0) + e.self_device_time_total / 1e4
        print(json.dumps({"shape": tag, "input": list(x.shape), "output": list(got.shape),
                          "max_rel": rel, "event_ms": event_ms,
                          "device_ms_per_call": dev_ms or "not measured",
                          "scratch_bytes": scratch}), flush=True)
    print(f"card: {cs.card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
