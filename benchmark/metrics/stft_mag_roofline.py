"""The detection |STFT| kernel's share of its roofline, per unit of work
(a batch, a request) of the profiled stretch: the least time an H100 could
take, the larger of the operations (2.5 n log2 n a real FFT frame, n 4096)
at the float64 peak of the CUDA cores, where the kernel does its FFT, and
the bytes (the PCM read once, the [B, 2049, frames] float32 magnitude
written once) at the HBM bandwidth, over the kernel's device time. At the
cells' shape the operations bound it. Left out unless the stretch holds
exactly one launch a unit."""

import math

KERNEL = "stft_mag_fft_kernel"
N_FFT, HOP = 4096, 281
PEAK_FLOPS = 34e12  # H100 SXM float64 on the CUDA cores, not the tensor cores (data sheet)
HBM_BYTES_PER_S = 3.35e12


def work(batch, samples):
    frames = 1 + samples // HOP
    ops = batch * frames * 2.5 * N_FFT * math.log2(N_FFT)
    return ops, 4 * batch * samples + 4 * batch * (N_FFT // 2 + 1) * frames


def read(run):
    p = run.profile
    n, device_s = p.kernel_time(KERNEL)
    if n != p.units or device_s <= 0:
        return None
    rec = run.mix["recording"]
    ops, nbytes = work(int(run.mix.get("batch", 1)), int(rec["seconds"] * rec["sr"]))
    return 100.0 * max(ops / PEAK_FLOPS, nbytes / HBM_BYTES_PER_S) / (device_s / n)
