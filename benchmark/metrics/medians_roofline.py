"""The row and column medians kernels' share of their roofline, per unit
of work (a batch, a request) of the profiled stretch: the least time an
H100 could take to read the [B, 2049, frames] float32 spectrogram once for
each kernel and write their medians, at the HBM bandwidth (a selection
does no arithmetic worth a bound), over both kernels' device time. Left
out unless the stretch holds exactly one launch of each a unit."""

KERNELS = ("row_medians_kernel", "col_medians")
BINS, HOP = 2049, 281
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA's data sheet)


def bytes_moved(batch, samples):
    frames = 1 + samples // HOP
    return 2 * 4 * batch * BINS * frames + 4 * batch * (BINS + frames)


def read(run):
    p = run.profile
    counts = [p.kernel_time(k) for k in KERNELS]
    if any(n != p.units for n, _ in counts):
        return None
    device_s = sum(t for _, t in counts) / p.units
    rec = run.mix["recording"]
    nbytes = bytes_moved(int(run.mix.get("batch", 1)), int(rec["seconds"] * rec["sr"]))
    return 100.0 * nbytes / HBM_BYTES_PER_S / device_s if device_s > 0 else None
