"""The whole window's share of the card's peak: the FLOPs the work
completed in the window needs (detection's |STFT| and end-scan mel, the
classify frontend and every model's forward over the windows their tracks
imply, counted from shapes by benchlib/counts.py) over the window's
seconds, against the peak of the classifiers' compute dtype at the cell's
level (bfloat16 under AAT_FAST, else float32 with TF32 off), in %."""

from benchlib.counts import result_flops

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # H100 SXM dense (NVIDIA's data sheet)


def read(run):
    dtype = "bfloat16" if run.mix.get("env", {}).get("AAT_FAST") == "1" else "float32"
    flops = sum(result_flops(r, samples, run.cell.config) for r, samples in run.completed_results())
    return 100.0 * flops / run.window_s / PEAK_FLOPS[dtype]
