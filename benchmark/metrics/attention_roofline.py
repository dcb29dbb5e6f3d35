"""The attention kernels' share of their roofline over the profiled
stretch: the least time an H100 could take for the attention of the real
windows the stretch completed (its bucket padding left out, so the padding
shows as lost share), over the device time of every kernel that
``F.scaled_dot_product_attention`` launched. A layer-window of T tokens and
width D needs 4 T^2 D operations (q k^T and a v) at the bf16 peak, and
moves q, k, v and o once in bf16, 4 T D 2 bytes, at the HBM bandwidth; the
larger bounds it (the operations, at the AST's shapes). Kernels are matched
by name: on an H100 with torch 2.11 SDPA runs cuDNN's
``cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_knob_7_64x128x64_4x1x1_cga1x1x1_kernel0_0``,
one a layer; its other backends are PyTorch's flash kernel
(``pytorch_flash::flash_fwd_kernel``) and the memory-efficient one
(``fmha_cutlass...``); a later kernel with ``attn`` in its name is read too.
None where no such kernel ran or the stretch's recordings are not known.
"""

from benchlib.counts import windows_of
from benchref.ast import grid

KERNELS = ("flash", "fmha", "attn", "sdpa")
SR = 48000
PEAK_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12


def work(windows, tokens, dim, layers):
    """(operations, bytes) of the attention of `windows` windows."""
    n = windows * layers
    return n * 4 * tokens * tokens * dim, n * 4 * tokens * dim * 2


def stretch_windows(run):
    """Real windows of the recordings the stretch fed: each recording's
    result from the window (the same recording gives the same tracks)."""
    fed = getattr(run, "fed", None)
    if not fed:
        return None
    results = {}
    for ids, batch_results, _, _ in run.done:
        results.update(zip(ids, batch_results))
    ids = [i for batch in fed for i in batch]
    if any(i not in results for i in ids):
        return None
    return sum(windows_of(results[i], len(run.pool[i]), run.cell.config) for i in ids)


def read(run):
    p = run.profile
    device_s = sum(b - a for name, a, b in p.kernels
                   if any(k in name.lower() for k in KERNELS)) / 1e6
    windows = stretch_windows(run) if device_s > 0 else None
    if not windows:
        return None
    m = run.cell.config["models"][0]["metadata"]
    frames = 1 + int(m["segment_length"] * SR) // int(m["hop_length"])
    fg, tg = grid(int(m["n_mels"]), frames, int(m["net_patch"]), int(m["net_patch_stride"]))
    ops, nbytes = work(windows, fg * tg + 2, int(m["net_dim"]), int(m["net_depth"]))
    return 100.0 * max(ops / PEAK_FLOPS, nbytes / HBM_BYTES_PER_S) / device_s
