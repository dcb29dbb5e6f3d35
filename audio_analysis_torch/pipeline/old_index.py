"""Legacy cacophony index (DCT band energy), the JAX package's
pipeline/old_index.py.

Reference algorithm (src/cacophony_index.py:53-125): 16 kHz audio,
2048-point Hanning windows every 1024 samples, DCT-II per window, 10
log-spaced band energies above a 100 Hz bass cut, points = bands halved +
bands doubled against the previous window, scored over ~20 s bins through
a correction curve.

Every window's DCT, band energies and comparison with the window before run
as tensor operations on the device (``points``); only the points vector
comes back for the table assembly, which is plain Python (copied as it is).
"""

import math

import numpy as np
import torch

from audio_analysis_torch.device import resolve_device
from audio_analysis_torch.io.audio import load_audio_mono
from audio_analysis_torch.ops.dct import dct2
from audio_analysis_torch.ops.resample import resample
from audio_analysis_torch.ops.windows import get_window

SAMPLE_RATE = 16000
WINDOW_SIZE = 2048


def get_ci_bins_edges(window_size: int, sample_rate: int) -> np.ndarray:
    """Log-spaced band edges with the 100 Hz bass cut
    (reference: src/cacophony_index.py:58-63)."""
    bass_cut_off_band = 100 * 2 * window_size // sample_rate
    return np.logspace(
        math.log10(bass_cut_off_band), math.log10(window_size), num=11, dtype=int
    )


def n_windows(n_samples: int, half_window: int) -> int:
    """Windows at offsets half_window, 2 half_window, ... while the offset
    is below n_samples - 3 half_window (reference :84)."""
    return max((n_samples - half_window * 3 - half_window - 1) // half_window + 1, 0)


def points(audio: torch.Tensor, *, window_size=WINDOW_SIZE, half_window=WINDOW_SIZE // 2,
           sample_rate=SAMPLE_RATE) -> torch.Tensor:
    """[n] float32 audio on its device -> the [n_windows - 1] change points
    (the JAX package's ``_points_program``)."""
    nw = n_windows(audio.shape[0], half_window)
    frames = audio[half_window:].unfold(0, window_size, half_window)[:nw]  # [W, window]
    w = get_window("hanning", window_size, periodic=False, device=audio.device)
    d = dct2(frames * w)
    edges = torch.from_numpy(get_ci_bins_edges(window_size, sample_rate)).to(audio.device)
    # 10 band energies: sums of squares between consecutive edges
    e2 = d * d
    csum = torch.nn.functional.pad(torch.cumsum(e2, dim=1), (1, 0))
    bins = csum[:, edges[1:]] - csum[:, edges[:-1]]  # [W, 10]
    prev, cur = bins[:-1], bins[1:]
    return (cur * 2 < prev).sum(dim=1) + (cur > prev * 2).sum(dim=1)


def score_from_points(points):
    """10x mean of the sorted 75th-95th percentile slice
    (reference: src/cacophony_index.py:69-73)."""
    points_sorted = sorted(points)
    k0 = int(len(points) * 0.75)
    k1 = int(len(points) * 0.95)
    return 10 * np.mean(points_sorted[k0:k1])


def apply_correction_curve_202001C(raw_score):
    s = raw_score - 10
    return max(100 * s / (s + 18), 0)


def table_from_points(points, sample_rate=SAMPLE_RATE, half_window_size=WINDOW_SIZE // 2):
    """~20 s overlapping table entries over the points vector
    (reference: src/cacophony_index.py:99-114): entry starts interpolate
    linearly so the last entry ends exactly at the final point; begin/end
    round with Python round (banker's on .5)."""
    bin_20_width = 312  # ~20 seconds
    table = []
    entry_count = (len(points) + 31) // bin_20_width
    for e in range(entry_count):
        q = 0
        if e:
            q = e * (len(points) - bin_20_width) // (entry_count - 1)
        raw_score = score_from_points(points[q : q + bin_20_width])
        score = apply_correction_curve_202001C(raw_score)
        table.append(
            {
                "begin_s": round(q * half_window_size / sample_rate),
                "end_s": round((q + bin_20_width) * half_window_size / sample_rate),
                "index_percent": round(score, 1),
            }
        )
    return table


def calculate_from_frames(source_data, sample_rate=SAMPLE_RATE, device=None):
    """The result dict for mono PCM at `sample_rate` (numpy, or a tensor,
    which stays on its device; numpy goes to `device`, None: the card)."""
    half_window_size = WINDOW_SIZE // 2
    if isinstance(source_data, torch.Tensor):
        audio = source_data.to(torch.float32)
    else:
        audio = torch.from_numpy(np.asarray(source_data, np.float32)).to(resolve_device(device))
    if n_windows(audio.shape[0], half_window_size) >= 2:
        pts = points(audio, window_size=WINDOW_SIZE, half_window=half_window_size,
                     sample_rate=sample_rate).cpu().tolist()
    else:
        pts = []

    table = table_from_points(pts, sample_rate, half_window_size)

    result = {
        "cacophony_index_old": table,
        "cacophony_index_old_version": "2020-01-20_A",
    }
    if table == []:
        p = source_data.shape[0] / sample_rate
        result["ci_warning"] = (
            "Cacophony Index requires at least 20 seconds of audio, but only"
            " %d seconds of audio were provided." % p
        )
    return result


def calculate(source_file_name, device=None):
    """Reference entry (src/cacophony_index.py:81-125): decode, resample to
    16 kHz on `device` (None: the card), then ``calculate_from_frames``."""
    frames, sr = load_audio_mono(source_file_name)
    audio = torch.from_numpy(frames).to(resolve_device(device))
    return calculate_from_frames(resample(audio, sr, SAMPLE_RATE), SAMPLE_RATE)
