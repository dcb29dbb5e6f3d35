"""Spectral signal detection and the end-of-data scan
(the JAX package's detect/signal_noise.py, its fused detect program;
reference src/identify_tracks.py:650-706, 387-413).

For each recording of a [B, T] batch, on the device:

1. end-scan: the 120-mel, power-1 spectrogram (n_fft = sr//10) of every
   whole frame, through the frontend level's DFT -> mel kernel
   (``stft_mel``, or ``stft_mel_bf16`` at the fast level); a ~1 s chunk
   whose max equals its min marks the end of the data;
2. samples past that end are zeroed and the |STFT| (n_fft 4096, hop 281)
   runs through the ``stft_mag`` kernel;
3. the spectrogram is divided by its max over the valid frames, and the
   row and column medians come from the ``row_medians``/``col_medians``
   kernels (exactly np.median);
4. threshold at 3x both medians; the mask is packed into 32-bit words
   (most significant bit first), and the morphology runs on the words
   (``ops/morphology.py::packed_erode``/``packed_dilate``), with the
   invalid region (frames past the data end) set to each operation's
   identity between stages, as OpenCV sees the truncated recording.

The words go to the host once, as they are, where the native CCL labels
them. ``detect_batch_dispatch`` queues all of that for a batch, the copies
included, without waiting for the device: on a CUDA device the copies go
through pinned host memory, asynchronously, and an event marks their end.
``detect_batch_finish`` waits for that event only, so work queued after
the dispatch (the next batch) does not hold it, and labels each recording
in a host thread.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from audio_analysis_torch.detect.signal import Signal, SIGNAL_WIDTH
from audio_analysis_torch.device import to_device_async, to_host_async
from audio_analysis_torch.ops.components import connected_components_with_stats_packed
from audio_analysis_torch.ops.mel import fft_frequencies
from audio_analysis_torch.ops.medians import masked_medians_rowcol
from audio_analysis_torch.ops.melspec import stft_frames, stft_mag
from audio_analysis_torch.ops.morphology import dilate, erode, packed_dilate, packed_erode
from audio_analysis_torch.pipeline.frontend import dft_mel, frontend_level
from audio_analysis_torch.utils.profiling import span

ENDSCAN_MELS = 120


def _to_float(frames: torch.Tensor) -> torch.Tensor:
    """int16 PCM -> float32 in [-1, 1) (the 16-bit decode scaling,
    reference src/common.py:92); float input passes through as float32."""
    if frames.dtype == torch.int16:
        return frames.to(torch.float32) / 32768.0
    return frames.to(torch.float32)


def _mask_height_width(sr, hop_length, n_fft):
    """Structuring-element sizes: width = SIGNAL_WIDTH in frames; height =
    1 + the first bin above 100 Hz (reference :656, 675-681)."""
    width = int(SIGNAL_WIDTH * sr / hop_length)
    height = 0
    for i, f in enumerate(fft_frequencies(sr, n_fft)):
        if f > 100:
            height = i + 1
            break
    return height, width


def _batch_chunk_flatness(framesf, *, sr, hop_length, level=None):
    """[B, T] float PCM -> per-chunk (max, min) [B, C] of the 120-mel
    power-1 end-scan spectrogram (reference src/identify_tracks.py:387-413).

    Only the chunk decision max == min is consumed, and every faithful DFT
    agrees on it: digital silence is exactly zero at either level, and
    nonzero input puts unequal energy in different bins, so the ``fast``
    level (None resolves the frontend level now) gives the same decisions
    as ``exact``."""
    b, t = framesf.shape
    chunk = sr // hop_length
    n_chunks = (1 + t // hop_length) // chunk
    if n_chunks == 0:
        # shorter than one chunk: a never-"checkable" sentinel (mx != mn)
        return (
            torch.zeros((b, 1), device=framesf.device),
            torch.ones((b, 1), device=framesf.device),
        )
    mel = dft_mel(frontend_level() if level is None else level)(
        framesf, sr=sr, n_fft=sr // 10, hop_length=hop_length, n_mels=ENDSCAN_MELS,
        fmin=50.0, fmax=11000.0, break_freq=1750.0, power=1.0, htk=True,
        frames=n_chunks * chunk,
    )
    usable = mel.reshape(b, ENDSCAN_MELS, n_chunks, chunk)
    return usable.amax(dim=(1, 3)), usable.amin(dim=(1, 3))


def _endscan_decision(n_valid, mx, mn, *, sr, hop_length):
    """Per recording: (found, flat_sec, mask_valid samples) from the
    per-chunk flatness; mask_valid is the detected data end."""
    chunk = sr // hop_length
    n_frames_valid = 1 + n_valid // hop_length  # [B]
    k = torch.arange(mx.shape[1], device=mx.device)
    checkable = (k[None, :] + 1) * chunk < n_frames_valid[:, None]
    flat = (mx == mn) & checkable
    found = flat.any(dim=1)
    first = flat.to(torch.int32).argmax(dim=1)  # first True (0 if none)
    flat_sec = (first * chunk * hop_length) // sr
    mask_valid = torch.where(found, sr * flat_sec, n_valid)
    return found, flat_sec, mask_valid


def _threshold(spec, row_medians, column_medians, col_valid):
    """[B, bins, F] bool: above 3x both medians, in the valid frames."""
    return (spec > 3 * column_medians) & (spec > 3 * row_medians) & col_valid[:, None, :]


def _mask_threshold_morph(spec, row_medians, column_medians, col_valid, *, sr,
                          hop_length, n_fft):
    """Median thresholds -> morphology over [B, bins, F] on packed words;
    `spec` is the a_max-normalised magnitude, col_valid [B, F]. Returns the
    mask as int32 words [B, bins, ceil(F/32)], most significant bit first,
    the pad bits past F zero (the JAX package's packed mask)."""
    u = pack_words(_threshold(spec, row_medians, column_medians, col_valid))
    cv = pack_words(col_valid)[:, None, :]  # [B, 1, W]; pad bits 0
    inv = ~cv  # invalid columns and pad bits
    height, width = _mask_height_width(sr, hop_length, n_fft)
    # MORPH_OPEN 4x4 == erode then dilate
    u = packed_erode(u | inv, 4, 4)
    u = packed_dilate(u & cv, 4, 4)
    u = packed_dilate(u & cv, height, width)
    u = packed_erode(u | inv, height // 10, width)
    return u & cv


def mask_threshold_morph_plain(spec, row_medians, column_medians, col_valid, *, sr,
                               hop_length, n_fft):
    """The plain version of ``_mask_threshold_morph``: the same stages as
    float 0/1 max-pools (``ops/morphology.py::dilate``/``erode``). Returns
    the [B, bins, F] bool mask."""
    cv = col_valid[:, None, :].to(spec.dtype)
    inv = 1.0 - cv
    mask = _threshold(spec, row_medians, column_medians, col_valid).to(spec.dtype)
    height, width = _mask_height_width(sr, hop_length, n_fft)
    u = erode(torch.maximum(mask, inv), 4, 4)
    u = dilate(u * cv, 4, 4)
    u = dilate(u * cv, height, width)
    u = erode(torch.maximum(u, inv), height // 10, width)
    return (u * cv) > 0.5


def detect_batch_mask(frames, n_valid, *, sr, hop_length=281, n_fft=4096, level=None):
    """[B, T] PCM (int16 or float) + valid lengths [B] -> (found [B],
    flat_sec [B], mask [B, bins, ceil(F/32)] int32 words, most significant
    bit first), all on the frames' device.
    ``level`` is the end-scan's frontend level (None: resolved now); the
    |STFT| and the medians are exact at every level."""
    with span("detect.endscan"):
        framesf = _to_float(frames)
        n_valid = to_device_async(torch.as_tensor(np.asarray(n_valid, np.int64)), framesf.device)
        mx, mn = _batch_chunk_flatness(framesf, sr=sr, hop_length=hop_length, level=level)
        found, flat_sec, mask_valid = _endscan_decision(
            n_valid, mx, mn, sr=sr, hop_length=hop_length
        )
    with span("detect.stft_mag"):
        idx = torch.arange(framesf.shape[1], device=framesf.device)
        fz = torch.where(idx[None, :] < mask_valid[:, None], framesf, 0.0).contiguous()
        spec = stft_mag(fz, n_fft=n_fft, hop_length=hop_length, power=1.0)
    with span("detect.medians"):
        nvf = 1 + mask_valid // hop_length  # valid frames [B]
        col_valid = torch.arange(spec.shape[-1], device=spec.device)[None, :] < nvf[:, None]
        a_max = torch.where(col_valid[:, None, :], spec, 0.0).amax(dim=(1, 2), keepdim=True)
        spec_n = spec / a_max
        row_m, col_m = masked_medians_rowcol(spec_n, nvf)
    with span("detect.morph"):
        mask = _mask_threshold_morph(
            spec_n, row_m, col_m, col_valid, sr=sr, hop_length=hop_length, n_fft=n_fft
        )
    return found, flat_sec, mask


def pack_words(mask: torch.Tensor) -> torch.Tensor:
    """[..., C] bool -> [..., ceil(C/32)] int32 words, bit 31 of word j the
    column 32 j (the JAX package's packed mask), the pad bits zero. The
    bits are disjoint, so their sum is their OR (bit 31 wraps to the sign);
    the bool mask times each bit's weight makes the one int32 intermediate."""
    c = mask.shape[-1]
    n = -(-c // 32)
    bits = F.pad(mask, (0, 32 * n - c)).reshape(mask.shape[:-1] + (n, 32))
    weights = 1 << torch.arange(31, -1, -1, dtype=torch.int32, device=mask.device)
    return (bits * weights).sum(dim=-1, dtype=torch.int32)


def detect_batch_dispatch(frames, n_valid, sr, hop_length=281, n_fft=4096, level=None):
    """Queue detection for a [B, T] batch of int16 or float PCM on the
    device (``n_valid`` [B] valid samples per recording): the end-scan, the
    masks as words and the words' copy to the host. Returns a handle
    without waiting for the device."""
    with span("detect.enqueue"):
        n_valid = np.asarray(n_valid, dtype=np.int64).reshape(-1)
        found, flat_sec, words = detect_batch_mask(
            frames, n_valid, sr=sr, hop_length=hop_length, n_fft=n_fft, level=level,
        )
        width = stft_frames(frames.shape[-1], n_fft, hop_length)
        host = [to_host_async(x) for x in (found, flat_sec, words)]
        copied = None
        if frames.device.type == "cuda":
            copied = torch.cuda.Event()
            copied.record(torch.cuda.current_stream(frames.device))
    return host, copied, width, n_valid, sr, hop_length, n_fft


def detect_batch_finish(handle):
    """[(length_seconds, signals), ...] for a dispatched batch: wait for its
    copy of the mask words to the host, then run the native CCL of each
    recording's words in a host thread (the C++ labelling releases the GIL)."""
    host, copied, width, n_valid, sr, hop_length, n_fft = handle
    with span("detect.wait"):
        if copied is not None:
            copied.synchronize()
        found, flat_sec, words = (x.numpy() for x in host)
    b = len(n_valid)

    def one(i):
        stats = connected_components_with_stats_packed(words[i], width)
        return _signals_from_stats(stats, sr, hop_length, n_fft)

    with span("detect.ccl"), ThreadPoolExecutor(max_workers=max(1, min(8, b))) as ex:
        signals = list(ex.map(one, range(b)))
    return [
        (int(flat_sec[i]) if found[i] else float(n_valid[i]) / sr, signals[i])
        for i in range(b)
    ]


def detect(frames, sr, n_valid_samples=None, hop_length=281, n_fft=4096, level=None):
    """(length_seconds, signals) for one recording: a [T] tensor of int16
    or float PCM on the device detection should run on; a batch of one
    through ``detect_batch_dispatch`` and ``detect_batch_finish``.

    Equivalent to the reference sequence length = get_end(...);
    signals = signal_noise(frames[:int(sr*length)])."""
    if n_valid_samples is None:
        n_valid_samples = frames.shape[0]
    return detect_batch_finish(detect_batch_dispatch(
        frames[None], [n_valid_samples], sr, hop_length=hop_length, n_fft=n_fft, level=level
    ))[0]


def _signals_from_stats(stats, sr, hop_length, n_fft):
    stats = sorted(stats.tolist(), key=lambda stat: stat[0])
    height, width = _mask_height_width(sr, hop_length, n_fft)
    freqs = fft_frequencies(sr, n_fft)
    min_width = 0.65 * width
    min_height = height - height // 10
    stats = [s for s in stats if s[2] > min_width and s[3] > min_height]
    signals = []
    for s in stats:
        max_freq = min(len(freqs) - 1, s[1] + s[3])
        freq_range = (freqs[s[1]], freqs[max_freq])
        start = s[0] * hop_length / sr
        end = (s[0] + s[2]) * hop_length / sr
        signals.append(Signal(start, end, freq_range[0], freq_range[1]))
    return signals

