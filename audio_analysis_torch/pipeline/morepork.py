"""The legacy morepork (ruru) detector (the JAX package's
pipeline/morepork.py; reference src/identify_morepork.py).

|STFT| at n_fft = sr/10 (the recording's own rate), hop n_fft/2, cropped to
the 600-1200 Hz bins; 3 s / 60-slice samples every 1 s, each scaled by
amplitude_to_db(ref=max) and a min-shift; every ensemble member's sigmoid
activations summed on the host and thresholded at 1.0; then the reference's
span heuristics. The spectrogram and the samples are made on the tensor's
device (``torch.fft`` in float32, the counterpart of the JAX package's XLA
rfft), each member runs one batched forward over all samples.

Ensemble members are dirs under the model dir that hold ``saved_model.pb``
(``model_paths``). A member runs from its ``weights.npz`` (TuiNet, sigmoid
output unless its metadata says otherwise), a ``.keras`` archive beside it,
or the SavedModel itself, converted and cached by ``io/convert.py`` (a
current cache loads without tensorflow); a SavedModel that is not a Keras
model runs through TF on the host (``HostSavedModel``).
"""

import os
from pathlib import Path

import numpy as np
import torch

from audio_analysis_torch.device import resolve_device
from audio_analysis_torch.io.audio import load_audio_mono
from audio_analysis_torch.io.convert import (
    ConversionError,
    HostSavedModel,
    auto_convert_saved_model,
)
from audio_analysis_torch.io.modelconfig import ModelConfig
from audio_analysis_torch.models.registry import load_classifier
from audio_analysis_torch.ops.stft import stft_magnitude

frequency_min = 600
frequency_max = 1200
slices_per_second = 20
seconds_per_sample = 3.0
slices_per_sample = int(slices_per_second * seconds_per_sample)  # 60
sample_slide_seconds = 1.0
sample_slide_slices = int(sample_slide_seconds * slices_per_second)  # 20
activation_threshold = 1.0
model_file_name = "saved_model.pb"


def _spectrogram_program(frames: torch.Tensor, *, sr: int) -> torch.Tensor:
    """|STFT| cropped to the 600-1200 Hz band (reference :19-27), on the
    frames' device: [60, n_slices] float32."""
    nfft = int(sr / 10)
    spec = stft_magnitude(frames, nfft, int(nfft / 2))
    return spec[int(frequency_min / 10) : int(frequency_max / 10)]


def _sample_grid(n_slices: int):
    """Sample placement with exact Python-slice semantics, including the
    reference's negative-start behaviour on sub-3 s recordings
    (src/identify_morepork.py:144-166: start = limit - 60 may go negative,
    and numpy then slices from n+start)."""
    lows, lengths, start_times = [], [], []
    for base in range(0, n_slices, sample_slide_slices):
        limit = min(base + slices_per_sample, n_slices)
        start = limit - slices_per_sample
        start_times.append(start / slices_per_second)
        if start < 0:
            lo = max(n_slices + start, 0)  # numpy negative-index slicing
        else:
            lo = start
        lows.append(lo)
        lengths.append(max(limit - lo, 0))
    return (
        np.asarray(lows, np.int32),
        np.asarray(lengths, np.int32),
        start_times,
    )


def _samples_program(npspec: torch.Tensor, lows: torch.Tensor, lengths: torch.Tensor):
    """The samples [N, 60 bins, 60 slices, 1] from the cropped spectrogram
    and the grid, on the spectrogram's device."""
    steps = torch.arange(slices_per_sample, device=npspec.device)
    idx = (lows.long()[:, None] + steps[None, :]).clamp(0, npspec.shape[1] - 1)
    samples = npspec[:, idx].permute(1, 0, 2)  # [N, bins, 60]
    valid = (steps[None, :] < lengths.long()[:, None])[:, None, :]
    # mask BEFORE dB so padded cells do not affect the per-sample max; the
    # reference pads with zeros after dB, so re-zero padded cells after.
    samples = torch.where(valid, samples, 0.0)
    # amplitude_to_db(ref=max) over the valid region only (reference :152)
    ref = torch.where(valid, samples, -torch.inf).amax(dim=(-2, -1), keepdim=True)
    amin = 1e-5
    db = 20.0 * torch.log10(torch.clamp(samples, min=amin))
    db = db - 20.0 * torch.log10(torch.clamp(ref, min=amin))
    peak = torch.where(valid, db, -torch.inf).amax(dim=(-2, -1), keepdim=True)
    db = torch.maximum(db, peak - 80.0)
    # min-shift (reference :153-154), computed over the valid region
    mn = torch.where(valid, db, torch.inf).amin(dim=(-2, -1), keepdim=True)
    db = torch.where(mn != 0, db / mn.abs() + 1.0, db)
    db = torch.where(valid, db, 0.0)  # zero pad region (:155-165)
    return db[..., None]


def model_paths(basepath):
    """Recursively find SavedModel dirs (reference :30-39)."""
    pathlist = []
    for name in sorted(os.listdir(basepath)):
        namepath = os.path.join(basepath, name)
        if os.path.isdir(namepath):
            pathlist += model_paths(namepath)
        elif namepath.endswith(model_file_name):
            pathlist.append(basepath)
    return pathlist


def _load_morepork_model(path, device):
    """One ensemble member on `device`: a native checkpoint dir
    (weights.npz) through the registry, a .keras archive, or a TF SavedModel
    (converted and cached, or run through TF on the host when it is not a
    Keras model; both need tensorflow unless the cache is current).

    Morepork heads are binary activations, not softmax classifiers
    (reference models end in sigmoid and are thresholded on the SUM of
    activations, src/identify_morepork.py:169-183): native checkpoints
    default to a sigmoid output unless metadata says otherwise."""
    p = Path(path)
    if not ((p / "weights.npz").exists() or list(p.glob("*.keras"))):
        # the reference's input format: a TF SavedModel dir per member
        # (src/identify_morepork.py:169-176)
        try:
            p = auto_convert_saved_model(p)
        except ConversionError:
            try:
                return HostSavedModel(p)
            except ImportError:
                raise RuntimeError(
                    f"morepork model at {path} is a TF SavedModel; converting "
                    "or running it requires tensorflow (+ tf_keras), or "
                    "pre-convert offline with tools/convert_model.py"
                )
    try:
        cfg = ModelConfig.load(p)
    except FileNotFoundError:
        cfg = ModelConfig.from_meta({}, p)
    if (p / "weights.npz").exists():
        cfg.raw.setdefault("output_activation", "sigmoid")
    return load_classifier(p, cfg, device)


def _find_likely_span(liklihoods, start_times, first, last):
    """Span heuristics for consecutive positive samples
    (reference: src/identify_morepork.py:42-120), behaviour-identical."""
    count = last - first
    first_start_time = start_times[first]
    last_end_time = start_times[last] + seconds_per_sample
    if count == 0:
        return liklihoods[first], first_start_time, last_end_time
    elif count == 1:
        liklihood = max(liklihoods[first], liklihoods[last])
        return (
            liklihood,
            first_start_time + sample_slide_seconds,
            first_start_time + seconds_per_sample,
        )
    elif count == 2:
        max_liklihood = max(liklihoods[first : last + 1])
        min_liklihood = min(liklihoods[first : last + 1])
        if max_liklihood == liklihoods[first + 1]:
            return (
                max_liklihood,
                start_times[first + 1],
                start_times[first + 1] + seconds_per_sample,
            )
        elif min_liklihood == liklihoods[first]:
            return max_liklihood, start_times[first + 1], last_end_time
        elif min_liklihood == liklihoods[last]:
            return (
                max_liklihood,
                first_start_time,
                start_times[first + 1] + seconds_per_sample,
            )
        else:
            return max_liklihood, first_start_time, last_end_time
    else:
        max_liklihood = max(liklihoods[first : last + 1])
        if max_liklihood > liklihoods[first]:
            if max_liklihood > liklihoods[last]:
                return (
                    max_liklihood,
                    start_times[first + 1],
                    start_times[last - 1] + seconds_per_sample,
                )
            else:
                return max_liklihood, start_times[first + 1], last_end_time
        elif max_liklihood > liklihoods[last]:
            return (
                max_liklihood,
                first_start_time,
                start_times[last - 1] + seconds_per_sample,
            )
        else:
            return max_liklihood, first_start_time, last_end_time


def build_entry(begin, end, species, activation):
    return {
        "begin_s": begin,
        "end_s": end,
        "freq_start": frequency_min,
        "freq_end": frequency_max,
        "predictions": [
            {
                "species": [species],
                "likelihood": [round(activation * 0.01, 2)],
                "model": "morepork",
            }
        ],
    }


def identify_morepork(recording, models, device=None):
    """Reference entry (src/identify_morepork.py:137-200): decode at the
    recording's own rate, then ``identify_morepork_frames``."""
    frames, sr = load_audio_mono(recording)
    return identify_morepork_frames(frames, sr, models, device=device)


def labels_from_activations(activations_sum, start_times, n_models):
    """Group consecutive over-threshold samples into span labels
    (reference label loop, src/identify_morepork.py:175-199): the threshold
    tests the RAW summed activations while the span heuristics see the
    ensemble-mean percentages rounded to ints (:177)."""
    labels = []
    liklihoods = [round(v * 100 / n_models) for v in activations_sum]
    first_index = -1
    last_index = -1
    for i in range(len(activations_sum)):
        if activations_sum[i] >= activation_threshold:
            if first_index < 0:
                first_index = i
            last_index = i
        elif first_index >= 0:
            liklihood, start_time, end_time = _find_likely_span(
                liklihoods, start_times, first_index, last_index
            )
            labels.append(build_entry(start_time, end_time, "morepork", liklihood))
            first_index = -1
    if first_index >= 0:
        liklihood, start_time, end_time = _find_likely_span(
            liklihoods, start_times, first_index, last_index
        )
        labels.append(build_entry(start_time, end_time, "morepork", liklihood))
    return labels


@torch.inference_mode()
def identify_morepork_frames(frames, sr, models, device=None):
    """Span labels of mono PCM `frames` at `sr` Hz, with the ensemble under
    the dir `models` (or a list of member dirs), on `device` (None: the
    card)."""
    dev = resolve_device(device)
    x = torch.from_numpy(np.ascontiguousarray(frames)).to(dev, torch.float32)
    npspec = _spectrogram_program(x, sr=sr)
    lows, lengths, start_times = _sample_grid(int(npspec.shape[1]))
    samples = _samples_program(npspec, torch.from_numpy(lows).to(dev),
                               torch.from_numpy(lengths).to(dev))

    paths = model_paths(models) if isinstance(models, (str, os.PathLike)) else list(models)
    # each member's float32 activations come to the host and add into a
    # float64 sum in member order, as the JAX package sums them: the
    # threshold and round() read that sum
    activations_sum = np.zeros(samples.shape[0])
    for path in paths:
        model = _load_morepork_model(path, dev)
        activations_sum += model(samples).cpu().numpy().flatten()

    return labels_from_activations(activations_sum, start_times, len(paths))
