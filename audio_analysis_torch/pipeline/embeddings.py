"""Embedding-model groups (``"name": "embeddings"`` configs; the JAX
package's pipeline/embeddings.py).

The reference embeds 5 s / 32 kHz windows of each track with Google's
bird-vocalization-classifier and classifies the embedding vectors with the
group's own models (reference src/identify_tracks.py:330-384, 498-499).
The embedder is named by the group's ``"embedding_model"`` metadata: a
``.keras`` archive (or a dir holding one), a SavedModel dir (converted and
cached by ``io/convert.py``, or run through TF on the host when it is not a
Keras model), or a native checkpoint dir
(``weights.npz``, e.g. a ``dense`` stack with ``net_pool``). Without one
the JAX package downloads the embedder from TF-Hub; the port does not (it
needs a network and tensorflow) and raises.

The PCM is resampled to 32 kHz on its device, the windows' starts are laid
out on the host exactly as the reference slices them, and the windows are
gathered on the device; every window of a recording is embedded in one
batched forward.
"""

import operator
from pathlib import Path

import torch

from audio_analysis_torch.io.convert import (
    ARCHIVE,
    ConversionError,
    HostSavedModel,
    auto_convert_saved_model,
)
from audio_analysis_torch.io.modelconfig import ModelConfig
from audio_analysis_torch.models.keras_graph import KerasModel
from audio_analysis_torch.models.registry import load_classifier
from audio_analysis_torch.ops.resample import resample

EMBED_SR = 32000

_EMBEDDER_CACHE = {}


def get_chirp_samples(rec_data: torch.Tensor, tracks, sr=EMBED_SR, stride=1, length=5):
    """Per-track fixed-length windows of `rec_data` [T] (reference
    src/identify_tracks.py:330-350): a track's first window starts at
    int(start * sr), the next ones every stride * sr samples, until a
    window ends past the track's end; a window running off the recording
    is zero-padded. Returns (windows [n_windows, length * sr] on
    rec_data's device, windows per track)."""
    sr_length = int(length * sr)
    sr_stride = stride * sr
    starts, counts = [], []
    for track in tracks:
        start = int(track.start * sr)
        count = 0
        while True:
            end = start + sr_length
            # the reference slices rec_data[start:end]: a start made float
            # by a fractional stride fails there, and fails here alike
            starts.append(operator.index(start))
            count += 1
            start += sr_stride
            if end / sr > track.end:
                break
        counts.append(count)
    dev = rec_data.device
    idx = (torch.tensor(starts, dtype=torch.int64, device=dev)[:, None]
           + torch.arange(sr_length, device=dev)[None, :])
    n_samples = rec_data.shape[-1]
    windows = torch.where(idx < n_samples, rec_data[idx.clamp(max=n_samples - 1)], 0.0)
    return windows, counts


def _embedding_output(out):
    """The embedder contract returns (logits, embedding), reference
    model.infer_tf (src/identify_tracks.py:363); a single-output model
    returns the embedding itself."""
    if isinstance(out, (list, tuple)):
        return out[1]
    return out


def _keras_embedder(target: Path, device):
    """A .keras embedder on `device` in float32, cached per path, mtime and
    device."""
    target = target.resolve()
    key = (str(target), target.stat().st_mtime, str(device))
    if key not in _EMBEDDER_CACHE:
        _EMBEDDER_CACHE[key] = KerasModel.load(target).to(device).requires_grad_(False)
    return _EMBEDDER_CACHE[key]


def load_embedder(path, device):
    """The embedder at `path` on `device`: a module mapping windows
    [N, samples] to (logits, embedding) or to the embedding."""
    if path is None:
        raise RuntimeError(
            "no 'embedding_model' path in metadata.txt, and the port does not download "
            "the TF-Hub embedder (it needs a network and tensorflow); convert the "
            "bird-vocalization-classifier SavedModel with tools/convert_model.py and set "
            '"embedding_model"'
        )
    p = Path(path)
    if p.is_file() and p.suffix == ".keras" or (p.is_dir() and list(p.glob("*.keras"))):
        return _keras_embedder(p if p.is_file() else sorted(p.glob("*.keras"))[0], device)
    if (p / "saved_model.pb").exists():
        try:
            converted = auto_convert_saved_model(p)
        except ConversionError:
            return HostSavedModel(p)
        return _keras_embedder(converted / ARCHIVE, device)
    if (p / "weights.npz").exists():
        try:
            cfg = ModelConfig.load(p)
        except FileNotFoundError:
            cfg = ModelConfig.from_meta({}, p)
        return load_classifier(p, cfg, device)
    raise FileNotFoundError(f"no embedder artifact at {path}")


def chirp_embeddings(frames: torch.Tensor, sr, tracks, stride, embedder):
    """Every track window's embedding (reference
    src/identify_tracks.py:353-368), from PCM `frames` [T] at `sr` Hz
    (int16, scaled by 1/32768 before the resample, or float), on the
    frames' device. Returns (embeddings [n_windows, D], windows per
    track)."""
    if frames.dtype == torch.int16:
        frames = frames.to(torch.float32) / 32768.0
    rec_data = resample(frames.to(torch.float32), sr, EMBED_SR)
    windows, counts = get_chirp_samples(rec_data, tracks, sr=EMBED_SR, stride=stride)
    return _embedding_output(embedder(windows)), counts
