"""Typed model config backed by the reference's ``metadata.txt`` schema.

The per-model ``metadata.txt`` JSON *is* the reference's config system: ~25
``meta.get(key, default)`` reads drive the whole DSP frontend and label space
(reference: src/identify_tracks.py:291-299, 465-497). This dataclass accepts
the identical file unchanged and carries the same defaults, so released
Cacophony model metadata drops in as-is.
"""

import json
from dataclasses import dataclass, field
from pathlib import Path

DEFAULT_SPECIES = ["kiwi", "whistler", "morepork"]
DEFAULT_BIRDS = ["bird"] + DEFAULT_SPECIES
NON_BIRD = ["human", "noise", "insect"]


def load_model_meta(model_path) -> dict:
    """metadata.txt next to a model file, or inside a model dir
    (reference: src/identify_tracks.py:291-299)."""
    model_path = Path(model_path)
    if model_path.is_file():
        meta_file = model_path.parent / "metadata.txt"
    else:
        meta_file = model_path / "metadata.txt"
    with open(meta_file, "r") as f:
        return json.load(f)


@dataclass
class ModelConfig:
    """All frontend/label hyperparameters with the reference defaults
    (reference: src/identify_tracks.py:465-497)."""

    model_path: str = ""
    name: str = ""
    labels: list = field(default_factory=list)
    ebird_ids: list = None
    multi_label: bool = None
    segment_length: float = 3.0
    segment_stride: float = 1.5
    hop_length: int = 640
    mean_sub: bool = False
    use_mfcc: bool = False
    n_mels: int = 160
    break_freq: float = 1750.0
    htk: bool = False
    fmin: float = 50.0
    fmax: float = 11000.0
    power: float = 2.0
    db_scale: bool = True
    bird_labels: list = field(default_factory=lambda: list(DEFAULT_BIRDS))
    bird_species: list = field(default_factory=lambda: list(DEFAULT_SPECIES))
    channels: int = 1
    threshold: float = 0.7
    n_fft: int = 4096
    pre_model: bool = False
    normalize: bool = True
    filter_freq: bool = False
    filter_below: float = None
    pad_short_tracks: bool = False
    magv2: bool = True
    # the Audio Spectrogram Transformer's ("architecture": "ast") widths,
    # ViT-B/16 by default, and its input normalisation (AudioSet's, for
    # Kaldi fbank features)
    net_dim: int = 768
    net_depth: int = 12
    net_heads: int = 12
    net_mlp: int = 3072
    net_patch: int = 16
    net_patch_stride: int = 10
    norm_mean: float = -4.2677
    norm_std: float = 4.5690
    raw: dict = field(default_factory=dict)

    @classmethod
    def from_meta(cls, meta: dict, model_path="") -> "ModelConfig":
        n_fft = meta.get("n_fft", 4096)
        if n_fft is None:  # reference guards this (src/identify_tracks.py:495-496)
            n_fft = 4096
        return cls(
            model_path=str(model_path),
            name=meta.get("name", False) or "",
            labels=meta.get("labels") or [],
            ebird_ids=meta.get("ebird_ids"),
            multi_label=meta.get("multi_label"),
            segment_length=meta.get("segment_length", 3),
            segment_stride=meta.get("segment_stride", 1.5),
            hop_length=meta.get("hop_length", 640),
            mean_sub=meta.get("mean_sub", False),
            use_mfcc=meta.get("use_mfcc", False),
            n_mels=meta.get("n_mels", 160),
            break_freq=meta.get("break_freq", 1750),
            htk=meta.get("htk", False),
            fmin=meta.get("fmin", 50),
            fmax=meta.get("fmax", 11000),
            power=meta.get("power", 2),
            db_scale=meta.get("db_scale", True),
            bird_labels=meta.get("bird_labels", list(DEFAULT_BIRDS)),
            bird_species=meta.get("bird_species", list(DEFAULT_SPECIES)),
            channels=meta.get("channels", 1),
            threshold=meta.get("threshold", 0.7),
            n_fft=n_fft,
            pre_model=meta.get("pre_model", False),
            normalize=meta.get("normalize", True),
            filter_freq=meta.get("filter_freq", False),
            filter_below=meta.get("filter_below", None),
            pad_short_tracks=meta.get("pad_short_tracks", False),
            magv2=meta.get("magv2", True),
            net_dim=meta.get("net_dim", 768),
            net_depth=meta.get("net_depth", 12),
            net_heads=meta.get("net_heads", 12),
            net_mlp=meta.get("net_mlp", 3072),
            net_patch=meta.get("net_patch", 16),
            net_patch_stride=meta.get("net_patch_stride", 10),
            norm_mean=meta.get("norm_mean", -4.2677),
            norm_std=meta.get("norm_std", 4.5690),
            raw=dict(meta),
        )

    @classmethod
    def load(cls, model_path) -> "ModelConfig":
        return cls.from_meta(load_model_meta(model_path), model_path)

    @property
    def is_efficientnet(self) -> bool:
        """EfficientNet inputs get a 3-channel repeat
        (reference: src/identify_tracks.py:539-540)."""
        return "efficientnet" in (self.name or "").lower()
