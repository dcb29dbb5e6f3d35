"""Classifiers: TuiNet, the dense head and the Keras graph executor."""

from audio_analysis_torch.models.keras_graph import KerasModel

__all__ = ["KerasModel"]
