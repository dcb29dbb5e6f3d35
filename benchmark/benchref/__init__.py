"""The benchmark's plain reference: the analysis of one recording (detection,
tracks, window plan, frontend, classifier, result JSON) and the
classifiers themselves, in plain PyTorch and NumPy.

It imports nothing of ``audio_analysis_torch`` (nor JAX): the modules
marked as frozen copies are the port's plain host code, copied here so that
a later change to the port cannot move the yardstick. Everything runs on
the device the caller's tensors live on, in the precision a ``Precision``
names (float64 DFTs and float32 classifiers by default).
"""
