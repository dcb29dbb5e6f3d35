"""Host I/O: audio decode, sidecar metadata, model configs, checkpoints."""
