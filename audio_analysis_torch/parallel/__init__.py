"""Training: TuiNet from labelled PCM (train.py) and fine-tuning of imported
``.keras`` classifiers (finetune.py), on one device."""
