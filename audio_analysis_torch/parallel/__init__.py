"""Training and scale-out: TuiNet from labelled PCM (train.py), fine-tuning
of imported ``.keras`` classifiers (finetune.py), on one device or over a
('data', 'model') mesh of ranks (mesh.py, distributed.py), one serving rank
(worker.py) and the dry-run hooks (dryrun.py)."""
