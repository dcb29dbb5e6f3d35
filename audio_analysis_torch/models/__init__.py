"""Classifiers: TuiNet and the dense head."""
