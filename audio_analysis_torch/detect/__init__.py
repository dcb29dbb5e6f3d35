"""Spectral signal detection and track assembly."""
