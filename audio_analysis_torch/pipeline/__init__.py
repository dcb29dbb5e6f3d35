"""End-to-end analysis pipeline (classify, cacophony index)."""
