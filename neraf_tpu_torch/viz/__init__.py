"""Eval images: STFT panels and grid views."""
