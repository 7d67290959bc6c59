"""Encodings and the CUDA kernels' wrappers."""
