"""Data: camera arrays, rays, pixel and STFT-slice batches."""
