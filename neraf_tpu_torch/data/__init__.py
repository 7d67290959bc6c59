"""Data: camera arrays, rays, pixel and STFT-slice batches, the audio split and the synthetic validation scenes."""
