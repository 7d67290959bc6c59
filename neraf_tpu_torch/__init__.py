"""PyTorch + CUDA port of neraf_tpu for NVIDIA Hopper.

The JAX package (neraf_tpu) is the reference; this package mirrors its module
paths and names. It imports torch and numpy, never jax, and nothing of
neraf_tpu: it keeps its own copy of the configuration (configs/config.py).
Its entry points run on the card unless the caller passes device="cpu".
"""
