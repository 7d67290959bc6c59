"""PyTorch + CUDA port of neraf_tpu for NVIDIA Hopper.

The JAX package (neraf_tpu) is the reference; this package mirrors its module
paths and names. It imports torch and never jax: the only neraf_tpu module
it uses is neraf_tpu.configs.config, which needs only yaml.
"""
