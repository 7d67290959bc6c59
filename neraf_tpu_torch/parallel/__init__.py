"""Multi-device training: the JAX package's 1-D data mesh as
torch.distributed ranks (sharding.py)."""
