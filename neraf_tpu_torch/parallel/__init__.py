"""Multi-device training: the JAX package's 1-D data mesh and 2-D (data,
model) mesh as torch.distributed ranks (sharding.py), the ResNet's depth
split (depth_split.py) and the dry run (dryrun.py)."""
