"""Weight bridge: flax parameter trees (as numpy arrays) -> torch state_dicts.

Takes the trees JointPipeline.init_state builds: params["audio"]["field"]
(the AcousticSoundField variables, {"params": {...}}), params["audio"]["resnet"]
and the ResNet's batch_stats. Layouts:

- Dense kernel (in, out) -> Linear weight (out, in); bias as is;
- Conv kernel DHWIO -> Conv3d weight OIDHW;
- BatchNorm scale/bias -> weight/bias, batch_stats mean/var ->
  running_mean/running_var.

Every flax leaf must map to a torch key and every torch parameter or running
statistic must be filled; anything else raises KeyError.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

_SCOPE = [
    (re.compile(r"^trunk_(\d+)$"), r"trunk.\1"),
    (re.compile(r"^stft_head_(\d+)$"), r"heads.\1"),
    (re.compile(r"^(layer\d+)_(\d+)$"), r"\1.\2"),
    (re.compile(r"^(conv\d|bn\d|down_conv|down_bn)$"), r"\1"),
]
_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
         "var": "running_var"}


def _leaves(tree, path=()):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for key, sub in tree.items():
            yield from _leaves(sub, path + (str(key),))
    else:
        yield path, np.asarray(tree, dtype=np.float32)


def _torch_key(path: tuple) -> str:
    parts = []
    for scope in path[:-1]:
        for pat, repl in _SCOPE:
            if pat.match(scope):
                parts.append(pat.sub(repl, scope))
                break
        else:
            raise KeyError(f"unmapped flax scope {'/'.join(path)}")
    leaf = path[-1]
    if leaf == "kernel":
        parts.append("weight")
    elif leaf in _LEAF:
        parts.append(_LEAF[leaf])
    else:
        raise KeyError(f"unmapped flax leaf {'/'.join(path)}")
    return ".".join(parts)


def _to_torch(path: tuple, arr: np.ndarray) -> torch.Tensor:
    if path[-1] == "kernel":
        if arr.ndim == 2:
            arr = arr.T  # (in, out) -> (out, in)
        elif arr.ndim == 5:
            arr = arr.transpose(4, 3, 0, 1, 2)  # DHWIO -> OIDHW
        else:
            raise KeyError(f"kernel {'/'.join(path)} has rank {arr.ndim}")
    return torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))


def tree_to_state_dict(*trees) -> dict:
    """Flatten flax trees into one torch state_dict (keys may not repeat)."""
    out = {}
    for tree in trees:
        for path, arr in _leaves(tree):
            key = _torch_key(path)
            if key in out:
                raise KeyError(f"flax leaves collide on torch key {key}")
            out[key] = _to_torch(path, arr)
    return out


def load_state_dict(module: nn.Module, state: dict) -> None:
    """Strict load: raises KeyError on a missing or unexpected key. BatchNorm
    step counters, which flax does not keep, are set to 0."""
    expected = module.state_dict()
    state = dict(state)
    for key in expected:
        if key.endswith("num_batches_tracked") and key not in state:
            state[key] = torch.zeros((), dtype=torch.long)
    missing = sorted(set(expected) - set(state))
    unexpected = sorted(set(state) - set(expected))
    if missing or unexpected:
        raise KeyError(f"state_dict mismatch: missing {missing}, "
                       f"unexpected {unexpected}")
    module.load_state_dict(state, strict=True)


def field_state_dict(field_variables) -> dict:
    """AcousticSoundField variables ({"params": {...}}) -> state_dict."""
    return tree_to_state_dict(field_variables["params"])


def resnet_state_dict(resnet_params, batch_stats) -> dict:
    return tree_to_state_dict(resnet_params, batch_stats)


def load_render_params(resnet: nn.Module, field: nn.Module, params: dict,
                       batch_stats) -> None:
    """Fill the port's ResNet3D and AcousticSoundField from a JAX train
    state's params and batch_stats (JointTrainState.params / .batch_stats)."""
    audio = params["audio"]
    load_state_dict(field, field_state_dict(audio["field"]))
    load_state_dict(resnet, resnet_state_dict(audio["resnet"], batch_stats))
