"""Weight bridge: flax parameter trees (as numpy arrays) -> torch state_dicts.

Takes the trees JointPipeline.init_state builds: params["audio"]["field"]
(the AcousticSoundField variables, {"params": {...}}), params["audio"]["resnet"]
and the ResNet's batch_stats; and the vision half, params["proposal_networks"]
["level_0" / "level_1"] and params["fields"] (flax variables each), and
params["camera_opt"], the (num_cameras, 6) SO3xR3 corrections; and a whole
JointTrainState's weights, BatchNorm statistics, grid, cursor, step and
the four groups' Adam states (load_joint_state), or an AudioTrainState's
(load_audio_state).
Layouts:

- Dense kernel (in, out) -> Linear weight (out, in); bias as is;
- Conv kernel DHWIO -> Conv3d weight OIDHW (the stem's conv1/kernel too:
  both packages keep the direct (5, 5, 5, 7, 64) layout and fold it inside
  the s2d stem, so the bridge needs nothing more);
- BatchNorm scale/bias -> weight/bias, batch_stats mean/var ->
  running_mean/running_var;
- Embed embedding (num_cameras, dim) -> Embedding weight as is;
- the hash grid's table (L, T, F) -> HashTable table as is.

Every flax leaf must map to a torch key and every torch parameter or running
statistic must be filled; anything else raises KeyError.

Adam: an optax group is chain(scale_by_adam, scale_by_schedule)
(neraf_tpu/engine/optimizers.py), whose state is (ScaleByAdamState(count,
mu, nu), ScaleByScheduleState(count)). mu and nu have the weights' tree
and take the weights' layouts; they become torch.optim.Adam's exp_avg and
exp_avg_sq, the Adam count its `step` (the bias corrections), and the
schedule's count ScheduledAdam.count (the learning rate). The vision
field's parameters sit in two torch groups, `fields` and `audio_fields`,
as the reference steps them; each takes its own group's moments (the
audio group's "vision_fields" subtree). A group's leaves must cover its
parameters exactly, else KeyError.
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
# vision fields: proposal Dense_i, main field base_i / base_out / head_i /
# head_out / appearance / hash
_VISION_SCOPE = [
    (re.compile(r"^Dense_(\d+)$"), r"mlp.\1"),
    (re.compile(r"^base_(\d+)$"), r"mlp_base.\1"),
    (re.compile(r"^head_(\d+)$"), r"mlp_head.\1"),
    (re.compile(r"^(base_out|head_out|appearance|hash)$"), r"\1"),
]
_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
         "var": "running_var", "embedding": "weight", "table": "table"}


def _leaves(tree, path=()):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for key, sub in tree.items():
            yield from _leaves(sub, path + (str(key),))
    else:
        yield path, np.asarray(tree, dtype=np.float32)


def _torch_key(path: tuple, scopes=_SCOPE) -> str:
    parts = []
    for scope in path[:-1]:
        for pat, repl in scopes:
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


def tree_to_state_dict(*trees, scopes=_SCOPE) -> dict:
    """Flatten flax trees into one torch state_dict (keys may not repeat)."""
    out = {}
    for tree in trees:
        for path, arr in _leaves(tree):
            key = _torch_key(path, scopes)
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


def load_vision_params(vision_model: nn.Module, params: dict) -> None:
    """Fill the port's VisionModel (proposal fields, main field and camera
    corrections) from a JAX train state's params, or VisionModel.init's
    tree."""
    cam = torch.from_numpy(np.array(params["camera_opt"], dtype=np.float32))
    if cam.shape != vision_model.camera_opt.shape:
        raise KeyError(f"camera_opt {tuple(cam.shape)} != "
                       f"{tuple(vision_model.camera_opt.shape)}")
    with torch.no_grad():
        vision_model.camera_opt.copy_(cam)
    props = params["proposal_networks"]
    for level, prop in enumerate(vision_model.proposal_networks):
        load_state_dict(prop, tree_to_state_dict(
            props[f"level_{level}"]["params"], scopes=_VISION_SCOPE))
    load_state_dict(vision_model.field, tree_to_state_dict(
        params["fields"]["params"], scopes=_VISION_SCOPE))


def _prefixed(prefix: str, state: dict) -> dict:
    return {f"{prefix}{k}": v for k, v in state.items()}


def load_adam_state(scheduled, named: dict, opt_state, moments) -> None:
    """Fill one ScheduledAdam (engine/optimizers.py) from an optax group's
    state: `named` maps a torch key to each of the group's parameters,
    `moments(tree)` maps mu's (or nu's) tree to a state dict of the same
    keys. The optimizers' own parameters are updated in place elsewhere;
    this sets their exp_avg, exp_avg_sq and step, and the schedule count."""
    adam, sched = opt_state[0], opt_state[1]
    mu, nu = moments(adam.mu), moments(adam.nu)
    if {id(p) for p in named.values()} != {id(p) for p in scheduled.params}:
        raise KeyError("the named parameters are not the group's")
    for what, sd in (("mu", mu), ("nu", nu)):
        missing, unexpected = sorted(set(named) - set(sd)), sorted(set(sd) - set(named))
        if missing or unexpected:
            raise KeyError(f"Adam {what} mismatch: missing {missing}, "
                           f"unexpected {unexpected}")
    opt = scheduled.opt
    fused = opt.param_groups[0]["fused"]
    count = float(np.asarray(adam.count))
    for key, param in named.items():
        for what, sd in (("mu", mu), ("nu", nu)):
            if sd[key].shape != param.shape:
                raise KeyError(f"Adam {what} {key}: {tuple(sd[key].shape)} "
                               f"!= {tuple(param.shape)}")
        # torch.optim.Adam's own state layout: a float32 step on the
        # parameter's device for the fused kernel, on the CPU otherwise
        opt.state[param] = {
            "step": torch.tensor(count, dtype=torch.float32,
                                 device=param.device if fused else "cpu"),
            "exp_avg": mu[key].to(param.device),
            "exp_avg_sq": nu[key].to(param.device)}
    scheduled.count = int(np.asarray(sched.count))


def _vision_named(vision_model) -> dict:
    return {f"field.{k}": p for k, p in vision_model.field.named_parameters()}


def _vision_moments(tree) -> dict:
    return _prefixed("field.", tree_to_state_dict(tree["params"],
                                                  scopes=_VISION_SCOPE))


def joint_adam_groups(pipeline) -> dict:
    """{group: (its parameters by torch key, moments)} of a JointPipeline's
    four groups; moments(tree) maps the group's optax mu (or nu) tree to a
    state dict of the same keys."""
    vm = pipeline.vision_model

    def proposal_moments(tree):
        return {f"{i}.{k}": v for i in range(len(vm.proposal_networks))
                for k, v in tree_to_state_dict(
                    tree[f"level_{i}"]["params"], scopes=_VISION_SCOPE).items()}

    def camera_moments(arr):
        return {"camera_opt": torch.from_numpy(np.array(arr, np.float32))}

    def audio_moments(tree):
        audio = tree["audio"]
        return {**_prefixed("audio.", field_state_dict(audio["field"])),
                **_prefixed("resnet.", tree_to_state_dict(audio["resnet"])),
                **_vision_moments(tree["vision_fields"])}

    return {
        "proposal_networks": ({
            f"{i}.{k}": p for i, prop in enumerate(vm.proposal_networks)
            for k, p in prop.named_parameters()}, proposal_moments),
        "fields": (_vision_named(vm), _vision_moments),
        "camera_opt": ({"camera_opt": vm.camera_opt}, camera_moments),
        "audio_fields": ({
            **_prefixed("audio.",
                        dict(pipeline.audio_model.field.named_parameters())),
            **_prefixed("resnet.", dict(pipeline.resnet.named_parameters())),
            **_vision_named(vm)}, audio_moments),
    }


def load_joint_adam(pipeline, opt_states: dict) -> None:
    """The four groups' Adam states from JointTrainState.opt_states."""
    for name, (named, moments) in joint_adam_groups(pipeline).items():
        load_adam_state(pipeline.optimizers[name], named, opt_states[name],
                        moments)


def load_joint_state(pipeline, state) -> None:
    """Fill a JointPipeline from a JAX JointTrainState (or anything with its
    params, batch_stats, opt_states, grid, cursor and step): every weight
    in place, the four groups' Adam moments, counts and schedule counts,
    the BatchNorm running statistics, the grid (the pipeline refolds its
    grid_folded from it; the JAX state's own folded copy is the same
    values and is not read), the cursor and the step."""
    load_vision_params(pipeline.vision_model, state.params)
    load_render_params(pipeline.resnet, pipeline.audio_model.field,
                       state.params, state.batch_stats)
    load_joint_adam(pipeline, state.opt_states)
    pipeline.grid = torch.as_tensor(np.array(state.grid, dtype=np.float32),
                                    device=pipeline.device)
    pipeline.cursor, pipeline.step = int(state.cursor), int(state.step)


def load_audio_state(engine, state) -> None:
    """Fill an AudioEngine from a JAX AudioTrainState
    (neraf_tpu/engine/audio_engine.py:34): the field's weights, its Adam
    state (the engine's one `audio_fields` group) and the step."""
    field = engine.model.field
    load_state_dict(field, field_state_dict(state.params))
    load_adam_state(engine.optimizers["audio_fields"],
                    dict(field.named_parameters()), state.opt_state,
                    field_state_dict)
    engine.step = int(state.step)
