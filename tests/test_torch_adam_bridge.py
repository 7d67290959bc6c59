"""The Adam-state bridge (bridge.load_joint_state's four groups,
bridge.load_audio_state) against optax, on the CPU in float32.

Three JAX steps first, so that the bridged state is not fresh: every
group's Adam count and schedule count at 3 (bias correction past its
first step), the schedules shortened so that they move over the test
(the fields, proposal and camera groups decay over 8 steps, the audio
group warms up over 4 and decays by 10), and the audio branch live from
step 2. Then the state is bridged into the port once, and both packages
take 3 more steps on their own, the port handed the draws each JAX step
makes from its state.rng (test_torch_train_slice.py's _draws).

Held after each step:
- the losses 1e-5 relative and both logged learning rates 1e-6 relative
  (the schedule count bridged);
- every group's exp_avg and exp_avg_sq against optax's mu and nu, to
  MU_TOL and NU_TOL of each tensor's peak: the moments are linear in the
  gradients, which the packages compute to 1e-4 - 2e-3 of their peaks
  (test_torch_train_slice.py's tolerances) and which carry over step to
  step (measured: mu 2.4e-3, nu 1.2e-5 after three steps);
- each weight's change since the bridge against the JAX change, to
  CHANGE_TOL of the tensor's peak change, on the elements whose gradient
  history is clear of the float32 noise floor: JAX's sqrt(nu) above CLEAR
  of its tensor's peak. Below it Adam's m / sqrt(v) turns a gradient at
  the noise floor into an update of up to the learning rate of either
  sign (measured: ResNet layer3 elements whose nu is 1e-4 of the peak's
  move by lr in opposite directions), as
  tests/test_torch_audio_engine.py holds updates where the gradient is
  above 5% of its peak (measured: 4.3e-3 at most);
- Adam's step and ScheduledAdam.count at 6 in every group.
Kinks (ROADMAP.md §3): a ReLU or LeakyReLU input within KINK of its peak
from 0 may open on one side and stay shut on the other, and move a whole
unit's gradient. Every such input of the port's steps (vision, ResNet,
audio; chip_smoke.py's relu_inputs) is found, and a tensor beyond MU_TOL
must be upstream of one (its gradient passes through the unit,
chip_smoke.py's leaf_names) or the test fails; each exemption is printed.
A control port, bridged but with its Adam states reset (count 0, no
moments), is off by more than 0.1 in some mu after one step: the checks
see a state that was not carried over.

Audio-only: the JAX AudioEngine's 3 steps, load_audio_state, 3 more in
both from the indices the JAX step draws, the same checks, but for the
first trunk layer: the JAX engine's jitted step computes its gradient
0.8% of its peak away from jax.grad's eager value, which the port matches
(ROADMAP.md §3, tests/test_torch_audio_engine.py), so trunk.0's mu is
held to 2e-2 and its change to 0.1 (measured 6.7e-3 and 4.6e-2; every
other tensor's change within 5e-4), and the losses, which that layer
moves, to 1e-4 relative (measured 4.1e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import leaf_names, relu_inputs
from neraf_tpu.configs.config import AudioModelConfig as JAudioModelConfig
from neraf_tpu.configs.config import ExperimentConfig as JExperimentConfig
from neraf_tpu.data.vision_data import camera_arrays as jcamera_arrays
from neraf_tpu.engine.audio_engine import AudioEngine as JAudioEngine
from neraf_tpu.engine.pipeline import JointPipeline as JJointPipeline
from neraf_tpu.models.audio import AudioModel as JAudioModel
from neraf_tpu.models.resnet3d import ResNet3D as JResNet3D
from neraf_tpu.models.vision import VisionModel as JVisionModel
from neraf_tpu_torch.bridge import (
    field_state_dict,
    joint_adam_groups,
    load_audio_state,
)
from neraf_tpu_torch.configs.config import AudioModelConfig, ExperimentConfig
from neraf_tpu_torch.data.loader import audio_arrays
from neraf_tpu_torch.data.synthetic import synth_scene
from neraf_tpu_torch.data.vision_data import camera_arrays, synthetic_cameras
from neraf_tpu_torch.engine.audio_engine import AudioEngine
from neraf_tpu_torch.engine.factory import (
    FAR,
    NEAR,
    build_joint_pipeline,
    joint_config,
)
from neraf_tpu_torch.models.audio import AudioModel
from scripts.validate_learning import synth_scene as jsynth_scene
from test_torch_train_slice import GRID_RES, H, N_REC, NUM_CAMERAS, W, _draws
from test_torch_train_slice import _jax_config

MU_TOL, NU_TOL, CHANGE_TOL = 1e-2, 1e-3, 2e-2
CLEAR, KINK = 5e-2, 1e-5
LOSS_RTOL, LR_RTOL, AUDIO_LOSS_RTOL = 1e-5, 1e-6, 1e-4
AUDIO_TRUNK0 = (2e-2, 0.1)  # mu, change: the jitted JAX step's first layer
PRE, POST = 3, 3  # JAX steps before the bridge, steps of both after it


def _short_schedules(cfg):
    o = cfg.optimizers
    for g in (o.proposal_networks, o.fields, o.camera_opt):
        g.max_steps = 8
    o.audio_fields.warmup_steps, o.audio_fields.max_steps = 4, 10


def _near_kinks(calls, names: dict) -> tuple:
    """(lines, the names of the tensors upstream of a ReLU input within
    KINK of its peak from 0)."""
    lines, below = [], set()
    for i, (label, x, fn) in enumerate(calls):
        peak = float(x.abs().max())
        near = x.abs() <= KINK * peak
        if peak > 0 and near.any():
            up = leaf_names(fn, names)
            below |= up
            lines.append(f"{label} ReLU {i} {tuple(x.shape)}: {int(near.sum())}"
                         f" units within {KINK} of the peak, reaching "
                         f"{len(up)} tensors")
    return lines, below


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _port_groups(pipe) -> dict:
    """{group: {key: (parameter, exp_avg, exp_avg_sq, step)}} as numpy."""
    out = {}
    for name, (named, _) in joint_adam_groups(pipe).items():
        opt = pipe.optimizers[name].opt
        out[name] = {k: tuple(v.detach().numpy().copy() for v in (
            p, opt.state[p]["exp_avg"], opt.state[p]["exp_avg_sq"],
            opt.state[p]["step"])) for k, p in named.items()}
    return out


def _jax_groups(pipe, state) -> dict:
    """The same keys from a JAX JointTrainState: the weights (the vision
    field's under both of its groups) and each group's mu, nu and count."""
    weights = {"proposal_networks": state.params["proposal_networks"],
               "fields": state.params["fields"],
               "camera_opt": state.params["camera_opt"],
               "audio_fields": {"audio": state.params["audio"],
                                "vision_fields": state.params["fields"]}}
    out = {}
    for name, (_, moments) in joint_adam_groups(pipe).items():
        adam = state.opt_states[name][0]
        w, mu, nu = (moments(t) for t in (weights[name], adam.mu, adam.nu))
        out[name] = {k: (w[k].numpy(), mu[k].numpy(), nu[k].numpy(),
                         int(adam.count)) for k in w}
    return out


def _check_moments(port, ref, tol, what, exempt=frozenset()) -> list:
    """mu and nu of every key to tol(key) / NU_TOL of its peak -> the keys
    beyond tol that `exempt` excuses."""
    excused = []
    for k, (_, mu, nu, _) in ref.items():
        pm, pn = port[k][1], port[k][2]
        assert _rel(pn, nu) <= NU_TOL, (what, k, "nu", _rel(pn, nu))
        if _rel(pm, mu) > tol(k):
            assert k in exempt, (what, k, "mu", _rel(pm, mu))
            excused.append(k)
    return excused


def _check_changes(port, ref, port0, ref0, what, tol) -> None:
    for k, (w, _, nu, _) in ref.items():
        clear = np.sqrt(nu) >= CLEAR * np.sqrt(nu).max()
        dj, dp = w - ref0[k][0], port[k][0] - port0[k][0]
        if not clear.any() or not np.abs(dj).max() > 0:
            continue
        err = float(np.abs(dp - dj)[clear].max() / np.abs(dj).max())
        assert err <= tol(k), (what, k, err)


@pytest.fixture(scope="module")
def joint():
    cfg = _jax_config("fourier")
    _short_schedules(cfg)
    feat_dim = JResNet3D(backbone="resnet18", n_features=1024).feature_dim
    jpipe = JJointPipeline(
        config=cfg,
        vision_model=JVisionModel(config=cfg.vision_model,
                                  num_cameras=NUM_CAMERAS, near=NEAR, far=FAR),
        audio_model=JAudioModel(config=cfg.audio_model,
                                grid_feature_dim=feat_dim),
        audio_aabb=jnp.asarray([[-3.0] * 3, [3.0] * 3]),
        vision_aabb=jnp.asarray([[-1.0] * 3, [1.0] * 3]), grid_res=GRID_RES)
    rng = np.random.default_rng(12)
    cams = synthetic_cameras(NUM_CAMERAS, H, W, seed=2)
    images = rng.uniform(0.0, 1.0, (NUM_CAMERAS, H, W, 3)).astype(np.float32)
    split = {"mic_pose": rng.uniform(-2.0, 2.0, (N_REC, 3)),
             "source_pose": rng.uniform(-2.0, 2.0, (N_REC, 3)),
             "rot": rng.uniform(0.0, 1.0, (N_REC, 3)),
             "log_stft": rng.normal(-3.0, 0.5, (N_REC, 2, 257, 12))}
    split = {k: v.astype(np.float32) for k, v in split.items()}
    jarrays = (jcamera_arrays(cams), {k: jnp.asarray(v) for k, v in split.items()},
               {"images": jnp.asarray(images)})
    arrays = (camera_arrays(cams, "cpu"), audio_arrays(split, "cpu"),
              {"images": torch.from_numpy(images)})
    state = jpipe.init_state(seed=3)
    for _ in range(PRE):
        state, _ = jpipe.train_step(state, *jarrays)
    pcfg = joint_config(tiny=True)
    _short_schedules(pcfg)
    build = lambda: build_joint_pipeline(
        grid_res=GRID_RES, tiny=True, device="cpu", mixed_precision=False,
        state=state, config=pcfg)
    port, control = build(), build()
    for opt in control.optimizers.values():
        opt.opt.state.clear()
        opt.count = 0
    out = {"bridged": (_port_groups(port), _jax_groups(port, state)),
           "steps": []}
    names = {}
    for name, (named, _) in joint_adam_groups(port).items():
        names.update({id(p): k for k, p in named.items()})
    modules = {"vision": port.vision_model, "resnet": port.resnet,
               "audio": port.audio_model}
    for step in range(POST):
        draws = _draws(state, cfg)
        state, jm = jpipe.train_step(state, *jarrays)
        with relu_inputs(torch, modules) as calls:
            pm = port.train_step(*arrays, draws=draws)
        kinks = _near_kinks(calls, names)
        if step == 0:
            control.train_step(*arrays, draws=draws)
            out["control"] = _port_groups(control)
        out["steps"].append({
            "jax": ({k: float(v) for k, v in jm.items()},
                    _jax_groups(port, state)),
            "port": (pm, _port_groups(port)), "kinks": kinks,
            "counts": {k: o.count for k, o in port.optimizers.items()}})
    return out


def test_bridge_carries_the_adam_state(joint):
    """Right after the bridge: every weight and moment equal to JAX's,
    bitwise, and Adam's step at JAX's count, in every group."""
    port, ref = joint["bridged"]
    assert set(port) == set(ref) == {"proposal_networks", "fields",
                                     "camera_opt", "audio_fields"}
    for name in ref:
        assert set(port[name]) == set(ref[name]), name
        for k, (w, mu, nu, count) in ref[name].items():
            assert count == PRE
            for a, b in zip(port[name][k][:3], (w, mu, nu)):
                np.testing.assert_array_equal(a, b, err_msg=f"{name} {k}")
            assert float(port[name][k][3]) == PRE


@pytest.mark.parametrize("step", range(POST))
def test_steps_after_the_bridge_match_optax(joint, step):
    run = joint["steps"][step]
    (jm, ref), (pm, port), (lines, below) = run["jax"], run["port"], run["kinks"]
    for k in ("rgb_loss", "audio_sc_loss", "audio_mag_loss", "total_loss"):
        np.testing.assert_allclose(pm[k], jm[k], rtol=LOSS_RTOL, err_msg=k)
    for k in ("lr_fields", "lr_audio_fields"):
        np.testing.assert_allclose(pm[k], jm[k], rtol=LR_RTOL, err_msg=k)
    assert pm["audio_mag_loss"] > 0
    port0, ref0 = joint["bridged"]
    for name in ref:
        excused = _check_moments(port[name], ref[name], lambda k: MU_TOL,
                                 f"step {step} {name}", below)
        if excused:
            print(f"step {step} {name}: mu beyond {MU_TOL} upstream of "
                  f"near-kinks {lines}: {excused}")
        _check_changes(port[name], ref[name], port0[name], ref0[name],
                       f"step {step} {name}", lambda k: CHANGE_TOL)
        for k, v in port[name].items():
            assert float(v[3]) == PRE + step + 1 == ref[name][k][3], (name, k)
    assert set(run["counts"].values()) == {PRE + step + 1}


def test_an_unbridged_adam_state_is_seen(joint):
    """The control (bridged weights, fresh Adam) after one step: far from
    optax's moments, so the checks above see a state not carried over."""
    ref = joint["steps"][0]["jax"][1]
    worst = max(_rel(joint["control"][name][k][1], v[1])
                for name in ref for k, v in ref[name].items())
    assert worst > 0.1


def _audio_config(exp_cls, audio_cls):
    cfg = exp_cls(dataset="SoundSpaces")
    cfg.audio_model = audio_cls(dataset="SoundSpaces", max_len=60,
                                n_freq_stft=257, w_field=32,
                                use_grid=False).resolve()
    cfg.audio_data.batch_size = 32
    cfg.optimizers.audio_fields = dataclasses.replace(
        cfg.optimizers.audio_fields, warmup_steps=4, max_steps=10, lr=1e-3)
    return cfg


def test_audio_only_steps_after_the_bridge_match_optax():
    T, N = 60, 6
    jcfg = _audio_config(JExperimentConfig, JAudioModelConfig)
    jtrain = jsynth_scene(N, max_len=T)
    jeng = JAudioEngine(config=jcfg, model=JAudioModel(config=jcfg.audio_model),
                        aabb=jnp.asarray(jtrain.outputs.aabb, jnp.float32))
    jarrays = jtrain.slice_arrays()
    state = jeng.init_state(seed=3)
    for _ in range(PRE):
        state, _ = jeng.train_step(state, jarrays)
    cfg = _audio_config(ExperimentConfig, AudioModelConfig)
    train = synth_scene(N, max_len=T)
    eng = AudioEngine(cfg, AudioModel(cfg.audio_model), train.outputs.aabb,
                      device="cpu")
    load_audio_state(eng, state)
    opt = eng.optimizers["audio_fields"]
    named = dict(eng.model.field.named_parameters())
    assert eng.step == PRE and opt.count == PRE

    def port_state():
        return {k: tuple(v.detach().numpy().copy() for v in (
            p, opt.opt.state[p]["exp_avg"], opt.opt.state[p]["exp_avg_sq"],
            opt.opt.state[p]["step"])) for k, p in named.items()}

    def jax_state(s):
        adam = s.opt_state[0]
        w, mu, nu = (field_state_dict(t) for t in (s.params, adam.mu, adam.nu))
        return {k: (w[k].numpy(), mu[k].numpy(), nu[k].numpy(), int(adam.count))
                for k in w}

    port0, ref0 = port_state(), jax_state(state)
    for k, (w, mu, nu, _) in ref0.items():
        for a, b in zip(port0[k][:3], (w, mu, nu)):
            np.testing.assert_array_equal(a, b, err_msg=k)
    arrays = train.slice_arrays("cpu")
    for step in range(POST):
        _, key = jax.random.split(state.rng)
        idx = np.array(jax.random.randint(key, (cfg.audio_data.batch_size,), 0,
                                          N * T))
        state, jm = jeng.train_step(state, jarrays)
        pm = eng.train_step(arrays, indices=(idx // T, idx % T))
        for k in jm:
            np.testing.assert_allclose(float(pm[k]), float(jm[k]),
                                       rtol=AUDIO_LOSS_RTOL, err_msg=k)
        port, ref = port_state(), jax_state(state)
        _check_moments(port, ref, lambda k: AUDIO_TRUNK0[0] if k.startswith(
            "trunk.0.") else MU_TOL, f"audio-only step {step}")
        _check_changes(port, ref, port0, ref0, f"audio-only step {step}",
                       lambda k: AUDIO_TRUNK0[1] if k.startswith("trunk.0.")
                       else CHANGE_TOL)
        assert opt.count == eng.step == PRE + step + 1 == int(state.step)
        assert all(float(v[3]) == PRE + step + 1 for v in port.values())
