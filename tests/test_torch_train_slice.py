"""The port's tiny joint train step against JAX JointPipeline.train_step.

Both start from one JAX init_state (the port through build_joint_pipeline's
bridge), see the same cameras, images and STFT split, and take the same
random draws: the port is handed the draws that _train_step_impl makes from
state.rng (pipeline.py:287-299, vision.py:121, samplers.py:50,97,
vision_data.py:236-239, loader.py:31-33). Three steps with
start_step_audio=1 cover the masked audio phase (steps 0, 1) and the live
one (step 2). f32 on the CPU, tiny vision with the main field on each
encoding (fourier; hash: 4 levels x 2 features, 2^10 rows, resolutions
4-32, so the fresh cells' gradient also reaches the table), resnet18,
w_field 32, T 12, 64 rays, 32 STFT slices and 256 grid cells a step.

The grid is 32^3, not 16^3: at 16^3 resnet18's layer3 sees a 1^3 volume,
which batch-1 BatchNorm normalises to its bias, so no gradient reaches the
grid and the bake's gradient path would go unchecked.

JAX's gradients before Adam come from a test-side optax wrapper, swapped
onto the JAX pipeline's opt_* attributes before the step is traced, that
records each group's gradient in its state; no JAX file changes. Every
step starts the port from JAX's state (bridge.load_joint_state: weights,
BatchNorm statistics, grid, cursor, step; the port's Adam moments and
counts carry over): Adam's first updates are ~lr sign(g), so float-level
gradient differences would otherwise become lr-sized weight differences.
Adam and its schedule are held against optax in tests/test_torch_train.py.
At 32^3 and 256 cells a step both packages take the pre-folded grid path
(one cursor batch is one slab of the folded volume): after every step the
port's grid_folded is fold_grid(grid) bitwise. One more fourier step runs
with NERAF_STEM_WGRAD_PALLAS=1 on both sides, from step 2 so that the audio
branch is live: the port's stem weight gradient is then ops/stem_wgrad.py's
(plain on the CPU, once a step, on the folded volume), held against the
JAX step's at the same tolerances. And one fourier step, from step 2, with
use_single_jitter=False: each sampler then jitters with one uniform per bin
edge, (R, S + 1), drawn as the JAX samplers draw them.

Tolerances: losses 1e-5 relative, the interlevel and distortion terms also
1e-5 of the total loss (they are ~1e-5 of it here, and differences of f32
cumulative sums that the two packages add in other orders); gradients, the
grid and the BatchNorm statistics to 1e-4 of each tensor's largest entry,
except the gradients that are float-sensitive by construction: the
proposal fields' (their only loss is that interlevel term) to 2e-3, and
those of the camera corrections and of the main field's encoded-input
layers to 1e-3 (positions enter the encoding at up to 2^8 turns, where one
ulp of a position, which the corrected rays' rotation leaves to rounding,
is 1e-4 rad of phase); the learning rates 1e-6 relative (numpy float32
against XLA's exp and log).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neraf_tpu.configs.config import AudioModelConfig, ExperimentConfig
from neraf_tpu.data.vision_data import camera_arrays as jcamera_arrays
from neraf_tpu.data.vision_data import sample_pixel_batch as jsample_pixel_batch
import neraf_tpu.models.grid as jg
from neraf_tpu.engine.pipeline import JointPipeline as JJointPipeline
from neraf_tpu.models.audio import AudioModel as JAudioModel
from neraf_tpu.models.resnet3d import ResNet3D as JResNet3D
from neraf_tpu.models.vision import VisionModel as JVisionModel
from neraf_tpu_torch.bridge import (
    _VISION_SCOPE,
    load_joint_state,
    tree_to_state_dict,
)
from neraf_tpu_torch.data.loader import audio_arrays
from neraf_tpu_torch.data.vision_data import camera_arrays, synthetic_cameras
from neraf_tpu_torch.engine.factory import (
    FAR,
    NEAR,
    NUM_CAMERAS,
    build_joint_pipeline,
    joint_config,
    vision_model_config,
)
from neraf_tpu_torch.models.grid import fold_grid
from neraf_tpu_torch.ops import stem_wgrad

GRID_RES, H, W, N_REC, STEPS = 32, 12, 10, 5, 3
GROUPS = ("proposal_networks", "fields", "camera_opt", "audio_fields")
GRAD_TOL = {"proposal_networks": 2e-3, "camera_opt": 1e-3,
            "fields.mlp_base": 1e-3}  # by key prefix, else 1e-4


def _recording(inner):
    """inner's update, with the gradient it was given kept as the third
    entry of its state (entry 1 stays the schedule count the pipeline
    logs its learning rate from)."""
    def init(params):
        return (*inner.init(params), jax.tree_util.tree_map(jnp.zeros_like,
                                                            params))

    def update(grads, state, params=None):
        upd, new = inner.update(grads, state[:2], params)
        return upd, (*new, grads)

    return optax.GradientTransformation(init, update)


def _jax_config(encoding, single_jitter=True, bake=256):
    cfg = ExperimentConfig(dataset="SoundSpaces")
    cfg.vision_model = dataclasses.replace(
        vision_model_config(tiny=True, encoding=encoding),
        use_single_jitter=single_jitter)
    cfg.audio_model = AudioModelConfig(
        dataset="SoundSpaces", max_len=12, n_freq_stft=257, w_field=32,
        n_features=1024, resnet_backbone="resnet18").resolve()
    cfg.trainer.mixed_precision = False
    cfg.trainer.start_step_audio = 1
    cfg.trainer.grid_bake_cells_per_step = bake
    cfg.vision_data.train_rays_per_batch = 64
    cfg.audio_data.batch_size = 32
    return cfg


def _draws(state, cfg):
    """The draws _train_step_impl makes from state.rng, as numpy: the
    samplers' uniforms (R, 1) each with use_single_jitter, else (R, S + 1)
    for a sampler of S samples (samplers.py:52,99)."""
    _, k_pix, k_aud, k_render = jax.random.split(state.rng, 4)
    R, B = cfg.vision_data.train_rays_per_batch, cfg.audio_data.batch_size
    T = cfg.audio_model.max_len
    cam, py, px = jsample_pixel_batch(k_pix, NUM_CAMERAS, H, W, R)
    idx = jax.random.randint(k_aud, (B,), 0, N_REC * T)
    vm = cfg.vision_model
    widths = ((1, 1, 1) if vm.use_single_jitter else
              (*(s + 1 for s in vm.num_proposal_samples),
               vm.num_nerf_samples + 1))
    u = [jax.random.uniform(k, (R, n))
         for k, n in zip(jax.random.split(k_render, 3), widths)]
    vals = (cam, py, px, idx // T, idx % T, *u)
    keys = ("cam", "py", "px", "rec", "t", "u_init", "u_pdf0", "u_pdf1")
    return {k: np.array(v) for k, v in zip(keys, vals)}


def _port_grads(port):
    vm = port.vision_model
    out = {f"proposal_networks.{i}.{k}": p.grad
           for i, prop in enumerate(vm.proposal_networks)
           for k, p in prop.named_parameters()}
    out.update({f"fields.{k}": p.grad for k, p in vm.field.named_parameters()})
    out["camera_opt"] = vm.camera_opt.grad
    out.update({f"field.{k}": p.grad
                for k, p in port.audio_model.field.named_parameters()})
    out.update({f"resnet.{k}": p.grad for k, p in port.resnet.named_parameters()})
    return {k: v.detach().numpy().copy() for k, v in out.items()}


def _jax_grads(state):
    g = {name: state.opt_states[name][2] for name in GROUPS}
    out = {}
    for i in range(2):
        sd = tree_to_state_dict(g["proposal_networks"][f"level_{i}"]["params"],
                                scopes=_VISION_SCOPE)
        out.update({f"proposal_networks.{i}.{k}": v for k, v in sd.items()})
    sd = tree_to_state_dict(g["fields"]["params"], scopes=_VISION_SCOPE)
    out.update({f"fields.{k}": v for k, v in sd.items()})
    out["camera_opt"] = np.asarray(g["camera_opt"])
    audio = g["audio_fields"]["audio"]
    out.update({f"field.{k}": v for k, v in
                tree_to_state_dict(audio["field"]["params"]).items()})
    out.update({f"resnet.{k}": v for k, v in
                tree_to_state_dict(audio["resnet"]).items()})
    # the vision field's gradient reaches both of its groups unchanged
    np.testing.assert_array_equal(
        tree_to_state_dict(g["audio_fields"]["vision_fields"]["params"],
                           scopes=_VISION_SCOPE)["base_out.weight"].numpy(),
        sd["base_out.weight"].numpy())
    return {k: np.asarray(v) for k, v in out.items()}


def _bn_stats(port):
    return {k: v.numpy().copy() for k, v in port.resnet.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def _run_steps(encoding, steps, start_step=0, single_jitter=True,
               grid_res=GRID_RES, bake=256, fill_grid=False):
    """`steps` joint steps of both packages from one JAX init_state, its
    step counter set to `start_step`, on a grid_res^3 grid baking `bake`
    cells a step (with fill_grid, every cell's rgb and alpha first set to
    seeded uniforms, as a trained grid has them) -> a list of each step's
    results."""
    cfg = _jax_config(encoding, single_jitter, bake)
    feat_dim = JResNet3D(backbone="resnet18", n_features=1024).feature_dim
    jpipe = JJointPipeline(
        config=cfg,
        vision_model=JVisionModel(config=cfg.vision_model,
                                  num_cameras=NUM_CAMERAS, near=NEAR, far=FAR),
        audio_model=JAudioModel(config=cfg.audio_model,
                                grid_feature_dim=feat_dim),
        audio_aabb=jnp.asarray([[-3.0, -3.0, -3.0], [3.0, 3.0, 3.0]]),
        vision_aabb=jnp.asarray([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]]),
        grid_res=grid_res)
    for attr in ("opt_prop", "opt_fields", "opt_cam", "opt_audio"):
        setattr(jpipe, attr, _recording(getattr(jpipe, attr)))
    state = jpipe.init_state(seed=3)
    state = state._replace(step=jnp.asarray(start_step, jnp.int32))
    if fill_grid:
        grid = np.array(state.grid)
        grid[:, :4] = np.random.default_rng(13).uniform(size=(len(grid), 4))
        folded = (None if state.grid_folded is None else jg.fold_grid(
            jnp.asarray(grid), grid_res, state.grid_folded.dtype))
        state = state._replace(grid=jnp.asarray(grid), grid_folded=folded)
    pcfg = joint_config(tiny=True, encoding=encoding)
    pcfg.trainer.grid_bake_cells_per_step = bake
    pcfg.vision_model = dataclasses.replace(pcfg.vision_model,
                                            use_single_jitter=single_jitter)
    port = build_joint_pipeline(grid_res=grid_res, tiny=True, device="cpu",
                                mixed_precision=False, state=state,
                                config=pcfg)

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

    out = []
    for _ in range(steps):
        load_joint_state(port, state)
        draws = _draws(state, cfg)
        state, jm = jpipe.train_step(state, *jarrays)
        pm = port.train_step(*arrays, draws=draws)
        out.append({
            "jax": {"metrics": {k: float(v) for k, v in jm.items()},
                    "grads": _jax_grads(state), "grid": np.asarray(state.grid),
                    "cursor": int(state.cursor), "step": int(state.step),
                    "stats": {k: v.numpy() for k, v in tree_to_state_dict(
                        state.batch_stats).items()}},
            "port": {"metrics": pm, "grads": _port_grads(port),
                     "grid": port.grid.numpy().copy(),
                     "folded": port.grid_folded is not None,
                     "folded_is_grid": port.grid_folded is not None and bool(
                         torch.equal(port.grid_folded,
                                     fold_grid(port.grid, grid_res))),
                     "cursor": port.cursor,
                     "step": port.step, "stats": _bn_stats(port)},
        })
    return out


@pytest.fixture(scope="module", params=["fourier", "hash"])
def runs(request):
    return _run_steps(request.param, STEPS)


@pytest.fixture(scope="module")
def gate_run():
    """One fourier step with NERAF_STEM_WGRAD_PALLAS=1 on both sides, from
    step 2 (the audio branch live, so a gradient reaches the stem): the JAX
    step takes the folded stem_conv_baked with XLA's weight gradient on the
    CPU (baked_stem.py:81-93), the port StemConvBaked with the plain
    stem_wgrad of the folded volume, whose calls are counted."""
    calls = []
    plain = stem_wgrad.stem_wgrad_folded_plain

    def counted(x, g):
        calls.append(tuple(x.shape))
        return plain(x, g)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NERAF_STEM_WGRAD_PALLAS", "1")
        mp.setattr(stem_wgrad, "stem_wgrad_folded_plain", counted)
        (run,) = _run_steps("fourier", 1, start_step=2)
    return run, calls


@pytest.fixture(scope="module")
def jitter_run():
    """One fourier step with use_single_jitter=False on both sides, from
    step 2 (the audio branch live)."""
    (run,) = _run_steps("fourier", 1, start_step=2, single_jitter=False)
    return run


def _close_to_peak(a, b, what):
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * max(np.abs(b).max(),
                                                            1e-12),
                               err_msg=what)


def _check_losses(run, live):
    jm, pm = run["jax"]["metrics"], run["port"]["metrics"]
    assert set(pm) == set(jm)
    assert (pm["audio_mag_loss"] != 0.0) == live
    for k in ("rgb_loss", "interlevel_loss", "distortion_loss",
              "audio_sc_loss", "audio_mag_loss", "total_loss"):
        atol = (1e-5 * jm["total_loss"]
                if k in ("interlevel_loss", "distortion_loss") else 0.0)
        np.testing.assert_allclose(pm[k], jm[k], rtol=1e-5, atol=atol,
                                   err_msg=k)
    for k in ("lr_fields", "lr_audio_fields"):
        np.testing.assert_allclose(pm[k], jm[k], rtol=1e-6, err_msg=k)


def _check_gradients(run, live):
    jg, pg = run["jax"]["grads"], run["port"]["grads"]
    assert set(pg) == set(jg)
    errs = {k: float(np.abs(pg[k] - jg[k]).max() / max(np.abs(jg[k]).max(), 1e-30))
            for k in jg}
    tol = lambda k: next((t for pre, t in GRAD_TOL.items()
                          if k.startswith(pre)), 1e-4)
    bad = {k: e for k, e in errs.items() if e > tol(k)}
    assert not bad, sorted(bad.items(), key=lambda kv: -kv[1])
    # live audio: the audio loss reaches the field through the fresh cells
    assert (np.abs(jg["resnet.conv1.weight"]).max() > 0) == live


def _check_state(run, n_steps, step, live):
    """After n_steps steps from an empty grid, at step counter `step`."""
    j, p = run["jax"], run["port"]
    assert p["cursor"] == j["cursor"] == 256 * n_steps
    assert p["step"] == j["step"] == step
    assert p["folded_is_grid"]  # the folded path, its state the grid's fold
    _close_to_peak(p["grid"], j["grid"], "grid")
    baked = np.abs(p["grid"][:, :4]).sum(-1) > 0
    assert baked.sum() == 256 * n_steps and baked[:256 * n_steps].all()
    assert set(p["stats"]) == set(j["stats"])
    for k in j["stats"]:
        _close_to_peak(p["stats"][k], j["stats"][k], k)
    # the statistics move only once the audio branch is live
    moved = any(not np.allclose(p["stats"][k], 0.0 if "mean" in k else 1.0)
                for k in p["stats"])
    assert moved == live


@pytest.mark.parametrize("step", range(STEPS))
def test_losses_match_jax(runs, step):
    _check_losses(runs[step], live=step > 1)


@pytest.mark.parametrize("step", range(STEPS))
def test_gradients_match_jax(runs, step):
    """Every parameter's gradient before Adam, in all four groups."""
    _check_gradients(runs[step], live=step > 1)


@pytest.mark.parametrize("step", range(STEPS))
def test_grid_cursor_and_bn_stats_match_jax(runs, step):
    _check_state(runs[step], step + 1, step + 1, live=step > 1)


def test_stem_gate_losses_match_jax(gate_run):
    _check_losses(gate_run[0], live=True)


def test_stem_gate_gradients_match_jax(gate_run):
    """The stem's weight gradient from stem_wgrad_plain against XLA's, and
    every other gradient, at the same tolerances."""
    _check_gradients(gate_run[0], live=True)


def test_stem_gate_grid_cursor_and_bn_stats_match_jax(gate_run):
    _check_state(gate_run[0], 1, 3, live=True)


def test_stem_gate_runs_the_stem_weight_gradient_once_a_step(gate_run):
    """Once, on the folded volume (1, R/2, R/2, R/2, 56)."""
    half = GRID_RES // 2
    assert gate_run[1] == [(1, half, half, half, 56)]


def test_per_edge_jitter_losses_match_jax(jitter_run):
    _check_losses(jitter_run, live=True)


def test_per_edge_jitter_gradients_match_jax(jitter_run):
    """use_single_jitter=False: every gradient at the same tolerances."""
    _check_gradients(jitter_run, live=True)


def test_per_edge_jitter_grid_cursor_and_bn_stats_match_jax(jitter_run):
    _check_state(jitter_run, 1, 3, live=True)
