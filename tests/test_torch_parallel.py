"""The port's data mesh (neraf_tpu_torch/parallel/sharding.py) on the CPU:
gloo ranks spawned from the test (tests/torch_parallel_ranks.py), one
thread each, meeting at a file:// rendezvous under the test's temporary
directory (so xdist workers never share a port); every group of ranks has
a join deadline, past which its ranks are killed and the test fails.

(a) The tiny joint step of tests/test_torch_train_slice.py (its config,
    its _draws, f32, resnet18 over 32^3, the folded path) at 2 ranks
    against the JAX pipeline on a 2-device mesh, re-jitted as
    tests/test_parallel.py does: losses, every gradient before Adam, the
    grid, cursor and BatchNorm statistics at that file's tolerances, each
    step restarted from JAX's state (bridged, checkpointed, restored on
    rank 0 and broadcast), over the masked steps 0 and 1 and the live
    audio step 2.
(b) The same port step at 2 and 4 ranks against 1 rank, each step from
    the 1-rank run's checkpoint: gradients within 1e-5 of each tensor's
    peak (the summation order of ranks is the only difference), losses
    1e-5 relative; after every step the parameters, BatchNorm statistics,
    grid, folded grid, cursor and step bitwise equal across ranks. A broken
    variant of each collective that the global batch needs (the spectral
    convergence of each rank's block; the bake gather without its sum over
    ranks in the backward) is run too and must miss that bound.
(c) The spectral convergence and the gather on one batch: the mesh's SC
    is the global ratio (1e-6 relative), which the mean of the ranks'
    ratios misses by more than 1e-2 on this batch (its blocks differ in
    scale); each rank's gradient is N times its block of the global
    gradient (rtol 1e-5), which average_gradients divides by N; a
    gathered block's gradient is N times its block of the cotangent.
(d) evaluate_audio_device on 8 synthetic RIRs (T 60, a randomized state
    as tests/test_torch_eval_paths.py makes it) at 2 and 4 ranks against 1
    rank at tests/test_parallel.py's bounds (rtol 2e-4, atol 1e-5), at a
    chunk of 4 and at a ragged chunk of 3 (padded over the ranks), and
    the 2-rank sweep against the JAX pipeline's sweep on a 2-device mesh
    at tests/test_torch_eval_paths.py's bounds.
(e) Streamed against resident at 2 ranks: the rank's sampler block is its
    block of the global batch, and two steps and an eval batch give the
    same metrics, weights, Adam moments, grid and statistics, bitwise.
(f) cli.train --num-devices 2 on the CPU: the run directory written once
    (each record of the cadences once, the checkpoint, the eval images),
    and its step-2 checkpoint resumed by a 1-rank run.
(g) Uneven blocks: a batch that does not divide over the ranks splits as
    XLA tiles P("data") (ceil-sized blocks, the last shorter or empty);
    ValueError for more ranks than cards.
(h) The depth-split ResNet (parallel/depth_split.py), where the JAX
    reshard rule splits it (at grid 32: the stem, the pool and layer1 at
    every N of 2-4, layer2 at N = 2, the rest whole): the eval feature of
    (d)'s randomized state at 2, 3 and 4 ranks against the port's one
    rank and the JAX package's _grid_feature_eval_impl without a mesh
    (tests/test_parallel.py's rtol 2e-4, atol 1e-5); (b)'s live step at 2
    and 3 ranks, the stem kernel's gate off and on, against one rank: the
    train-mode feature, losses, every ResNet gradient, the BatchNorm
    statistics and the live bake slab's gradient (SPLIT_TOL, SPLIT_STATE_TOL
    below), the ResNet's from the ranks' feature cotangent; the split step
    end to end, every gradient and the cotangent too, at 2 and 3 ranks,
    gate off and on, on the uneven config's state below with 512 bake
    cells; each rank's convs and pool read at most ceil(D / N) + 2 of
    their input's D planes wherever the rule splits, and the whole volume
    elsewhere; a step without the halo exchange, the BatchNorm reduction
    or the pool's sum over ranks misses one rank's ResNet gradients.
    3 ranks on 4,096 rays, 2,048 STFT slices and 4,096 bake cells (none
    divides by 3; the flat bake path) against one rank, and the device
    sweep of (d) at 3 ranks.
"""

import json
import multiprocessing
import pickle
import shutil
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train_slice as ts
import torch_parallel_ranks
from fixtures import make_soundspaces_scene, make_vision_scene
from neraf_tpu.data.vision_data import camera_arrays as jcamera_arrays
from neraf_tpu.engine.pipeline import JointPipeline as JJointPipeline
from neraf_tpu.models.audio import AudioModel as JAudioModel
from neraf_tpu.models.resnet3d import ResNet3D as JResNet3D
from neraf_tpu.models.vision import VisionModel as JVisionModel
from neraf_tpu.parallel.sharding import make_mesh as jmake_mesh
from neraf_tpu_torch.bridge import load_joint_state
from neraf_tpu_torch.cli import train
from neraf_tpu_torch.data.synthetic import synth_scene
from neraf_tpu_torch.data.vision_data import camera_arrays, synthetic_cameras
from neraf_tpu_torch.engine.checkpoints import save_checkpoint
from neraf_tpu_torch.engine.factory import (
    FAR,
    NEAR,
    NUM_CAMERAS,
    build_joint_pipeline,
    joint_config,
)
from neraf_tpu_torch.parallel.sharding import (
    DataMesh,
    make_mesh,
    partition,
    shard_batch,
)
from scripts.validate_learning import synth_scene as jsynth_scene
from test_torch_cli import EVALS_ON, TINY
from test_torch_eval_paths import _audio_config, _jax_angles, _randomized

GRID_RES, STEPS, N_EVAL = 32, 3, 8
RANKS = (2, 4)
ONE_RANK_TOL = 1e-5  # of each gradient's peak: (b)
# (h), of each tensor's peak: the split step sums a weight gradient over
# the ranks' slabs, and BatchNorm's statistics from the ranks' (mean, M2)
# pairs, in another order than one rank's float32 sums, on the near-empty
# grid of (b)'s state (where BatchNorm amplifies the order, ROADMAP.md);
# a dropped halo, BatchNorm reduction or pool sum is O(1e-1) off
SPLIT_TOL = 1e-4  # ResNet gradients, the bake slab's gradient
SPLIT_STATE_TOL = 1e-5  # the feature, the BatchNorm statistics
# (h), the ResNet alone in float64 at grid 64, of each tensor's peak: in
# float32 a random volume there puts ReLU inputs within 3e-7 of their peak
# of 0, which flip between any two summation orders (one rank's float32
# flips other units against float64 than the split's) and move a
# gradient by up to 8e-2; float64 leaves the order's rounding alone
SPLIT_F64_TOL = 1e-6
FEATURE_RTOL, FEATURE_ATOL = 2e-4, 1e-5  # tests/test_parallel.py:159
JOIN_S = 240  # a group of ranks' deadline


def _port_config(T=12):
    cfg = joint_config(tiny=True)
    cfg.trainer.mixed_precision = False
    if T != 12:
        cfg.audio_model = _audio_config()
    return cfg


def _grid64_checkpoint(tmp: Path) -> str:
    """(h): a tiny state at grid 64, where the rule splits every stage at
    2 ranks (the final pool's sum too): the grid's rgb and alpha and the
    BatchNorm statistics drawn as _randomized draws them, at step 2 (the
    audio branch live), checkpointed."""
    pipe = build_joint_pipeline(grid_res=64, tiny=True, device="cpu",
                                mixed_precision=False, config=_port_config())
    rng = np.random.default_rng(64)
    grid = pipe.grid.clone()
    grid[:, :4] = torch.as_tensor(rng.uniform(0.0, 1.0, (grid.shape[0], 4)),
                                  dtype=grid.dtype)
    pipe.grid = grid
    for k, v in pipe.resnet.state_dict().items():
        if k.endswith("running_mean"):
            v.copy_(torch.as_tensor(rng.normal(0.0, 0.1, v.shape)))
        elif k.endswith("running_var"):
            v.copy_(torch.as_tensor(rng.uniform(0.5, 1.5, v.shape)))
    pipe.step = 2
    return str(save_checkpoint(tmp / "h64", 2, pipe))


def _uneven_config(cells=4096):
    """(h): the tiny config at 4,096 rays, 2,048 STFT slices and `cells`
    bake cells a step, none of which divides by 3."""
    cfg = _port_config()
    cfg.vision_data.train_rays_per_batch = 4096
    cfg.audio_data.batch_size = 2048
    cfg.trainer.grid_bake_cells_per_step = cells
    return cfg


def _inputs():
    """test_torch_train_slice's cameras, images and split, as numpy."""
    rng = np.random.default_rng(12)
    cams = synthetic_cameras(NUM_CAMERAS, ts.H, ts.W, seed=2)
    images = rng.uniform(0.0, 1.0, (NUM_CAMERAS, ts.H, ts.W, 3)).astype(
        np.float32)
    split = {"mic_pose": rng.uniform(-2.0, 2.0, (ts.N_REC, 3)),
             "source_pose": rng.uniform(-2.0, 2.0, (ts.N_REC, 3)),
             "rot": rng.uniform(0.0, 1.0, (ts.N_REC, 3)),
             "log_stft": rng.normal(-3.0, 0.5, (ts.N_REC, 2, 257, 12))}
    split = {k: v.astype(np.float32) for k, v in split.items()}
    cam = {k: v.numpy() for k, v in camera_arrays(cams, "cpu").items()}
    return {"cams": cam, "images": images, "split": split}, cams


def _start(tmp: Path, name: str, jobs: list):
    """Start the ranks of group `name` (its number of ranks first) running
    `jobs` ((job, spec, out name) each) -> the group for _join."""
    world = int(name[0])
    ctx = multiprocessing.get_context("spawn")
    jobs_path = tmp / f"jobs{name}.pkl"
    with open(jobs_path, "wb") as f:
        pickle.dump([(job, spec, str(tmp / f"{out}{name}.pt"))
                     for job, spec, out in jobs], f)
    err = str(tmp / f"ranks{name}.err")
    init = f"file://{tmp}/rendezvous{name}"
    procs = [ctx.Process(target=torch_parallel_ranks.rank_main,
                         args=(r, world, init, str(jobs_path), err),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, err, time.monotonic() + JOIN_S, tmp, name


def _join(group, jobs) -> dict:
    """Wait for a group until its deadline (then kill it and fail) -> each
    job's result by its out name; a rank that failed fails the test with
    its traceback."""
    procs, err, deadline, tmp, name = group
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    late = [p for p in procs if p.is_alive()]
    for p in late:
        p.kill()
    for p in procs:
        p.join(10)
    tracebacks = [Path(f"{err}.rank{r}").read_text()
                  for r in range(len(procs)) if Path(f"{err}.rank{r}").exists()]
    if late:
        pytest.fail(f"{len(procs)} ranks: {len(late)} still running after "
                    f"{JOIN_S} s, killed; {tracebacks}")
    if any(p.exitcode != 0 for p in procs) or tracebacks:
        pytest.fail(f"{len(procs)} ranks exited {[p.exitcode for p in procs]}: "
                    f"{tracebacks}")
    return {out: torch.load(tmp / f"{out}{name}.pt") for _, _, out in jobs}


def _jax_pipeline(cfg, grid_res=GRID_RES):
    feat_dim = JResNet3D(backbone="resnet18", n_features=1024).feature_dim
    return JJointPipeline(
        config=cfg,
        vision_model=JVisionModel(config=cfg.vision_model,
                                  num_cameras=NUM_CAMERAS, near=NEAR, far=FAR),
        audio_model=JAudioModel(config=cfg.audio_model,
                                grid_feature_dim=feat_dim),
        audio_aabb=jnp.asarray([[-3.0, -3.0, -3.0], [3.0, 3.0, 3.0]]),
        vision_aabb=jnp.asarray([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]]),
        grid_res=grid_res)


def _one_thread(fn, *args):
    """fn(*args) on one torch thread, as a rank runs: the CPU's conv and
    matmul kernels sum in another order at another thread count, which
    moves the live step's gradients by up to 5e-3 of a peak here."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn(*args)
    finally:
        torch.set_num_threads(threads)


def _one_rank_steps(tmp: Path, arrays) -> tuple:
    """The 1-rank port run, a checkpoint before every step -> (each step's
    metrics and gradients, each step's (checkpoint, None))."""
    port = build_joint_pipeline(grid_res=GRID_RES, tiny=True, device="cpu",
                                mixed_precision=False, config=_port_config())
    one, steps = [], []
    for k in range(STEPS):
        steps.append((str(save_checkpoint(tmp / "b", k, port)), None))
        metrics = port.train_step(*arrays)
        one.append({"metrics": metrics,
                    "grads": torch_parallel_ranks._grads(port)})
    return one, steps


def _jax_mesh_steps(tmp: Path, inputs: dict, cams) -> tuple:
    """(a): JAX's steps on a 2-device mesh from init_state(seed=3), each
    start state bridged into the port and checkpointed -> (each step's
    results in test_torch_train_slice's layout, each step's (checkpoint,
    JAX's draws))."""
    cfg = ts._jax_config("fourier")
    jpipe = _jax_pipeline(cfg)
    for attr in ("opt_prop", "opt_fields", "opt_cam", "opt_audio"):
        setattr(jpipe, attr, ts._recording(getattr(jpipe, attr)))
    jpipe.mesh = jmake_mesh(2)
    jpipe._train_step = jax.jit(jpipe._train_step_impl, donate_argnums=(0,))
    state = jpipe.init_state(seed=3)
    port = build_joint_pipeline(grid_res=GRID_RES, tiny=True, device="cpu",
                                mixed_precision=False, config=_port_config())
    jarrays = (jcamera_arrays(cams),
               {k: jnp.asarray(v) for k, v in inputs["split"].items()},
               {"images": jnp.asarray(inputs["images"])})
    results, steps = [], []
    for k in range(STEPS):
        load_joint_state(port, state)
        steps.append((str(save_checkpoint(tmp / "a", k, port)),
                      ts._draws(state, cfg)))
        state, jm = jpipe.train_step(state, *jarrays)
        results.append({
            "metrics": {k2: float(v) for k2, v in jm.items()},
            "grads": ts._jax_grads(state), "grid": np.asarray(state.grid),
            "cursor": int(state.cursor), "step": int(state.step),
            "stats": {k2: v.numpy() for k2, v in ts.tree_to_state_dict(
                state.batch_stats).items()}})
    return results, steps


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Everything the tests compare: the 1-rank port references, the JAX
    mesh steps and sweep, and the rank groups' jobs. The 4-rank group and
    a 2-rank group start first and run while JAX compiles its mesh step;
    a second 2-rank group then runs the steps from JAX's states."""
    tmp = tmp_path_factory.mktemp("parallel")
    inputs, cams = _inputs()
    one, b_steps = _one_thread(_one_rank_steps, tmp,
                               torch_parallel_ranks._arrays(inputs))

    # (d): a randomized T 60 state; its sweeps on one rank
    ecfg = ts._jax_config("fourier")
    ecfg.audio_model = _audio_config()
    epipe = _jax_pipeline(ecfg)
    estate = _randomized(epipe.init_state(seed=3))
    eport = build_joint_pipeline(grid_res=GRID_RES, tiny=True, device="cpu",
                                 mixed_precision=False, state=estate,
                                 config=_port_config(T=60))
    ds = synth_scene(N_EVAL, max_len=60, seed=1)
    key = jax.random.PRNGKey(8)
    angles = _jax_angles(key, (4, *ds.log_stft.shape[1:]))
    one_sweeps = _one_thread(lambda: {c: eport.evaluate_audio_device(
        ds, chunk=c, init_angles=angles[:c]) for c in (4, 3)})
    e_ckpt = str(save_checkpoint(tmp / "d", 0, eport))

    # (c): a batch whose quarters differ in scale
    rng = np.random.default_rng(3)
    y = rng.normal(-3.0, 0.5, (8, 2, 33)).astype(np.float32)
    x = (y + rng.normal(0.0, 0.3, y.shape) * np.repeat(
        [0.1, 1.0, 0.2, 2.0], 2)[:, None, None]).astype(np.float32)
    w = rng.normal(size=(8, 4)).astype(np.float32)

    base = {"config": _port_config(), "grid_res": GRID_RES, "inputs": inputs}
    ebase = {"config": _port_config(T=60), "grid_res": GRID_RES,
             "checkpoint": e_ckpt, "dataset": ds, "angles": angles}
    live = [b_steps[2]]
    coll = {"x": x, "y": y, "w": w}
    # (h): the live step split, gate off and on; at grid 64 (every stage
    # split at 2 ranks) the eval feature, the step and the mutants; 3 ranks
    # on uneven batches
    split = {gate: {**base, "checkpoint": b_steps[2][0], "gate": gate}
             for gate in (False, True)}
    split64 = {**base, "grid_res": 64, "gate": False,
               "checkpoint": _grid64_checkpoint(tmp)}
    rspec = {"backbone": "resnet18", "grid": 64, "seed": 64}
    uneven = {**base, "config": _uneven_config(), "steps": live}
    # the split step end to end, gate off and on, on the uneven config
    # with the folded bake path's 512 cells (the checkpoint's cursor, 512,
    # starts a batch of them)
    e2e = {gate: {**base, "config": _uneven_config(cells=512), "gate": gate,
                  "checkpoint": b_steps[2][0]} for gate in (False, True)}
    e2e_jobs = [("split_step", e2e[False], "e2e_off"),
                ("split_step", e2e[True], "e2e_on")]
    jobs = {"2": [("steps", {**base, "steps": b_steps}, "b"),
                  ("steps", {**base, "steps": live, "mutate": "sc_per_shard"},
                   "sc_per_shard"),
                  ("steps", {**base, "steps": live,
                             "mutate": "gather_no_sum"}, "gather_no_sum"),
                  ("sweeps", {**ebase, "chunks": (4, 3)}, "d"),
                  ("streamed", {**base, "checkpoint": b_steps[2][0],
                                "n_steps": 2}, "e"),
                  ("collectives", coll, "c"), ("features", ebase, "f"),
                  ("split_step", split[False], "split_off"),
                  ("split_step", split[True], "split_on"),
                  ("features", split64, "f64"),
                  ("resnet_split", rspec, "r64"),
                  *[("resnet_split", {**rspec, "mutate": m}, m)
                    for m in torch_parallel_ranks.SPLIT_MUTANTS]],
            "3": [("features", ebase, "f"),
                  ("split_step", split[False], "split_off"),
                  ("split_step", split[True], "split_on"),
                  ("steps", uneven, "uneven"), *e2e_jobs,
                  ("sweeps", {**ebase, "chunks": (4, 3)}, "d"),
                  ("resnet_split", rspec, "r64")],
            "4": [("steps", {**base, "steps": b_steps}, "b"),
                  ("sweeps", {**ebase, "chunks": (4, 3)}, "d"),
                  ("collectives", coll, "c"), ("features", ebase, "f")],
            "2e": e2e_jobs}
    groups = {name: _start(tmp, name, js) for name, js in jobs.items()}
    try:
        one_split = {gate: _one_thread(torch_parallel_ranks.split_step, None,
                                       spec) for gate, spec in split.items()}
        one_r64 = _one_thread(torch_parallel_ranks.resnet_split, None, rspec)
        one_feat64 = _one_thread(torch_parallel_ranks.features, None,
                                 split64)["feat"]
        one_uneven = _one_thread(torch_parallel_ranks.steps, None, uneven)
        one_e2e = {gate: _one_thread(torch_parallel_ranks.split_step, None,
                                     spec) for gate, spec in e2e.items()}
        with eport._eval_mode():
            one_feat = _one_thread(eport._grid_feature_eval)
        jax_feat = np.asarray(jax.jit(epipe._grid_feature_eval_impl)(
            estate.params, estate.batch_stats, estate.grid))
        jax_steps, a_steps = _jax_mesh_steps(tmp, inputs, cams)
        jobs["2a"] = [("steps", {**base, "steps": a_steps}, "a")]
        groups["2a"] = _start(tmp, "2a", jobs["2a"])
        epipe.mesh = jmake_mesh(2)
        jax_sweep = epipe.evaluate_audio_device(
            estate, jsynth_scene(N_EVAL, max_len=60, seed=1), key=key,
            chunk=4)
    except BaseException:
        for procs, *_ in groups.values():
            for p in procs:
                p.kill()
        raise

    results = {name: _join(groups[name], jobs[name]) for name in groups}
    ranks = {n: {k: v for name, res in results.items() if name[0] == str(n)
                 for k, v in res.items()} for n in (2, 3, 4)}
    # one rank's ResNet backward from each split step's feature cotangent
    one_vjp = {(n, gate): _one_thread(
        torch_parallel_ranks.split_step, None,
        {**split[gate], "feat_grad": ranks[n][
            "split_on" if gate else "split_off"]["feat_grad"]})
        for n in (2, 3) for gate in (False, True)}
    yield {"jax": jax_steps, "one": one, "ranks": ranks,
           "jax_sweep": jax_sweep, "one_sweeps": one_sweeps,
           "collectives": coll, "one_split": one_split, "one_vjp": one_vjp,
           "one_uneven": one_uneven[0], "one_e2e": one_e2e,
           "one_feat": one_feat,
           "one_feat64": one_feat64, "one_r64": one_r64,
           "jax_feat": jax_feat}
    shutil.rmtree(tmp, ignore_errors=True)


def _as_numpy(record: dict) -> dict:
    """A rank's step record in test_torch_train_slice's run layout."""
    return {"metrics": record["metrics"],
            "grads": {k: v.numpy() for k, v in record["grads"].items()},
            "grid": record["grid"].numpy(), "cursor": record["cursor"],
            "step": record["step"], "folded_is_grid": record["folded_is_grid"],
            "stats": {k: v.numpy() for k, v in record["stats"].items()}}


@pytest.mark.parametrize("step", range(STEPS))
def test_two_ranks_match_the_jax_mesh_step(runs, step):
    """(a) losses, gradients, grid, cursor and statistics at
    test_torch_train_slice.py's tolerances; audio live at step 2."""
    run = {"jax": runs["jax"][step],
           "port": _as_numpy(runs["ranks"][2]["a"][step])}
    ts._check_losses(run, live=step > 1)
    ts._check_gradients(run, live=step > 1)
    ts._check_state(run, step + 1, step + 1, live=step > 1)


def _worst(grads: dict, ref: dict) -> dict:
    return {k: float((grads[k] - ref[k]).abs().max()
                     / max(float(ref[k].abs().max()), 1e-30)) for k in ref}


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("step", range(STEPS))
def test_ranks_match_one_rank(runs, n, step):
    """(b) gradients within 1e-5 of each tensor's peak, losses 1e-5."""
    got, ref = runs["ranks"][n]["b"][step], runs["one"][step]
    assert set(got["grads"]) == set(ref["grads"])
    bad = {k: e for k, e in _worst(got["grads"], ref["grads"]).items()
           if e > ONE_RANK_TOL}
    assert not bad, sorted(bad.items(), key=lambda kv: -kv[1])
    assert set(got["metrics"]) == set(ref["metrics"])
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5,
                                   atol=1e-5 * ref["metrics"]["total_loss"],
                                   err_msg=k)
    assert (ref["metrics"]["audio_mag_loss"] > 0) == (step == 2)


@pytest.mark.parametrize("n,job", [
    (2, "a"), (2, "b"), (2, "sc_per_shard"), (2, "gather_no_sum"), (4, "b"),
    (2, "split_on"), (3, "split_off"), (3, "split_on")])
def test_replicas_stay_bitwise_equal(runs, n, job):
    """(b), (h) after every step, on every rank: parameters, BatchNorm
    statistics, grid, folded grid, cursor and step as rank 0's, bitwise."""
    records = runs["ranks"][n][job]
    records = records if isinstance(records, list) else [records]
    assert records and all(r["folded_is_grid"] for r in records)
    assert [r["mismatches"] for r in records] == [[]] * len(records)


@pytest.mark.parametrize("mutant,broken", [
    ("sc_per_shard", ("field.", "resnet.", "fields.")),
    ("gather_no_sum", ("fields.",))])
def test_a_dropped_collective_misses_the_one_rank_gradients(runs, mutant,
                                                              broken):
    """(b) without the global SC, or without the gather's backward sum,
    the live step's gradients of the tensors it feeds miss 1-rank's by
    more than the bound (b) holds, while the intact 2-rank step holds it."""
    ref = runs["one"][2]["grads"]
    worst = _worst(runs["ranks"][2][mutant][0]["grads"], ref)
    off = [k for k, e in worst.items() if e > 10 * ONE_RANK_TOL]
    assert off and all(k.startswith(broken) for k in off), off
    assert max(_worst(runs["ranks"][2]["b"][2]["grads"], ref).values()) \
        <= ONE_RANK_TOL


@pytest.mark.parametrize("n", RANKS)
def test_spectral_convergence_is_global_and_gathers_sum(runs, n):
    """(c)"""
    from neraf_tpu_torch.metrics.losses import stft_loss

    c, got = runs["collectives"], runs["ranks"][n]["c"]
    x = torch.as_tensor(c["x"]).requires_grad_()
    ref = stft_loss(x, torch.as_tensor(c["y"]))["audio_sc_loss"]
    ref.backward()
    np.testing.assert_allclose(got["sc"], ref.item(), rtol=1e-6)
    per_shard = float(np.mean(got["shard_sc"]))
    assert abs(per_shard - ref.item()) > 1e-2 * ref.item(), (per_shard, ref)
    np.testing.assert_allclose(got["sc_grad"].numpy() / n, x.grad.numpy(),
                               rtol=1e-5, atol=1e-6 * float(x.grad.abs().max()))
    np.testing.assert_array_equal(got["cell_grad"].numpy(), n * c["w"])


_SWEEP_KEYS = ("audio_T60_mean_error", "audio_total_invalids_T60",
               "audio_EDT", "audio_C50", "audio_mag")


@pytest.mark.parametrize("chunk", [4, 3])
@pytest.mark.parametrize("n", (2, 3, 4))
def test_device_sweep_fans_out_over_ranks(runs, n, chunk):
    """(d), (h) against 1 rank at tests/test_parallel.py's bounds; chunk 3
    leaves ragged chunks that the ranks pad, and 3 ranks split both
    chunks unevenly. The grid feature is computed split over the ranks."""
    got, ref = runs["ranks"][n]["d"][chunk], runs["one_sweeps"][chunk]
    assert set(got) == set(ref)
    for k in _SWEEP_KEYS:
        assert np.isfinite(got[k]), k
        np.testing.assert_allclose(got[k], ref[k], rtol=2e-4, atol=1e-5,
                                   err_msg=k)


def test_two_rank_sweep_matches_the_jax_mesh_sweep(runs):
    """(d) at tests/test_torch_eval_paths.py's device-sweep bounds."""
    got, ref = runs["ranks"][2]["d"][4], runs["jax_sweep"]
    assert set(got) == set(ref)
    assert got["audio_total_invalids_T60"] == ref["audio_total_invalids_T60"]
    for k in ("audio_C50", "audio_mag"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-3, err_msg=k)
    for k in ("audio_T60_mean_error", "audio_EDT"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-2, err_msg=k)


def test_streamed_ranks_are_the_resident_ranks(runs):
    """(e) at 2 ranks, bitwise."""
    e = runs["ranks"][2]["e"]
    assert e["block"] == [True, True]
    assert e["res"] == e["str"] and e["res"][-1]["audio_mag_loss"] > 0
    assert e["same_state"] == [] and e["same_adam"]
    assert e["mismatches"] == [[], []]
    assert e["eval_str"] == e["eval_res"]


# ------------------------------------------------------------------ (f) CLI
def _argv(root, run_dir, steps, *extra):
    argv = ["--dataset", "SoundSpaces", "--scene", "mini_scene", "--data-root",
            str(root), "--max-iters", str(steps), "--run-dir", str(run_dir),
            *extra]
    for item in (*TINY, *EVALS_ON):
        argv += ["--set", item]
    return argv


def _records(run: Path) -> list:
    return [json.loads(line) for line in (run / "metrics.jsonl").open()]


# a 2-step run's records at TINY's and EVALS_ON's cadences, in the order
# the Trainer writes them
CLI_RECORDS = [(1, "eval_batch"), (2, "train"), (2, "eval_batch"),
               (2, "eval_image"), (2, "eval_vision"), (2, "eval_audio")]


def test_cli_num_devices_trains_once_and_resumes_on_one_rank(tmp_path,
                                                            monkeypatch):
    """(f) --num-devices 2 on the CPU, one thread a rank: rank 0's Trainer
    returned; the run directory written once (each record of the cadences
    once, every value finite; config.yml, the step-2 checkpoint, the eval
    images of step 2); that checkpoint resumed on one rank to step 4.
    Replaces the refusal that --num-devices 2 raised before the mesh was
    ported."""
    for k in ("NeRAF_dataset", "NeRAF_scene"):
        monkeypatch.delenv(k, raising=False)
    # 3 eval RIRs: the eval sweep's chunk is padded over the ranks
    make_soundspaces_scene(tmp_path, max_frames=12, n_test=3)
    make_vision_scene(tmp_path, n_frames=3, size=16, scene_dir="mini_scene")
    two = _one_thread(lambda: train.main(
        _argv(tmp_path, tmp_path / "two", 2, "--num-devices", "2"),
        device="cpu"))
    assert two.pipeline.step == 2 and two.pipeline.mesh is not None
    assert not torch.distributed.is_initialized()
    records = _records(tmp_path / "two")
    assert [(r["step"], r["prefix"]) for r in records] == CLI_RECORDS
    assert all(np.isfinite(v) for r in records for v in r.values()
               if isinstance(v, float))
    assert (tmp_path / "two" / "config.yml").is_file()
    assert [p.name for p in (tmp_path / "two" / "neraf_models").iterdir()] \
        == ["step-000000002.pt"]
    images = {p.name for p in (tmp_path / "two" / "eval_images").iterdir()}
    assert {"step_0000002_img.png", "step_0000002_grid.png",
            "step_0000002_comparison_ch_0.png"} <= images
    assert all(n.startswith("step_0000002_") for n in images)
    resumed = train.main(_argv(tmp_path, tmp_path / "resumed", 4, "--load-dir",
                               str(tmp_path / "two" / "neraf_models")),
                         device="cpu")
    assert resumed.pipeline.step == 4
    assert [r["step"] for r in _records(tmp_path / "resumed")
            if r["prefix"] == "train"] == [4]


# ------------------------------------------------------------------ (g)
def test_indivisible_batches_and_too_few_cards_raise():
    """(g) a batch that does not divide over the ranks no longer raises: it
    splits into ceil-sized blocks in rank order, the last shorter (or
    empty), as XLA tiles P("data"), and a pipeline on 3 ranks builds at
    the tiny config's 64 rays, 32 slices and 256 cells; more ranks than
    cards still raise."""
    cpu = torch.device("cpu")
    blocks = [shard_batch({"rays": torch.arange(64)},
                          DataMesh(rank=r, world_size=3, device=cpu))["rays"]
              for r in range(3)]
    assert [b.tolist() for b in blocks] == [list(range(0, 22)),
                                           list(range(22, 44)),
                                           list(range(44, 64))]
    mesh = DataMesh(rank=1, world_size=3, device=cpu)
    assert shard_batch(torch.arange(6), mesh).tolist() == [2, 3]
    assert partition(10, 4) == [(0, 3), (3, 6), (6, 9), (9, 10)]
    assert partition(9, 4) == [(0, 3), (3, 6), (6, 9), (9, 9)]
    pipe = build_joint_pipeline(grid_res=8, tiny=True, device="cpu", mesh=mesh)
    assert pipe.world == 3
    # the default devices are the cards: none here
    with pytest.raises(ValueError, match="requested 2 devices, have 0"):
        make_mesh(2, rank=0)
    with pytest.raises(ValueError, match="requested 3 devices, have 2"):
        make_mesh(3, ["cuda:0", "cuda:1"], rank=0)
    with pytest.raises(ValueError, match="backend='gloo'"):
        make_mesh(2, ["cuda:0", "cuda:0"], rank=0)
    assert not torch.distributed.is_initialized()


# ------------------------------------------------------------------ (h)
def _peak_err(got, ref) -> float:
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("n", (2, 3, 4))
def test_split_feature_matches_one_rank_and_jax(runs, n):
    """(h) the eval feature split over n ranks, against one rank and the
    JAX package's unsharded feature."""
    got = runs["ranks"][n]["f"]["feat"].numpy()
    np.testing.assert_allclose(got, runs["one_feat"].numpy(),
                               rtol=FEATURE_RTOL, atol=FEATURE_ATOL)
    np.testing.assert_allclose(got, runs["jax_feat"], rtol=FEATURE_RTOL,
                               atol=FEATURE_ATOL)


@pytest.mark.parametrize("gate", [False, True])
@pytest.mark.parametrize("n", (2, 3))
def test_split_step_matches_one_rank(runs, n, gate):
    """(h) the live step split over n ranks against one rank, the stem
    kernel's gate off and on: losses (1e-5 relative, as (b)), the
    train-mode feature and the BatchNorm statistics (SPLIT_STATE_TOL of
    their peak); every ResNet gradient and the live slab's (SPLIT_TOL)
    against one rank's ResNet backward from the ranks' (global) feature
    cotangent. That cotangent comes from the audio field, whose ReLUs
    see the feature: at 3 ranks one unit of its third layer sits within
    3e-8 of 0 (of a peak 1.67) and flips between the split and the whole
    feature, which differ by f32 rounding, moving the cotangent by 6e-4
    of its peak; from one cotangent the check sees the ResNet alone."""
    got = runs["ranks"][n]["split_on" if gate else "split_off"]
    ref, vjp = runs["one_split"][gate], runs["one_vjp"][n, gate]
    assert ref["metrics"]["audio_mag_loss"] > 0
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5,
                                   atol=1e-5 * ref["metrics"]["total_loss"],
                                   err_msg=k)
    assert _peak_err(got["feat"], ref["feat"]) <= SPLIT_STATE_TOL
    stats = {k: _peak_err(v, ref["stats"][k]) for k, v in got["stats"].items()}
    assert max(stats.values()) <= SPLIT_STATE_TOL, stats
    assert torch.equal(vjp["feat_grad"], got["feat_grad"])
    assert set(got["grads"]) == set(vjp["grads"])
    resnet = {k: e for k, e in _worst(got["grads"], vjp["grads"]).items()
              if k.startswith("resnet.")}
    bad = {k: e for k, e in resnet.items() if e > SPLIT_TOL}
    assert resnet and not bad, sorted(bad.items(), key=lambda kv: -kv[1])
    assert float(vjp["slab_grad"].abs().max()) > 0
    assert _peak_err(got["slab_grad"], vjp["slab_grad"]) <= SPLIT_TOL


def test_split_feature_with_every_stage_split(runs):
    """(h) at grid 64 and 2 ranks, where the rule splits every stage and
    the final pool sums over ranks: the pipeline's eval feature against
    one rank's (FEATURE_RTOL, FEATURE_ATOL)."""
    np.testing.assert_allclose(runs["ranks"][2]["f64"]["feat"].numpy(),
                               runs["one_feat64"].numpy(), rtol=FEATURE_RTOL,
                               atol=FEATURE_ATOL)
    assert all(t[3] for t in runs["ranks"][2]["f64"]["traces"][0])


@pytest.mark.parametrize("n", (2, 3))
def test_split_resnet_matches_one_rank_in_float64(runs, n):
    """(h) the ResNet alone in float64 at grid 64 (every stage split at 2
    ranks, all but layer3 at 3): the eval and train-mode features, the
    BatchNorm statistics and every gradient within SPLIT_F64_TOL of one
    rank's."""
    got, ref = runs["ranks"][n]["r64"], runs["one_r64"]
    for k in ("eval_feat", "feat"):
        assert _peak_err(got[k], ref[k]) <= SPLIT_F64_TOL, k
    assert max(_peak_err(v, ref["stats"][k])
               for k, v in got["stats"].items()) <= SPLIT_F64_TOL
    worst = _worst(got["grads"], ref["grads"])
    assert set(worst) == set(ref["grads"])
    assert max(worst.values()) <= SPLIT_F64_TOL, sorted(
        worst.items(), key=lambda kv: -kv[1])[:5]
    splits = [t[3] for t in got["traces"][0]]
    assert all(splits) if n == 2 else splits == [True] * 11 + [False] * 5


def _rule_splits(n: int) -> list:
    """The JAX reshard rule at grid 32 for resnet18, op by op in the order
    the port's ResNet traces them: the stem (its input depth D >= 2 N once
    folded), the pool (its input D >= 4 N), then each stage's convs (the
    stage's input D >= 2 x stride x N)."""
    d, out = 16, []
    out.append(d >= 2 * n)  # the stem on the folded 16 planes -> 16
    out.append(d >= 4 * n)  # the pool on 16 planes -> 8
    d //= 2
    for stride, convs in ((1, 4), (2, 5), (2, 5)):
        out += [d >= 2 * stride * n] * convs
        d //= stride
    return out


@pytest.mark.parametrize("n", (2, 3, 4))
def test_split_ranks_read_their_block(runs, n):
    """(h) each rank's convs and pool (eval feature; train step at 2 and 3
    ranks) ran split exactly where the JAX rule splits, reading at most
    ceil(D / N) + 2 of their input's D planes there, and the whole input
    elsewhere."""
    traces = [runs["ranks"][n]["f"]["traces"]]
    if n in (2, 3):
        traces.append(runs["ranks"][n]["split_on"]["traces"])
    for ranks in traces:
        assert len(ranks) == n
        for trace in ranks:
            assert [t[3] for t in trace] == _rule_splits(n)
            for op, planes, depth, split in trace:
                assert planes <= (-(-depth // n) + 2 if split else depth), \
                    (op, planes, depth)
    assert any(t[3] for t in traces[0][0]) and not all(t[3] for t in traces[0][0])


@pytest.mark.parametrize("mutant", list(torch_parallel_ranks.SPLIT_MUTANTS))
def test_a_dropped_split_collective_misses_the_one_rank_gradients(runs,
                                                                    mutant):
    """(h) the float64 ResNet at grid 64 and 2 ranks without the halo
    exchange, the BatchNorm reduction or the pool's sum over ranks: some
    gradient misses one rank's by more than 1e3 x SPLIT_F64_TOL, where the
    intact split holds SPLIT_F64_TOL
    (test_split_resnet_matches_one_rank_in_float64)."""
    worst = _worst(runs["ranks"][2][mutant]["grads"], runs["one_r64"]["grads"])
    assert max(worst.values()) > 1e3 * SPLIT_F64_TOL, mutant


def test_uneven_batches_match_one_rank(runs):
    """(h) 3 ranks on 4,096 rays, 2,048 STFT slices and 4,096 bake cells a
    step (blocks of 1,366, 1,366, 1,364 and 683, 683, 682) against one
    rank: losses 1e-5 relative, every gradient within SPLIT_TOL of its
    peak, the grid within SPLIT_STATE_TOL, the cursor and step equal, and
    the replicas bitwise equal."""
    got, ref = runs["ranks"][3]["uneven"][0], runs["one_uneven"]
    assert ref["metrics"]["audio_mag_loss"] > 0
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5,
                                   atol=1e-5 * ref["metrics"]["total_loss"],
                                   err_msg=k)
    assert set(got["grads"]) == set(ref["grads"])
    bad = {k: e for k, e in _worst(got["grads"], ref["grads"]).items()
           if e > SPLIT_TOL}
    assert not bad, sorted(bad.items(), key=lambda kv: -kv[1])
    assert _peak_err(got["grid"], ref["grid"]) <= SPLIT_STATE_TOL
    assert (got["cursor"], got["step"]) == (ref["cursor"], ref["step"])
    assert got["mismatches"] == []


@pytest.mark.parametrize("gate", [False, True])
@pytest.mark.parametrize("n", (2, 3))
def test_split_step_end_to_end_matches_one_rank(runs, n, gate):
    """(h) the split step on the uneven config's state with 512 bake
    cells (the folded path, where the gate picks the stem's weight
    gradient), the stem kernel's gate off and on, held end to end to one
    rank's step from the same state (no cotangent handed over): losses
    1e-5 relative, the
    train-mode feature and the BatchNorm statistics within
    SPLIT_STATE_TOL of their peak, the feature's cotangent, every
    gradient (the ResNet's and the rest) and the live slab's within
    SPLIT_TOL, the replicas bitwise equal."""
    got = runs["ranks"][n]["e2e_on" if gate else "e2e_off"]
    ref = runs["one_e2e"][gate]
    assert ref["metrics"]["audio_mag_loss"] > 0
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5,
                                   atol=1e-5 * ref["metrics"]["total_loss"],
                                   err_msg=k)
    assert _peak_err(got["feat"], ref["feat"]) <= SPLIT_STATE_TOL
    stats = {k: _peak_err(v, ref["stats"][k]) for k, v in got["stats"].items()}
    assert max(stats.values()) <= SPLIT_STATE_TOL, stats
    assert _peak_err(got["feat_grad"], ref["feat_grad"]) <= SPLIT_TOL
    assert set(got["grads"]) == set(ref["grads"])
    worst = _worst(got["grads"], ref["grads"])
    bad = {k: e for k, e in worst.items() if e > SPLIT_TOL}
    assert any(k.startswith("resnet.") for k in worst) and not bad, sorted(
        bad.items(), key=lambda kv: -kv[1])
    assert float(ref["slab_grad"].abs().max()) > 0
    assert _peak_err(got["slab_grad"], ref["slab_grad"]) <= SPLIT_TOL
    assert got["mismatches"] == []
