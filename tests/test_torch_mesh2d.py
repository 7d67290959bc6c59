"""The port's 2-D (data, model) mesh (neraf_tpu_torch/parallel/sharding.py:
make_mesh_2d, param_shardings, apply_param_shardings; the sharded acoustic
field, fields/acoustic.py; parallel/dryrun.py) on the CPU against the JAX
package's (neraf_tpu/parallel/sharding.py:41-85) on its 8 virtual CPU
devices. The ranks are gloo processes spawned from the test
(tests/torch_mesh2d_ranks.py), one thread each, meeting at file://
rendezvous under the test's temporary directory.

(a) Each rank's shard of the bridged full-width field (in_dim 1187, widths
    5096, 2048, 1024, 1024, 512, two 257-bin heads) is, bitwise, the
    addressable shard of JAX device d * model + m after
    apply_param_shardings on make_mesh_2d(data, model), at (2, 2) and
    (1, 4), min_dim 1024 and 512; at (1, 3) both raise ValueError (5096
    does not divide by 3).
(b) The sharded field at (1, 2) and (1, 4) (min_dim 1024, 64 rows): the
    output, the input gradient and every parameter's gradient (gathered)
    of the output's dot with a cotangent, against the JAX field's
    value_and_grad on replicated and on sharded parameters, at
    tests/test_parallel.py::test_acoustic_mlp_tensor_sharded_tp's rtol
    2e-4, atol 1e-5.
(c) The tiny joint step (tests/test_torch_train_slice.py's config, f32,
    resnet18 over 32^3, the folded bake) on a (2, 2) mesh of 4 ranks,
    the field sharded at min_dim 512 as the JAX dry run shards it,
    against the JAX train_step on make_mesh_2d(2, 2) with the same
    sharding, at JAX's draws, 2 steps from the step counter 2 (the audio
    branch live), each restarted from JAX's state (bridged and
    checkpointed): losses, every gradient before Adam, the grid, cursor
    and BatchNorm statistics at test_torch_parallel.py's tolerances for
    its 2-rank step; a checkpoint's contents gathered from the mesh have
    the one-rank format's shapes and load back bitwise.
(d) After every step of (c) the replicated state is bitwise rank 0's on
    all 4 ranks and each field shard its data column's first rank's.
(e) A rank's forward FLOPs of the full-width field at (1, 4)
    (FlopCounterMode) are below half of one rank's, as the JAX test
    asserts of the compiled per-device cost.
(f) (c) with the sharded layers' input-gradient sum over the model axis
    dropped misses the JAX gradients upstream of the field.
(g) The port's dryrun_multichip(4) on 4 CPU ranks: a (2, 2) mesh, the
    field sharded at 512, one resident and one streamed step.
Beside them, both audio sweeps on (c)'s mesh against one rank, and
render_rirs refusing the sharded field.
"""

import concurrent.futures
import copy
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

import test_torch_parallel as tp
import test_torch_train_slice as ts
import torch_mesh2d_ranks
from neraf_tpu.data.vision_data import camera_arrays as jcamera_arrays
from neraf_tpu.fields.acoustic import AcousticSoundField as JAcousticSoundField
from neraf_tpu.parallel.sharding import (
    apply_param_shardings as japply_param_shardings,
    make_mesh as jmake_mesh,
    make_mesh_2d as jmake_mesh_2d,
)
from neraf_tpu_torch.bridge import field_state_dict, load_joint_state
from neraf_tpu_torch.data.synthetic import synth_scene
from neraf_tpu_torch.engine.checkpoints import (
    restore_checkpoint,
    save_checkpoint,
    train_state,
)
from neraf_tpu_torch.engine.factory import build_joint_pipeline
from neraf_tpu_torch.fields.acoustic import AcousticSoundField
from neraf_tpu_torch.parallel.dryrun import dryrun_multichip
from neraf_tpu_torch.parallel.sharding import (
    DataMesh,
    apply_param_shardings,
    param_shardings,
)

IN_DIM, ROWS = 1187, 64  # the production in_dim (tests/test_parallel.py:196)
RTOL, ATOL = 2e-4, 1e-5  # tests/test_parallel.py:216
# a leaky-ReLU input this close to 0 (of its layer's peak) may take either
# sign between two summation orders; a flip further out is a fault
KINK_TOL = 1e-5
DRYRUN_MIN_DIM = 512  # __graft_entry__.py:208
STEPS, START_STEP, N_EVAL = 2, 2, 6
JOIN_S = 240  # a group of ranks' deadline


def _start(tmp: Path, name: str, world: int, jobs: list):
    """Start `world` ranks running `jobs` ((job, shape, spec, out) each)
    -> the group for _join."""
    ctx = multiprocessing.get_context("spawn")
    jobs_path = tmp / f"jobs{name}.pkl"
    with open(jobs_path, "wb") as f:
        pickle.dump([(job, shape, spec, str(tmp / f"{out}.pt"))
                     for job, shape, spec, out in jobs], f)
    init = tmp / f"rendezvous_{name}"
    init.mkdir()
    err = str(tmp / f"ranks{name}.err")
    procs = [ctx.Process(target=torch_mesh2d_ranks.rank_main,
                         args=(r, world, str(init), str(jobs_path), err),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    return procs, err, time.monotonic() + JOIN_S, tmp, jobs


def _join(group) -> dict:
    """Wait for a group until its deadline (then kill it and fail) -> each
    job's result by its out name."""
    procs, err, deadline, tmp, jobs = group
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    late = [p for p in procs if p.is_alive()]
    for p in late:
        p.kill()
    for p in procs:
        p.join(10)
    tracebacks = [Path(f"{err}.rank{r}").read_text()
                  for r in range(len(procs)) if Path(f"{err}.rank{r}").exists()]
    if late or any(p.exitcode != 0 for p in procs) or tracebacks:
        pytest.fail(f"{len(procs)} ranks: exit codes "
                    f"{[p.exitcode for p in procs]}, {len(late)} killed "
                    f"after {JOIN_S} s; {tracebacks}")
    return {out: torch.load(tmp / f"{out}.pt") for *_, out in jobs}


def _kill(groups) -> None:
    for procs, *_ in groups:
        for p in procs:
            p.kill()


def _jax_field_grads(field, params, x, cot) -> dict:
    """The field's output, the gradients of its dot with cot and each
    trunk layer's pre-activation, as numpy: {"out", "dx", "grads": {torch
    name: torch layout}, "pre": [(rows, width) per trunk layer]}."""
    def loss(p, xx):
        out = field.apply(p, xx)
        return jnp.sum(out * cot), out

    def pre(p, xx):
        _, st = field.apply(p, xx, capture_intermediates=True,
                            mutable=["intermediates"])
        return [st["intermediates"][f"trunk_{i}"]["__call__"][0]
                for i in range(5)]

    (_, out), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, x)
    grads = {k: v.numpy() for k, v in field_state_dict(
        jax.tree_util.tree_map(np.asarray, gp)).items()}
    return {"out": np.asarray(out), "dx": np.asarray(gx), "grads": grads,
            "pre": [np.asarray(a) for a in jax.jit(pre)(params, x)]}


def _jax_mesh_steps(tmp: Path, inputs: dict, cams) -> tuple:
    """(c): JAX's steps on make_mesh_2d(2, 2), the field sharded at
    min_dim 512, from init_state(seed=3) at step counter 2; each start
    state also stepped on the 1-D make_mesh(2) (the same data axis, no
    model axis), and bridged into the port and checkpointed -> (each
    2-D step's results in test_torch_train_slice's layout, each 1-D
    step's gradients, each step's (checkpoint, JAX's draws), one rank's
    checkpoint shapes). Every step starts from host copies of the state,
    placed as the first (so neither jit compiles twice)."""
    cfg = ts._jax_config("fourier")
    pipes = {}
    for name, mesh in (("2d", jmake_mesh_2d(2, 2)), ("1d", jmake_mesh(2))):
        jpipe = tp._jax_pipeline(cfg)
        for attr in ("opt_prop", "opt_fields", "opt_cam", "opt_audio"):
            setattr(jpipe, attr, ts._recording(getattr(jpipe, attr)))
        jpipe.mesh = mesh
        jpipe._train_step = jax.jit(jpipe._train_step_impl,
                                    donate_argnums=(0,))
        pipes[name] = jpipe
    host = jax.tree_util.tree_map(np.asarray, pipes["2d"].init_state(seed=3))
    host = host._replace(step=np.asarray(START_STEP, np.int32))

    def placed(mesh):
        state = jax.tree_util.tree_map(jnp.asarray, host)
        if mesh is None:
            return state
        field = japply_param_shardings(state.params["audio"]["field"], mesh,
                                       min_dim=DRYRUN_MIN_DIM)
        return state._replace(params={**state.params, "audio": {
            **state.params["audio"], "field": field}})

    port = build_joint_pipeline(grid_res=tp.GRID_RES, tiny=True, device="cpu",
                                mixed_precision=False,
                                config=tp._port_config())
    jarrays = (jcamera_arrays(cams),
               {k: jnp.asarray(v) for k, v in inputs["split"].items()},
               {"images": jnp.asarray(inputs["images"])})
    results, one_d, steps = [], [], []
    for k in range(STEPS):
        load_joint_state(port, host)
        steps.append((str(save_checkpoint(tmp / "c", k, port)),
                      ts._draws(host, cfg)))
        state1, _ = pipes["1d"].train_step(placed(None), *jarrays)
        one_d.append(ts._jax_grads(state1))
        state, jm = pipes["2d"].train_step(placed(pipes["2d"].mesh), *jarrays)
        results.append({
            "metrics": {k2: float(v) for k2, v in jm.items()},
            "grads": ts._jax_grads(state), "grid": np.asarray(state.grid),
            "cursor": int(state.cursor), "step": int(state.step),
            "stats": {k2: v.numpy() for k2, v in ts.tree_to_state_dict(
                state.batch_stats).items()}})
        host = jax.tree_util.tree_map(np.asarray, state)
    return (results, one_d, steps,
            torch_mesh2d_ranks._shapes(train_state(port)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX field, its shards and gradients, the JAX mesh steps, and
    the rank groups' results: the field at (1, 2) and (1, 4) and the dry
    run start first and run while JAX computes; the joint steps (intact
    and mutant) start once JAX's states are checkpointed."""
    tmp = tmp_path_factory.mktemp("mesh2d")
    rng = np.random.default_rng(19)
    x = rng.normal(size=(ROWS, IN_DIM)).astype(np.float32)
    cot = rng.normal(size=(ROWS, 2, 257)).astype(np.float32)
    jfield = JAcousticSoundField(hidden_w=512, sound_rez=2, n_frequencies=257)
    params = jfield.init(jax.random.PRNGKey(1), jnp.asarray(x))
    state = field_state_dict(params)
    torch.save(state, tmp / "field.pt")
    spec = {"state": str(tmp / "field.pt"), "in_dim": IN_DIM, "x": x,
            "cot": cot, "min_dim": 1024}
    groups = [_start(tmp, "field", 4, [("field", (1, 2), spec, "f12"),
                                      ("field", (1, 4), spec, "f14")])]
    # the dry run spawns and joins its own ranks: a thread waits for them
    pool = concurrent.futures.ThreadPoolExecutor(1)
    dryrun = pool.submit(dryrun_multichip, 4, ["cpu"] * 4)
    try:
        jgrads = {"replicated": _jax_field_grads(jfield, params, x, cot)}
        for shape in ((1, 2), (1, 4)):
            sharded = japply_param_shardings(params, jmake_mesh_2d(*shape),
                                             min_dim=1024)
            jgrads[shape] = _jax_field_grads(jfield, sharded, x, cot)
        inputs, cams = tp._inputs()
        jax_steps, jax_1d, c_steps, one_shapes = _jax_mesh_steps(
            tmp, inputs, cams)
        base = {"config": tp._port_config(), "grid_res": tp.GRID_RES,
                "inputs": inputs, "steps": c_steps,
                "min_dim": DRYRUN_MIN_DIM}
        sweep = {**base, "checkpoint": c_steps[0][0],
                 "dataset": synth_scene(N_EVAL, max_len=12, seed=1)}
        groups.append(_start(tmp, "steps", 4, [
            ("steps", (2, 2), base, "c"),
            ("steps", (2, 2), {**base, "mutate": "no_model_sum"}, "f"),
            ("sweeps", (2, 2), sweep, "s")]))
        one = build_joint_pipeline(grid_res=tp.GRID_RES, tiny=True,
                                   device="cpu", mixed_precision=False,
                                   config=tp._port_config())
        restore_checkpoint(sweep["checkpoint"], one)
        one_sweeps = tp._one_thread(lambda: {
            "device": one.evaluate_audio_device(sweep["dataset"], chunk=4),
            "host": one.evaluate_audio(sweep["dataset"], chunk=4)})
        dryrun = dryrun.result()
    except BaseException:
        _kill(groups)
        raise
    finally:
        pool.shutdown()
    results = {}
    for g in groups:
        results.update(_join(g))
    yield {"params": params, "state": state, "jgrads": jgrads,
           "jax": jax_steps, "jax_1d": jax_1d, "one_shapes": one_shapes,
           "one_sweeps": one_sweeps, "dryrun": dryrun,
           **results}
    shutil.rmtree(tmp, ignore_errors=True)


def _view(data: int, model: int, r: int) -> DataMesh:
    """Rank r's view of a (data, model) mesh, without process groups:
    what apply_param_shardings reads."""
    return DataMesh(r // model, data, torch.device("cpu"),
                    model_rank=r % model, model_size=model,
                    axis_names=("data", "model"))


def _whole_field(state: dict) -> AcousticSoundField:
    f = AcousticSoundField(IN_DIM)
    f.load_state_dict(state)
    return f


@pytest.mark.parametrize("min_dim", [1024, 512])
@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_shards_equal_jax_addressable_shards(runs, shape, min_dim):
    """(a) every leaf of every rank, bitwise; the torch weight's rows are
    the flax kernel's columns."""
    data, model = shape
    jmesh = jmake_mesh_2d(data, model)
    sharded = japply_param_shardings(runs["params"], jmesh, min_dim=min_dim)
    jleaves = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            sharded["params"])[0]:
        layer, kind = (p.key for p in path)
        i = layer.rsplit("_", 1)[1]
        name = (f"heads.{i}" if layer.startswith("stft_head")
                else f"trunk.{i}") + (".weight" if kind == "kernel" else ".bias")
        jleaves[name] = leaf
    devices = jax.devices()
    whole = _whole_field(runs["state"])
    assert param_shardings(whole, _view(*shape, 0), min_dim) == {
        k: (("model", None) if leaf.ndim == 2 else ("model",))
        if leaf.sharding.spec != jax.sharding.PartitionSpec() else ()
        for k, leaf in jleaves.items()}
    for r in range(data * model):
        f = apply_param_shardings(copy.deepcopy(whole), _view(*shape, r),
                                  min_dim)
        mine = dict(f.named_parameters())
        assert set(mine) == set(jleaves)
        for name, leaf in jleaves.items():
            (shard,) = [s for s in leaf.addressable_shards
                        if devices.index(s.device) == r]
            want = np.asarray(shard.data)
            want = want.T if want.ndim == 2 else want
            np.testing.assert_array_equal(mine[name].detach().numpy(), want,
                                          err_msg=f"rank {r} {name}")
    # at 1024 the trunk's four wide layers shard, at 512 the fifth too;
    # the 257-bin heads never
    widths = {f"trunk.{i}" for i in range(4 if min_dim == 1024 else 5)}
    assert {k.rsplit(".", 1)[0] for k in f.placements} == widths


def test_a_width_the_model_axis_does_not_divide_raises(runs):
    """(a) (1, 3): 5096 does not divide by 3, in both packages; the
    port's field stays whole."""
    with pytest.raises(ValueError):
        japply_param_shardings(runs["params"], jmake_mesh_2d(1, 3),
                               min_dim=1024)
    whole = _whole_field(runs["state"])
    with pytest.raises(ValueError):
        apply_param_shardings(whole, _view(1, 3, 1), 1024)
    assert not whole.placements
    assert whole.trunk[0].weight.shape == (5096, IN_DIM)


def _kink_free(rep: dict, shd: dict) -> dict:
    """{name: boolean mask} of the entries of the input gradient ("dx")
    and of each trunk parameter's gradient that no leaky-ReLU kink
    reaches: a trunk unit whose pre-activation has one sign on JAX's
    replicated field and the other on its sharded one (the two round
    their dots differently) passes its cotangent whole on one side and a
    tenth of it on the other, which moves its own weight row and bias
    entry, every earlier layer's gradient and its row's input gradient by
    far more than the rounding that flipped it. A flip further than
    KINK_TOL of the layer's peak from 0 is no kink and fails."""
    masks = {"dx": np.ones(rep["dx"].shape, bool)}
    masks.update({k: np.ones(g.shape, bool) for k, g in rep["grads"].items()})
    for i, (a, b) in enumerate(zip(rep["pre"], shd["pre"])):
        flips = np.argwhere((a > 0) != (b > 0))
        if not len(flips):
            continue
        near = np.maximum(np.abs(a), np.abs(b))[tuple(flips.T)].max()
        assert near <= KINK_TOL * np.abs(a).max(), (i, near)
        for row, unit in flips:
            masks[f"trunk.{i}.weight"][unit] = False
            masks[f"trunk.{i}.bias"][unit] = False
            masks["dx"][row] = False
        for j in range(i):
            masks[f"trunk.{j}.weight"][:] = False
            masks[f"trunk.{j}.bias"][:] = False
    return masks


def _close(got, want, what, mask=None):
    """rtol RTOL and atol ATOL of the tensor's peak, where `mask` holds."""
    got, want = np.asarray(got), np.asarray(want)
    if mask is not None:
        got, want = got[mask], want[mask]
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


@pytest.mark.parametrize("placed", ["replicated", "sharded"])
@pytest.mark.parametrize("model", [2, 4])
def test_sharded_field_matches_the_jax_field(runs, model, placed):
    """(b) the output at the JAX test's rtol 2e-4, atol 1e-5 (log-
    magnitudes in [-10, 10]); the input gradient and every parameter's
    gradient at rtol 2e-4, atol 1e-5 of each tensor's peak (weight
    gradients reach 45 here, where 1e-5 is below float32's rounding of a
    64-row sum). Against JAX's sharded field, the entries a kink between
    JAX's two placements reaches are held by the replicated one alone
    (_kink_free: one unit of trunk_0 on this input, at |x| 1.3e-7)."""
    got = runs[f"f1{model}"]
    rep = runs["jgrads"]["replicated"]
    want = rep if placed == "replicated" else runs["jgrads"][(1, model)]
    masks = {} if placed == "replicated" else _kink_free(rep, want)
    assert {k.rsplit(".", 1)[0] for k in got["placements"]} == {
        f"trunk.{i}" for i in range(4)}
    np.testing.assert_allclose(got["out"].numpy(), want["out"], rtol=RTOL,
                               atol=ATOL)
    _close(got["dx"], want["dx"], "dx", masks.get("dx"))
    assert set(got["grads"]) == set(want["grads"])
    for k, g in want["grads"].items():
        _close(got["grads"][k], g, k, masks.get(k))


@pytest.mark.parametrize("model", [2, 4])
def test_sharded_field_matches_the_whole_field_on_one_rank(runs, model):
    """(b) the sharding alone: the rank's sharded field against the whole
    field on the same rank, the output bitwise (each column is the same
    dot), the gradients within ONE_RANK_TOL of each tensor's peak (the
    input gradient summed over the model axis in another order)."""
    got = runs[f"f1{model}"]
    whole = got["whole"]
    assert torch.equal(got["out"], whole["out"])
    for k, g in {"dx": whole["dx"], **whole["grads"]}.items():
        mine = got["dx"] if k == "dx" else got["grads"][k]
        err = float((mine - g).abs().max() / g.abs().max())
        assert err <= tp.ONE_RANK_TOL, (k, err)


def test_sharded_field_flops_fall_by_more_than_half(runs):
    """(e) at (1, 4), as tests/test_parallel.py:222-226 asserts of XLA's
    per-device cost."""
    flops = runs["f14"]["flops"]
    assert 0 < flops["rank"] < flops["whole"] / 2.0, flops


def _doubled(runs, step: int) -> set:
    """The gradients of JAX's 2-D step that miss its 1-D step's."""
    two, one = runs["jax"][step]["grads"], runs["jax_1d"][step]
    return {k for k in one if np.abs(two[k] - one[k]).max()
            > 1e-4 * np.abs(one[k]).max()}


def _reference(runs, step: int) -> dict:
    """JAX's 2-D step, with the gradients it doubles (below) taken from
    its 1-D step on the same data axis."""
    ref = dict(runs["jax"][step])
    ref["grads"] = {**ref["grads"], **{k: runs["jax_1d"][step][k]
                                       for k in _doubled(runs, step)}}
    return ref


@pytest.mark.parametrize("step", range(STEPS))
def test_the_jax_2x2_mesh_doubles_the_split_convs_weight_gradients(runs,
                                                                    step):
    """(c) a fault of the JAX package (ROADMAP.md, fault (e)): on
    make_mesh_2d(2, 2) the weight gradient of every conv in a stage its
    reshard rule splits over "data" is twice its value on the 1-D mesh
    (and on no mesh), as if the "model" axis's replicas were summed too;
    the BatchNorm and field gradients, the losses and every other tensor
    agree. The port's 2-D step is held to the 1-D values there."""
    two, one = runs["jax"][step]["grads"], runs["jax_1d"][step]
    doubled = _doubled(runs, step)
    assert "resnet.conv1.weight" in doubled
    assert all(k.startswith("resnet.") and "conv" in k and k.endswith(
        ".weight") for k in doubled), sorted(doubled)
    for k in doubled:
        ts._close_to_peak(two[k], 2.0 * one[k], k)


@pytest.mark.parametrize("step", range(STEPS))
def test_2x2_mesh_step_matches_the_jax_mesh_step(runs, step):
    """(c) at test_torch_parallel.py's tolerances for its 2-rank step."""
    run = {"jax": _reference(runs, step),
           "port": tp._as_numpy(runs["c"]["records"][step])}
    ts._check_losses(run, live=True)
    ts._check_gradients(run, live=True)
    ts._check_state(run, step + 1, START_STEP + step + 1, live=True)


def test_2x2_checkpoint_is_the_one_rank_format(runs):
    """(c) a checkpoint gathered from the mesh: the field and its Adam
    moments whole, every tensor the one-rank pipeline's shape; loading it
    back leaves every rank's state bitwise as it was."""
    got = runs["c"]
    assert {k.rsplit(".", 1)[0] for k in got["placements"]} == {
        f"trunk.{i}" for i in range(4)}
    assert got["checkpoint_shapes"] == runs["one_shapes"]
    assert got["roundtrip_bitwise"]


@pytest.mark.parametrize("job", ["c", "f"])
def test_2x2_replicas_stay_bitwise_equal(runs, job):
    """(d) after every step: replicated tensors over the 4 ranks, each
    shard over its data column."""
    records = runs[job]["records"]
    assert len(records) == STEPS
    assert all(r["folded_is_grid"] for r in records)
    assert [r["mismatches"] for r in records] == [[]] * STEPS


def test_dropping_the_model_sum_misses_the_jax_gradients(runs):
    """(f) without the model-axis sum of the sharded layers' input
    gradients, the gradients upstream of the field's first sharded layers
    miss JAX's; the losses do not move (the forward is intact)."""
    run = {"jax": _reference(runs, 0),
           "port": tp._as_numpy(runs["f"]["records"][0])}
    ts._check_losses(run, live=True)
    with pytest.raises(AssertionError) as err:
        ts._check_gradients(run, live=True)
    off = [k for k in run["jax"]["grads"]
           if np.abs(run["port"]["grads"][k] - run["jax"]["grads"][k]).max()
           > 1e-2 * np.abs(run["jax"]["grads"][k]).max()]
    assert off and all(k.startswith(("field.trunk.", "resnet.", "fields."))
                       for k in off), (off, str(err.value)[:500])
    assert {"field.trunk.0.weight", "resnet.conv1.weight"} <= set(off)


@pytest.mark.parametrize("sweep", ["device", "host"])
def test_2x2_eval_sweeps_match_one_rank(runs, sweep):
    """Both audio sweeps on the (2, 2) mesh (the RIRs fanned over the data
    axis, every model rank of a row on the same block, the field's
    collectives over the row) against one rank from the same checkpoint,
    at tests/test_parallel.py's bounds; render_rirs, which one rank calls
    alone, refuses the sharded field."""
    got, ref = runs["s"][sweep], runs["one_sweeps"][sweep]
    keys = [k for k in ref if not k.startswith(("fps", "num_rays"))]
    assert keys and set(got) == set(ref)
    for k in keys:
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    assert runs["s"]["render_rirs_refused"]


def test_dryrun_multichip_on_four_cpu_ranks(runs):
    """(g) the (2, 2) mesh, the tiny field's four wide trunk layers
    sharded at 512 (its fifth is 32 wide), two steps with finite losses
    on every rank, the same on all."""
    records = runs["dryrun"]
    assert [(r["data"], r["model"]) for r in records] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    for r in records:
        assert r["axes"] == ["data", "model"]
        assert {k.rsplit(".", 1)[0] for k in r["sharded"]} == {
            f"trunk.{i}" for i in range(4)}
        assert r["metrics"] == records[0]["metrics"]
        assert all(np.isfinite(m["total_loss"]) for m in r["metrics"])
    # the audio branch is masked at step 0 and live at step 1
    assert records[0]["metrics"][0]["audio_mag_loss"] == 0.0
    assert records[0]["metrics"][1]["audio_mag_loss"] > 0.0
