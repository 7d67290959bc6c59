"""The port's folded stem path against the JAX package, on the CPU.

- The fold helpers (models/grid.py): fold_volume, unfold_volume, fold_grid,
  folded_bake_supported, folded_slab and bake_cells_folded, bitwise against
  neraf_tpu.models.grid (the same values moved, cast once).
- stem_wgrad_folded_plain against the Pallas kernel stem_wgrad_pallas in
  interpret mode (as tests/test_stem_wgrad.py runs it), to 1e-5 of the peak
  in f32 and with bf16 inputs (f32 sums of the same products in another
  order); unfolded, against the direct stem_wgrad_plain in float64, to
  1e-12 of the peak.
- StemConvBaked (ops/baked_stem.py) against the JAX stem_conv_baked with
  allow_pallas=False (as tests/test_grid_folded.py builds it) at every
  cursor of a full refresh cycle of an 8^3 grid (both channel offsets, the
  first and last depth plane and row block): the output, the fresh cells'
  gradient and the weight gradient, each to 1e-5 of its peak (f32), with
  the gate off (torch's folded weight gradient) and on (the plain version).
- The (s2d) ResNet3D in eval mode against flax ResNet3D with
  stem_impl="s2d" and "direct" at atol 1e-4, rtol 1e-3
  (tests/test_torch_resnet3d.py's tolerance), and against the same network
  with the direct conv as its stem in float64 to 1e-10 of the peak; a
  volume with an odd side takes the direct conv.
- The joint step: grid_folded bitwise equal to fold_grid(grid) after three
  steps, in f32 and bf16, through a checkpoint round trip (no .pt holds
  it) and through the bridge from a JAX state; a geometry that does not
  qualify (grid 8 at 128 cells a step, grid 32 at 32) takes the flat path
  and still matches the JAX step (tests/test_torch_train_slice.py's
  tolerances).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import neraf_tpu.models.grid as jg
from neraf_tpu.models.resnet3d import ResNet3D as JResNet3D
from neraf_tpu.ops.baked_stem import stem_conv_baked as jstem_conv_baked
from neraf_tpu_torch.bridge import load_state_dict, resnet_state_dict
from neraf_tpu_torch.data.loader import audio_arrays
from neraf_tpu_torch.data.vision_data import camera_arrays, synthetic_cameras
from neraf_tpu_torch.engine.checkpoints import (
    restore_checkpoint,
    save_checkpoint,
)
from neraf_tpu_torch.engine.factory import build_joint_pipeline
from neraf_tpu_torch.models import grid as pg
from neraf_tpu_torch.models.resnet3d import ResNet3D
from neraf_tpu_torch.ops import stem_wgrad as sw
from neraf_tpu_torch.ops.baked_stem import stem_conv_baked
from test_torch_train_slice import _check_gradients, _check_losses, _run_steps

CIN = 7


def _np(t):
    return np.asarray(t.detach().float().numpy() if isinstance(t, torch.Tensor)
                      else jnp.asarray(t, jnp.float32))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# --------------------------------------------------------------- fold helpers

@pytest.mark.parametrize("shape", [(8, 8, 8), (4, 6, 10)],
                         ids=["cube", "asymmetric"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fold_volume_matches_jax_bitwise(shape, dtype):
    """fold_volume (cast first) and unfold_volume, bitwise."""
    x = np.random.default_rng(1).normal(size=(1, *shape, CIN)).astype(np.float32)
    want = np.asarray(jg.fold_volume(jnp.asarray(x), jnp.dtype(dtype)))
    got = pg.fold_volume(torch.from_numpy(x), getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (1, *(n // 2 for n in shape), 8 * CIN)
    assert np.array_equal(_np(got), want.astype(np.float32))
    back = pg.unfold_volume(got)
    assert np.array_equal(_np(back), np.asarray(
        jg.unfold_volume(jnp.asarray(want)), np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fold_grid_matches_jax_bitwise(dtype):
    R = 16
    grid = np.asarray(jg.init_grid(R)).copy()
    grid[:, :4] = np.random.default_rng(2).uniform(size=(R ** 3, 4))
    want = np.asarray(jg.fold_grid(jnp.asarray(grid), R, jnp.dtype(dtype)))
    got = pg.fold_grid(torch.from_numpy(grid), R, getattr(torch, dtype))
    assert np.array_equal(_np(got), want.astype(np.float32))


def test_folded_bake_supported_matches_jax():
    for r in (8, 16, 32, 128):
        for b in (16, 32, 64, 128, 256, 512, 2048, 4096):
            if r ** 3 % b == 0:
                assert (pg.folded_bake_supported(r, b)
                        == jg.folded_bake_supported(r, b)), (r, b)
    assert pg.folded_bake_supported(128, 4096)
    assert not pg.folded_bake_supported(8, 128)


@pytest.mark.parametrize("r,bake", [(8, 16), (16, 64), (16, 256)])
def test_folded_slab_and_bake_match_jax_bitwise(r, bake):
    """Every cursor of a full refresh cycle: the slab and its placement,
    and the folded volume after the splice, in f32 and bf16."""
    rng = np.random.default_rng(r + bake)
    cells = pg.cell_centers(r)
    grid = np.asarray(jg.init_grid(r)).copy()
    grid[:, :4] = rng.uniform(size=(r ** 3, 4))
    for dtype in ("float32", "bfloat16"):
        jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
        jfold = jg.fold_grid(jnp.asarray(grid), r, jdt)
        pfold = pg.fold_grid(torch.from_numpy(grid), r, tdt)
        for cursor in range(0, r ** 3, bake):
            fresh = rng.uniform(size=(bake, 4)).astype(np.float32)
            js, jd0, jh0, jch = jg.folded_slab(
                jnp.asarray(fresh), jnp.int32(cursor), jnp.asarray(cells), r,
                jdt)
            jfold = jg.bake_cells_folded(jfold, jnp.int32(cursor),
                                         jnp.asarray(fresh),
                                         jnp.asarray(cells), r)
            slab, d0, h0, ch = pg.bake_cells_folded(
                pfold, cursor, torch.from_numpy(fresh),
                torch.from_numpy(cells), r)
            assert (d0, h0, ch) == (int(jd0), int(jh0), int(jch)), cursor
            assert slab.dtype == tdt and np.array_equal(
                _np(slab), np.asarray(js, np.float32)), cursor
        assert np.array_equal(_np(pfold), np.asarray(jfold, np.float32))


# ---------------------------------------------------------- weight gradient

@pytest.mark.parametrize("shape", [(8, 8, 8), (4, 8, 12)],
                         ids=["cube", "asymmetric"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stem_wgrad_folded_plain_matches_pallas_interpret(shape, dtype):
    from neraf_tpu.ops.pallas.stem_wgrad_kernel import stem_wgrad_pallas

    rng = np.random.default_rng(sum(shape))
    xf = rng.normal(size=(1, *shape, 8 * CIN)).astype(np.float32)
    g = rng.normal(size=(1, 16, *shape)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = np.asarray(stem_wgrad_pallas(
        jnp.asarray(xf, jdt), jnp.asarray(g.transpose(0, 2, 3, 4, 1), jdt),
        block_d=2, interpret=True))
    got = sw.stem_wgrad_folded_plain(torch.from_numpy(xf).to(tdt),
                                     torch.from_numpy(g).to(tdt))
    assert got.dtype == torch.float32 and got.shape == (3, 3, 3, 56, 16)
    assert _rel(got.numpy(), want) <= 1e-5


def test_stem_wgrad_folded_plain_unfolded_is_the_direct_one():
    """Unfolded, the folded weight gradient of fold_volume(x) is the direct
    conv's of x (stem_wgrad_plain), float64, to 1e-12 of the peak."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(1, 10, 6, 12, CIN)))
    g = torch.from_numpy(rng.normal(size=(1, 64, 5, 3, 6)))
    got = sw.stem_wgrad_unfold(sw.stem_wgrad_folded_plain(pg.fold_volume(x), g))
    want = sw.stem_wgrad_plain(x, g)
    assert got.dtype == torch.float64 and got.shape == (64, CIN, 5, 5, 5)
    assert _rel(got.numpy(), want.numpy()) <= 1e-12


def test_fold_weight_matches_the_stem_and_unfolds():
    """fold_weight is _StemConv's weight fold (neraf_tpu/models/resnet3d.py:
    123-127) in the Conv3d layout, bitwise; unfold_weight its inverse."""
    w = np.random.default_rng(8).normal(size=(64, CIN, 5, 5, 5)).astype(np.float32)
    wj = jnp.asarray(w.transpose(2, 3, 4, 1, 0))
    wp = jnp.pad(wj, ((0, 1), (0, 1), (0, 1), (0, 0), (0, 0)))
    wp = wp.reshape(3, 2, 3, 2, 3, 2, CIN, 64).transpose(
        0, 2, 4, 1, 3, 5, 6, 7).reshape(3, 3, 3, 8 * CIN, 64)
    got = sw.fold_weight(torch.from_numpy(w))
    assert np.array_equal(got.numpy(), np.asarray(wp).transpose(4, 3, 0, 1, 2))
    assert torch.equal(sw.unfold_weight(got), torch.from_numpy(w))


# -------------------------------------------------------------- baked stem

@pytest.mark.parametrize("use_kernel", [False, True], ids=["gate_off", "gate_on"])
def test_stem_conv_baked_matches_jax(use_kernel):
    r, bake, cout = 8, 16, 64
    rng = np.random.default_rng(3)
    cells = pg.cell_centers(r)
    grid = np.asarray(jg.init_grid(r)).copy()
    grid[:, :4] = rng.uniform(size=(r ** 3, 4))
    w = (0.1 * rng.normal(size=(cout, CIN, 5, 5, 5))).astype(np.float32)
    wj = jnp.pad(jnp.asarray(w.transpose(2, 3, 4, 1, 0)),
                 ((0, 1), (0, 1), (0, 1), (0, 0), (0, 0)))
    wj = wj.reshape(3, 2, 3, 2, 3, 2, CIN, cout).transpose(
        0, 2, 4, 1, 3, 5, 6, 7).reshape(3, 3, 3, 8 * CIN, cout)
    base = jg.fold_grid(jnp.asarray(grid), r)
    pfold = pg.fold_grid(torch.from_numpy(grid), r)
    probe = rng.normal(size=(1, r // 2, r // 2, r // 2, cout)).astype(np.float32)

    def jax_loss(fresh, wp, cursor):
        slab, d0, h0, ch = jg.folded_slab(fresh, cursor, jnp.asarray(cells),
                                          r, jnp.float32)
        nf = jax.lax.dynamic_update_slice(
            base, jax.lax.stop_gradient(slab),
            (jnp.int32(0), d0, h0, jnp.int32(0), ch))
        out = jstem_conv_baked(nf, slab, d0, h0, ch, wp, False)
        return jnp.sum(out * probe), out

    grad_fn = jax.grad(jax_loss, argnums=(0, 1), has_aux=True)
    for cursor in range(0, r ** 3, bake):
        fresh = rng.uniform(size=(bake, 4)).astype(np.float32)
        (jdf, jdw), jout = grad_fn(jnp.asarray(fresh), wj, jnp.int32(cursor))
        ft = torch.from_numpy(fresh).requires_grad_()
        wt = torch.from_numpy(w).requires_grad_()
        nf = pfold.clone()
        slab = pg.bake_cells_folded(nf, cursor, ft, torch.from_numpy(cells), r)
        out = stem_conv_baked(nf, *slab, wt, use_kernel)
        (out * torch.from_numpy(probe).permute(0, 4, 1, 2, 3)).sum().backward()
        want_dw = sw.stem_wgrad_unfold(torch.from_numpy(np.array(jdw)))
        for what, got, want in (
                ("out", out.permute(0, 2, 3, 4, 1), np.asarray(jout)),
                ("d_fresh", ft.grad, np.asarray(jdf)),
                ("d_w", wt.grad, want_dw.numpy())):
            assert _rel(_np(got), want) <= 1e-5, (what, cursor)
        assert wt.grad.shape == (cout, CIN, 5, 5, 5)


# ------------------------------------------------------------------ ResNet3D

def _random_stats(tree, rng):
    """Every BN mean/var replaced by random values (var in [0.5, 1.5])."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _random_stats(v, rng)
        elif k == "mean":
            out[k] = jnp.asarray(rng.normal(0, 0.2, v.shape), jnp.float32)
        else:
            out[k] = jnp.asarray(rng.uniform(0.5, 1.5, v.shape), jnp.float32)
    return out


@pytest.mark.parametrize("stem_impl", ["s2d", "direct"])
def test_resnet3d_eval_matches_flax_by_stem(stem_impl):
    """The port's (s2d) ResNet3D against flax's with either stem: f32
    convolutions through 8 blocks; the pooled features are O(1), so 1e-4
    absolute with 1e-3 relative, as tests/test_torch_resnet3d.py."""
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, size=(1, 16, 16, 16, CIN)).astype(np.float32)
    jmodel = JResNet3D(backbone="resnet18", stem_impl=stem_impl)
    variables = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x), train=True)
    stats = _random_stats(variables["batch_stats"], rng)
    ref = np.asarray(jmodel.apply(
        {"params": variables["params"], "batch_stats": stats},
        jnp.asarray(x), train=False))
    model = ResNet3D(backbone="resnet18")
    load_state_dict(model, resnet_state_dict(variables["params"], stats))
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    assert np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-3)


def test_resnet3d_s2d_matches_direct_in_float64():
    """Eval mode, float64: the ResNet's feature against the same network
    with the direct conv (kernel 5, stride 2, padding 2) as its stem, to
    1e-10 of the peak (only the stem's order of sums differs); with an odd
    side the stem is the direct conv, bitwise."""
    net = ResNet3D(backbone="resnet18").double()
    net.reset_parameters(torch.Generator().manual_seed(5))
    direct = ResNet3D(backbone="resnet18").double()
    direct.load_state_dict(net.state_dict())
    direct.stem = lambda x, bake_slab=None: F.conv3d(
        x.permute(0, 4, 1, 2, 3), direct.conv1.weight, None, 2, 2)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.uniform(0, 1, size=(1, 16, 16, 16, CIN)))
    odd = torch.from_numpy(rng.uniform(0, 1, size=(1, 15, 16, 16, CIN)))
    with torch.no_grad():
        a, b = net(x), direct(x)
        assert _rel(a.numpy(), b.numpy()) <= 1e-10
        assert torch.equal(net.stem(odd), direct.stem(odd))


# ---------------------------------------------------------------- joint step

def _tiny_data(H=12, W=10, n_rec=5):
    rng = np.random.default_rng(5)
    cams = synthetic_cameras(8, H, W, seed=3)
    images = rng.uniform(0.0, 1.0, (8, H, W, 3)).astype(np.float32)
    split = {"mic_pose": rng.uniform(-2, 2, (n_rec, 3)),
             "source_pose": rng.uniform(-2, 2, (n_rec, 3)),
             "rot": rng.uniform(0, 1, (n_rec, 3)),
             "log_stft": rng.normal(-3, 0.5, (n_rec, 2, 257, 12))}
    split = {k: v.astype(np.float32) for k, v in split.items()}
    return (camera_arrays(cams, "cpu"), audio_arrays(split, "cpu"),
            {"images": torch.as_tensor(images)})


@pytest.mark.parametrize("mixed", [False, True], ids=["f32", "bf16"])
def test_joint_steps_keep_grid_folded_the_fold_of_grid(mixed, tmp_path):
    """Three steps (the audio branch live from the first): grid_folded is
    fold_grid(grid) in the compute dtype bitwise after each, the stem's
    weight gradient reaches the parameter, and a checkpoint round trip
    into a fresh pipeline refolds it bitwise (no .pt holds it). 32^3: at
    16^3 resnet18's layer3 sees a 1^3 volume and no gradient reaches the
    stem."""
    pipe = build_joint_pipeline(grid_res=32, tiny=True, device="cpu",
                                mixed_precision=mixed)
    pipe.config.trainer.start_step_audio = -1
    dtype = torch.bfloat16 if mixed else torch.float32
    assert pipe.folded_bake and pipe.grid_folded.dtype == dtype
    data = _tiny_data()
    for i in range(3):
        before = pipe.grid_folded.clone()
        m = pipe.train_step(*data)
        assert np.isfinite(list(m.values())).all() and m["audio_mag_loss"] > 0
        assert torch.equal(pipe.grid_folded, pg.fold_grid(pipe.grid, 32, dtype))
        assert not torch.equal(pipe.grid_folded, before), i
        assert float(pipe.resnet.conv1.weight.grad.abs().max()) > 0
    path = save_checkpoint(tmp_path, pipe.step, pipe)
    saved = torch.load(path, map_location="cpu", weights_only=True)
    assert "grid_folded" not in saved and "grid" in saved
    fresh = build_joint_pipeline(grid_res=32, tiny=True, device="cpu",
                                 mixed_precision=mixed, seed=1)
    assert not torch.equal(fresh.grid_folded, pipe.grid_folded)
    restore_checkpoint(path, fresh)
    path.unlink()  # ~280 MB, read no more
    assert torch.equal(fresh.grid, pipe.grid)
    assert torch.equal(fresh.grid_folded, pipe.grid_folded)


def test_bridge_refolds_the_jax_state():
    """build_joint_pipeline(state=...) through bridge.load_joint_state: the
    port's grid_folded is the JAX state's own folded copy, bitwise."""
    from neraf_tpu.engine.pipeline import JointPipeline as JJointPipeline
    from neraf_tpu.models.audio import AudioModel as JAudioModel
    from neraf_tpu.models.vision import VisionModel as JVisionModel
    from neraf_tpu_torch.engine.factory import (
        FAR,
        NEAR,
        NUM_CAMERAS,
        joint_config,
    )
    from test_torch_train_slice import _jax_config

    cfg = _jax_config("fourier")
    feat_dim = JResNet3D(backbone="resnet18", n_features=1024).feature_dim
    jpipe = JJointPipeline(
        config=cfg,
        vision_model=JVisionModel(config=cfg.vision_model,
                                  num_cameras=NUM_CAMERAS, near=NEAR, far=FAR),
        audio_model=JAudioModel(config=cfg.audio_model,
                                grid_feature_dim=feat_dim),
        audio_aabb=jnp.asarray([[-3.0, -3.0, -3.0], [3.0, 3.0, 3.0]]),
        vision_aabb=jnp.asarray([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]]),
        grid_res=16)
    state = jpipe.init_state(seed=3)
    grid = np.asarray(state.grid).copy()
    grid[:, :4] = np.random.default_rng(9).uniform(size=(16 ** 3, 4))
    state = state._replace(grid=jnp.asarray(grid),
                           grid_folded=jg.fold_grid(jnp.asarray(grid), 16,
                                                    jnp.float32))
    port = build_joint_pipeline(grid_res=16, tiny=True, device="cpu",
                                mixed_precision=False, state=state,
                                config=joint_config(tiny=True))
    assert np.array_equal(port.grid_folded.numpy(),
                          np.asarray(state.grid_folded))


@pytest.fixture(scope="module", params=[(8, 128), (32, 32)],
                ids=["grid8_bake128", "grid32_bake32"])
def flat_run(request):
    """Two fourier steps on a geometry where one cursor batch is not one
    slab of the folded volume (the flat path on both sides), from step 2 so
    that the audio branch is live, the grid's rgb and alpha filled first."""
    grid_res, bake = request.param
    return grid_res, bake, _run_steps("fourier", 2, start_step=2,
                                      grid_res=grid_res, bake=bake,
                                      fill_grid=True)


@pytest.mark.parametrize("step", range(2))
def test_flat_geometry_step_matches_jax(flat_run, step):
    """The losses, the grid and the cursor at tests/test_torch_train_slice.py's
    tolerances, and at 32^3 every gradient too. At 8^3 resnet18's layer2
    sees a 1^3 volume, which batch-1 BatchNorm normalises to its bias: the
    ResNet's gradients are float noise around zero on both sides there, so
    its gradients are compared at 32^3, with 32 cells a step (half a z-row,
    not a slab of y pairs)."""
    grid_res, bake, runs = flat_run
    run = runs[step]
    assert not pg.folded_bake_supported(grid_res, bake)
    assert not run["port"]["folded"]
    _check_losses(run, live=True)
    if grid_res == 32:
        _check_gradients(run, live=True)
    j, p = run["jax"], run["port"]
    assert p["cursor"] == j["cursor"] == bake * (step + 1)
    np.testing.assert_allclose(p["grid"], j["grid"], rtol=0,
                               atol=1e-4 * np.abs(j["grid"]).max())
