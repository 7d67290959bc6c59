"""The port's hash-grid encoding, hash field, hash model and their bridge
against the JAX package on the same inputs.

The encoding: tables and points made with numpy from a seed go through
neraf_tpu.ops.hashgrid.hash_encoding (XLA on the CPU) and the port's
hash_encoding_plain. Forward to rtol 1e-6 (both sum the 8 weighted corners
as float32 FMAs in the same order, so they agree bitwise but for an ulp);
the table gradient and dx against jax.grad to 1e-5 of each one's peak (sums
in other orders). The field and the model take the JAX init tree through
the bridge, table included, at the tiny hash configuration, to the
tolerances of tests/test_torch_vision.py. The CUDA kernels are held against
the plain version on a card (marked `cuda`, skipped here); flax is
imported inside the tests that use it, so the `cuda` tests also run where
only JAX is installed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neraf_tpu.ops import hashgrid as jhashgrid
from neraf_tpu_torch.bridge import load_vision_params
from neraf_tpu_torch.configs import config as tconfig
from neraf_tpu_torch.engine import factory
from neraf_tpu_torch.fields.nerfacto import NerfactoField
from neraf_tpu_torch.models.vision import VisionModel
from neraf_tpu_torch.ops import hashgrid
from neraf_tpu_torch.ops.cuda import hash_encoding as hash_cuda
from neraf_tpu_torch.utils.profiling import counters

T = torch.from_numpy
# (levels, log2 table rows, base res, max res, features): the tiny grid
# (res 4-32, two dense levels, two hashed), tcnn's L16 x F2 with its
# non-power-of-two growth (1.38...) and the default L8 x F4, at both F, and
# the reference's hash proposal grid (5 levels: the kernels pad a point's
# levels to 8 lanes)
SPECS = [(4, 10, 4, 32, 2), (4, 10, 4, 32, 4), (16, 19, 16, 2048, 2),
         (16, 19, 16, 2048, 4), (8, 19, 16, 2048, 4), (5, 17, 16, 128, 2)]


def _specs(L, lt, base, top, F):
    kw = dict(num_levels=L, log2_hashmap_size=lt, base_res=base, max_res=top,
              features_per_level=F)
    return hashgrid.HashGridSpec(**kw), jhashgrid.HashGridSpec(**kw)


def _inputs(seed, spec, n=400):
    """A table of uniform(-1, 1) features, points in [-0.1, 1.1]^3 (some
    outside the box) with rows at exactly 0 and 1, and a cotangent."""
    rng = np.random.default_rng(seed)
    table = rng.uniform(-1.0, 1.0, (spec.num_levels, spec.table_size,
                                    spec.features_per_level)).astype(np.float32)
    x = rng.uniform(-0.1, 1.1, (n, 3)).astype(np.float32)
    x[:4], x[4:8] = 0.0, 1.0
    x[8, 0], x[9, 1], x[10, 2] = 0.0, 1.0, 0.0
    g = rng.normal(size=(n, spec.out_dim)).astype(np.float32)
    return table, x, g


@pytest.mark.parametrize("L,lt,base,top,F", SPECS + [(1, 12, 8, 8, 2)])
def test_resolutions_match_jax(L, lt, base, top, F):
    spec, jspec = _specs(L, lt, base, top, F)
    np.testing.assert_array_equal(spec.resolutions(), jspec.resolutions())
    assert spec.resolutions().dtype == jspec.resolutions().dtype
    assert (spec.table_size, spec.out_dim, spec.growth_factor) == (
        jspec.table_size, jspec.out_dim, jspec.growth_factor)
    res = jspec.resolutions().astype(np.int64)
    np.testing.assert_array_equal(spec.dense_levels(),
                                  (res + 1) ** 3 <= jspec.table_size)


def test_resolutions_of_the_configs():
    full = hashgrid.HashGridSpec(num_levels=8, features_per_level=4)
    np.testing.assert_array_equal(full.resolutions(),
                                  [16, 32, 64, 128, 256, 512, 1024, 2048])
    np.testing.assert_array_equal(full.dense_levels(), [1, 1, 1, 0, 0, 0, 0, 0])
    tiny = factory.vision_model_config(tiny=True, encoding="hash")
    spec = NerfactoField(tiny).hash.spec
    np.testing.assert_array_equal(spec.resolutions(), [4, 8, 16, 32])
    np.testing.assert_array_equal(spec.dense_levels(), [1, 1, 0, 0])


@pytest.mark.parametrize("L,lt,base,top,F", SPECS)
def test_hash_encoding_matches_jax(L, lt, base, top, F):
    spec, jspec = _specs(L, lt, base, top, F)
    table, x, g = _inputs(L * 7 + F, spec)
    ref = np.asarray(jhashgrid.hash_encoding(jnp.asarray(table), jnp.asarray(x),
                                             jspec))
    jd_table, jdx = jax.grad(
        lambda t, p: jnp.sum(jhashgrid.hash_encoding(t, p, jspec) * g),
        argnums=(0, 1))(jnp.asarray(table), jnp.asarray(x))
    tt, xx = T(table).requires_grad_(), T(x).requires_grad_()
    out = hashgrid.hash_encoding_plain(tt, xx, spec)
    assert out.shape == (x.shape[0], L * F) and out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-6, atol=0)
    (out * T(g)).sum().backward()
    for got, want in ((tt.grad, jd_table), (xx.grad, jdx)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    # clip's gradient: 0 outside the box, as jax.grad gives it at 0 and 1
    outside = (x < 0.0) | (x > 1.0)
    assert outside.any() and not xx.grad.numpy()[outside].any()
    at_bound = (x == 0.0) | (x == 1.0)
    np.testing.assert_array_equal(xx.grad.numpy()[at_bound] == 0,
                                  np.asarray(jdx)[at_bound] == 0)


def test_hash_encoding_keeps_leading_dims_and_dispatches_on_cpu():
    spec, _ = _specs(4, 10, 4, 32, 4)
    table, x, _ = _inputs(1, spec, n=24)
    x3 = T(x).reshape(2, 3, 4, 3)
    out = hashgrid.hash_encoding(T(table), x3, spec)
    assert out.shape == (2, 3, 4, spec.out_dim)
    np.testing.assert_array_equal(
        out.reshape(-1, spec.out_dim).numpy(),
        hashgrid.hash_encoding_plain(T(table), T(x), spec).numpy())


def test_init_hash_table_is_seeded_uniform():
    spec = hashgrid.HashGridSpec(num_levels=3, log2_hashmap_size=12,
                                 features_per_level=4)
    a = hashgrid.init_hash_table(spec, torch.Generator().manual_seed(3))
    b = hashgrid.init_hash_table(spec, torch.Generator().manual_seed(3))
    assert a.shape == (3, 4096, 4) and a.dtype == torch.float32
    assert torch.equal(a, b)
    assert float(a.abs().max()) <= 1e-4 and float(a.std()) > 5e-5


def test_hash_encoding_cuda_rejects_what_the_kernel_does_not_take():
    spec = hashgrid.HashGridSpec(num_levels=4, log2_hashmap_size=10,
                                 features_per_level=4)
    x = torch.zeros(5, 3, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        hash_cuda.hash_encoding_cuda(torch.zeros(4, 1024, 4, device="meta"),
                                     x, spec)
    with pytest.raises(ValueError, match="features"):
        hash_cuda.hash_encoding_cuda(
            torch.zeros(4, 1024, 3, device="meta"), x,
            dataclasses.replace(spec, features_per_level=3))


@pytest.mark.cuda
@pytest.mark.parametrize("L,lt,base,top,F", SPECS)
def test_hash_encoding_kernel_matches_plain_on_card(L, lt, base, top, F):
    """HashEncodingFunction on the card against the plain version's autograd:
    forward to 1e-6 of the peak (the same float32 FMAs in the same order),
    the table gradient to 1e-5 of its peak (atomic order), dx to 1e-5 of
    its peak; one forward and one backward launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    spec, _ = _specs(L, lt, base, top, F)
    table, x, g = _inputs(L * 11 + F, spec, n=3000)
    ref_t, ref_x = T(table).cuda().requires_grad_(), T(x).cuda().requires_grad_()
    ref = hashgrid.hash_encoding_plain(ref_t, ref_x, spec)
    (ref * T(g).cuda()).sum().backward()
    tt, xx = T(table).cuda().requires_grad_(), T(x).cuda().requires_grad_()
    launches = lambda: (counters().get("kernel.hash_fwd", 0),
                        counters().get("kernel.hash_bwd", 0))
    fwd, bwd = launches()
    out = hashgrid.hash_encoding(tt, xx, spec)
    (out * T(g).cuda()).sum().backward()
    torch.cuda.synchronize()
    assert launches() == (fwd + 1, bwd + 1)
    for got, want, tol in ((out, ref, 1e-6), (tt.grad, ref_t.grad, 1e-5),
                           (xx.grad, ref_x.grad, 1e-5)):
        err = float((got - want).detach().abs().max())
        assert err <= tol * float(want.detach().abs().max())
    with torch.no_grad():
        hashgrid.hash_encoding(tt, xx, spec)
    assert launches()[0] == fwd + 2


# ------------------------------------------------------------ field, model


@pytest.fixture(scope="module", params=[2, 4], ids=["F2", "F4"])
def models(request):
    """The tiny hash config (F 2 as the factory gives it, and F 4) in f32:
    the JAX model's init tree bridged into the port's VisionModel."""
    from neraf_tpu.models.vision import VisionModel as JVisionModel

    cfg = factory.vision_model_config(tiny=True, encoding="hash")
    cfg = dataclasses.replace(cfg, features_per_level=request.param)
    jmodel = JVisionModel(config=cfg, num_cameras=factory.NUM_CAMERAS,
                          near=0.05, far=1000.0)
    params = jmodel.init(jax.random.PRNGKey(5))
    # the init table is ~1e-4: scale it so the encoding drives the field
    fields = jax.tree_util.tree_map(lambda a: a, params["fields"])
    fields["params"]["hash"]["table"] = fields["params"]["hash"]["table"] * 1e4
    params = {**params, "fields": fields}
    model = VisionModel(cfg, num_cameras=factory.NUM_CAMERAS, near=0.05,
                        far=1000.0)
    load_vision_params(model, params)
    return jmodel, params, model


def test_bridge_carries_the_table(models):
    _, params, model = models
    table = np.asarray(params["fields"]["params"]["hash"]["table"])
    assert model.field.hash.table.shape == table.shape
    np.testing.assert_array_equal(model.field.hash.table.detach().numpy(), table)


@pytest.mark.parametrize("contract", [True, False])
def test_hash_field_matches_flax(models, rng, contract):
    jmodel, params, model = models
    scale = 3.0 if contract else 0.7
    pos = rng.normal(0, scale, (64, 3)).astype(np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    cam = rng.integers(0, factory.NUM_CAMERAS, 64)
    from neraf_tpu.fields.nerfacto import NerfactoField as JNerfactoField

    field = JNerfactoField(config=jmodel.config, num_cameras=factory.NUM_CAMERAS)
    for avg in (False, True):
        out = model.field(T(pos), T(d), T(cam), contract=contract,
                          use_average_appearance=avg)
        ref = field.apply(params["fields"], jnp.asarray(pos), jnp.asarray(d),
                          jnp.asarray(cam), contract=contract,
                          use_average_appearance=avg)
        np.testing.assert_allclose(out["density"].detach().numpy(),
                                   ref["density"], rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(out["rgb"].detach().numpy(), ref["rgb"],
                                   rtol=1e-4, atol=1e-5)
    assert float(out["density"].detach().std()) > 0  # the encoding moved it


def test_hash_vision_forward_matches_jax(models, rng):
    """VisionModel.forward(train=False) with the hash main field, to
    tests/test_torch_vision.py's tolerances."""
    jmodel, params, model = models
    d = rng.normal(size=(48, 3)).astype(np.float32)
    rays = {"origins": rng.normal(0, 0.3, (48, 3)).astype(np.float32),
            "directions": d / np.linalg.norm(d, axis=-1, keepdims=True),
            "camera_indices": rng.integers(0, 8, 48).astype(np.int32)}
    with torch.inference_mode():
        out = model({k: T(v).long() if k == "camera_indices" else T(v)
                     for k, v in rays.items()})
    ref = jax.jit(lambda p, r: jmodel.forward(
        p, r, jax.random.PRNGKey(0), train=False, apply_cam_opt=False))(
        params, {k: jnp.asarray(v) for k, v in rays.items()})
    for k in ("rgb", "accumulation"):
        np.testing.assert_allclose(out[k].numpy(), ref[k], rtol=0, atol=1e-4)
    np.testing.assert_allclose(out["expected_depth"].numpy(),
                               ref["expected_depth"], rtol=1e-4)
    for w, jw in zip(out["weights_list"], ref["weights_list"]):
        np.testing.assert_allclose(w.numpy(), jw, rtol=0, atol=1e-4)


def test_hash_query_density_rgb_matches_jax(models, rng):
    jmodel, params, model = models
    pos = rng.uniform(-1.1, 1.1, (30, 3)).astype(np.float32)
    d = rng.normal(size=(30, 3)).astype(np.float32)
    rgb, dens = model.query_density_rgb(T(pos), T(d))
    jrgb, jdens = jmodel.query_density_rgb(params, jnp.asarray(pos),
                                           jnp.asarray(d))
    np.testing.assert_allclose(rgb.detach().numpy(), jrgb, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dens.detach().numpy(), jdens, rtol=1e-4,
                               atol=1e-7)


def test_bridge_hash_tree_is_strict(models):
    _, params, model = models
    fields = {"params": dict(params["fields"]["params"])}
    del fields["params"]["hash"]
    with pytest.raises(KeyError, match="missing"):
        load_vision_params(model, {**params, "fields": fields})
    fields = {"params": {**params["fields"]["params"],
                         "hash": {"table": 0, "extra": 0}}}
    with pytest.raises(KeyError, match="unmapped"):
        load_vision_params(model, {**params, "fields": fields})


# ---------------------------------------------------------------- factory


def test_hash_configs_and_refusals(tmp_path):
    from neraf_tpu.models.vision import VisionModel as JVisionModel

    full = factory.vision_model_config(encoding="hash")
    assert (full.encoding, full.num_levels, full.features_per_level,
            full.log2_hashmap_size, full.base_res, full.max_res,
            full.hidden_dim, full.proposal_encoding) == (
        "hash", 8, 4, 19, 16, 2048, 64, "fourier")
    assert factory.joint_config(encoding="hash").vision_model == full
    with pytest.raises(ValueError, match="fourier"):
        factory.vision_model_config(encoding="grid")
    with pytest.raises(ValueError, match="fourier"):
        NerfactoField(dataclasses.replace(full, encoding="grid"))
    # the JAX package cannot build a hash proposal field; the port builds
    # nerfstudio's HashMLPDensityField, one max_res a field
    props = dataclasses.replace(factory.vision_model_config(True, "hash"),
                                proposal_encoding="hash")
    with pytest.raises(AttributeError, match="hash_grad_mode"):
        JVisionModel(config=props, num_cameras=2).init(jax.random.PRNGKey(0))
    model = VisionModel(props, num_cameras=2)
    assert [p.hash.spec for p in model.proposal_networks] == [
        hashgrid.HashGridSpec(num_levels=5, features_per_level=2,
                              log2_hashmap_size=17, base_res=16, max_res=r)
        for r in (128, 256)]
    assert [tuple(p.mlp[0].weight.shape) for p in model.proposal_networks] == [(16, 10)] * 2
    with pytest.raises(ValueError, match="proposal_encoding"):
        VisionModel(dataclasses.replace(props, proposal_encoding="grid"))
    # the published model's fields survive a config.yml round trip, and
    # the defaults leave the file the JAX package's
    cfg = tconfig.ExperimentConfig(dataset="SoundSpaces")
    cfg.vision_model = factory.nerfacto_model_config()
    tconfig.save_config(cfg, tmp_path / "config.yml")
    back = tconfig.load_config(tmp_path / "config.yml").vision_model
    assert back == cfg.vision_model and back.proposal_max_res == (128, 256)
    assert (back.hidden_layers, back.hidden_layers_color) == (1, 2)
    tconfig.save_config(tconfig.ExperimentConfig(), tmp_path / "default.yml")
    assert "proposal_max_res" not in (tmp_path / "default.yml").read_text()


def test_hash_pipelines_build_and_train_the_table():
    """build_vision_pipeline / build_joint_pipeline(encoding="hash"): the
    table is seeded, lies in both of the vision field's Adam groups, and a
    train step moves it (a gradient through the rays and the bake)."""
    vis = factory.build_vision_pipeline(tiny=True, device="cpu",
                                        mixed_precision=False, encoding="hash")
    vis2 = factory.build_vision_pipeline(tiny=True, device="cpu",
                                         mixed_precision=False, encoding="hash")
    table = vis.vision_model.field.hash.table
    assert table.shape == (4, 1024, 2)
    assert torch.equal(table, vis2.vision_model.field.hash.table)
    pipe = factory.build_joint_pipeline(grid_res=8, tiny=True, device="cpu",
                                        mixed_precision=False, encoding="hash")
    table = pipe.vision_model.field.hash.table
    for group in ("fields", "audio_fields"):
        assert any(p is table for p in pipe.optimizers[group].params)
    rng = np.random.default_rng(2)
    from neraf_tpu_torch.data import loader, vision_data

    cams = vision_data.camera_arrays(vision_data.synthetic_cameras(8, 6, 5),
                                     "cpu")
    images = {"images": T(rng.uniform(0, 1, (8, 6, 5, 3)).astype(np.float32))}
    split = loader.audio_arrays(
        {"mic_pose": rng.normal(size=(3, 3)), "source_pose": rng.normal(
            size=(3, 3)), "rot": rng.uniform(size=(3, 3)),
         "log_stft": rng.normal(-3, 1, (3, 2, 257, 12))}, "cpu")
    before = table.detach().clone()
    metrics = pipe.train_step(cams, split, images)
    assert all(np.isfinite(v) for v in metrics.values())
    assert table.grad is not None and bool(table.grad.abs().max() > 0)
    assert not torch.equal(before, table.detach())
