"""The port's training modules against their JAX counterparts, f32 on the
CPU, inputs from numpy with a seed; and a guard on the port's imports and
device defaults.

Tolerances, unless a test states its own: values 1e-6 absolute or relative
where the two packages compute the same f32 expressions, gradients 1e-5 of
each tensor's peak.
"""

import ast
import dataclasses
import inspect
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neraf_tpu.configs import config as jconfig
from neraf_tpu.data import loader as jloader
from neraf_tpu.engine import optimizers as joptimizers
from neraf_tpu.metrics import losses as jlosses
from neraf_tpu.models import camera_opt as jcamera_opt
from neraf_tpu.models import grid as jgrid
from neraf_tpu.models.audio import AudioModel as JAudioModel
from neraf_tpu.models.resnet3d import ResNet3D as JResNet3D
from neraf_tpu.ops import render as jrender
from neraf_tpu.ops import samplers as jsamplers
from neraf_tpu_torch.bridge import load_state_dict, resnet_state_dict
from neraf_tpu_torch.configs import config as tconfig
from neraf_tpu_torch.data import datasets, loader, vision_data
from neraf_tpu_torch.engine import factory, optimizers, pipeline
from neraf_tpu_torch.metrics import losses
from neraf_tpu_torch.models import camera_opt, grid
from neraf_tpu_torch.models.audio import AudioModel
from neraf_tpu_torch.models.resnet3d import ResNet3D
from neraf_tpu_torch.ops import render, samplers

REPO = Path(__file__).resolve().parents[1]
T = lambda a: torch.from_numpy(np.array(a))


def _peak_close(a, b, tol=1e-5, what=""):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=0,
                               atol=tol * max(np.abs(b).max(), 1e-30),
                               err_msg=what)


# ------------------------------------------------------------------ config
@pytest.mark.parametrize("make", [
    lambda m: m.ExperimentConfig(dataset="SoundSpaces"),
    lambda m: m.default_config("SoundSpaces", "office_4"),
    lambda m: m.default_config("SoundSpaces", "apartment_1"),
    lambda m: m.default_config("RAF"),
])
def test_config_matches_jax_field_by_field(make, monkeypatch):
    monkeypatch.delenv("NeRAF_dataset", raising=False)
    monkeypatch.delenv("NeRAF_scene", raising=False)
    ours, ref = make(tconfig), make(jconfig)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.audio_model.n_fft == ref.audio_model.n_fft
    assert (ours.optimizers.audio_fields.warmup_steps
            == ref.optimizers.audio_fields.warmup_steps)


def test_port_imports_no_jax_and_defaults_to_the_card():
    """No module of the port, and not chip_smoke.py,
    scripts/validate_joint_torch.py, scripts/validate_audio_torch.py,
    scripts/full_step_card_vs_cpu.py, scripts/split_mutants_card.py,
    scripts/split_host_cost.py or tests/torch_parallel_ranks.py (which the
    mutant script imports), imports jax or the JAX package (neraf_tpu); the port imports neither
    matplotlib, PIL, torchaudio, yaml, tensorboard, orbax nor ml_dtypes,
    which the card's machine lacks; the public builders, pipelines,
    engines, CLIs and the streaming sampler run on the card unless asked
    for the CPU, and so do a data mesh's ranks (parallel/sharding.py)."""
    others = [REPO / "scripts" / "validate_joint_torch.py",
              REPO / "scripts" / "validate_audio_torch.py",
              REPO / "scripts" / "full_step_card_vs_cpu.py",
              REPO / "scripts" / "split_mutants_card.py",
              REPO / "scripts" / "split_host_cost.py",
              REPO / "tests" / "torch_parallel_ranks.py", REPO / "chip_smoke.py"]
    files = sorted((REPO / "neraf_tpu_torch").rglob("*.py")) + others
    refused = ("jax", "jaxlib", "flax", "optax", "neraf_tpu", "matplotlib",
               "PIL", "torchaudio", "yaml", "tensorboard", "orbax",
               "ml_dtypes")
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                root = name.split(".")[0]
                if root in refused:
                    bad.append(f"{f.relative_to(REPO)}: {name}")
    assert not bad, bad
    assert len(files) > 30
    names = {str(f.relative_to(REPO / "neraf_tpu_torch"))
             for f in files[:-len(others)]}
    assert {"ops/hashgrid.py", "ops/cuda/hash_encoding.py"} <= names
    assert {"dsp/filters.py", "metrics/room_acoustics.py",
            "metrics/evaluators.py", "data/dataparsers.py", "data/datasets.py",
            "data/synthetic.py", "viz/panels.py"} <= names
    assert {"cli/train.py", "cli/evaluate.py", "engine/trainer.py",
            "engine/checkpoints.py", "engine/audio_engine.py",
            "configs/config.py", "configs/yaml_subset.py", "utils/png.py",
            "utils/wav.py", "utils/writer.py", "dsp/resample.py",
            "data/streaming.py", "metrics/lpips_impl.py",
            "parallel/__init__.py", "parallel/sharding.py",
            "parallel/depth_split.py"} <= names
    from neraf_tpu_torch.cli import evaluate as cli_evaluate
    from neraf_tpu_torch.cli import train as cli_train
    from neraf_tpu_torch.data.streaming import StreamingAudioSampler
    from neraf_tpu_torch.engine.audio_engine import AudioEngine

    for fn in (factory.build_render_pipeline, factory.build_vision_pipeline,
               factory.build_joint_pipeline, factory.build_pipeline,
               pipeline.RenderPipeline, pipeline.VisionPipeline,
               pipeline.JointPipeline, AudioEngine, cli_train.main,
               cli_evaluate.main, vision_data.camera_arrays,
               loader.audio_arrays, datasets.AudioSliceDataset.slice_arrays,
               StreamingAudioSampler):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    # a mesh's ranks default to the cards: none here
    from neraf_tpu_torch.parallel.sharding import make_mesh

    with pytest.raises(ValueError, match="requested 2 devices, have 0"):
        make_mesh(2, rank=0)
    for name in ("render_rirs", "eval_loss_dict", "eval_image", "render_image",
                 "evaluate_vision", "query_grid_full", "evaluate_audio",
                 "evaluate_audio_device"):
        assert callable(getattr(pipeline.JointPipeline, name)), name


# ---------------------------------------------------------------- samplers
def test_jittered_samplers_match_jax():
    """Single-jitter uniform and PDF bins from the uniforms JAX draws."""
    R, S0, S1 = 40, 24, 10
    k0, k1 = jax.random.split(jax.random.PRNGKey(7))
    jb = jsamplers.uniform_spacing_bins(k0, R, S0, single_jitter=True)
    u0 = np.array(jax.random.uniform(k0, (R, 1)))
    b = samplers.uniform_spacing_bins(R, S0, jitter=T(u0))
    # two f32 ulps below 1: jnp.linspace and torch.linspace round the edges
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=0, atol=2.4e-7)
    assert b[:, 0].eq(0).all() and b[:, -1].eq(1).all()
    w = np.random.default_rng(0).exponential(size=(R, S0)).astype(np.float32)
    w[:5] = 0.0  # all-zero rows: the padding alone decides
    jp = jsamplers.pdf_spacing_bins(k1, jb, jnp.asarray(w), S1,
                                    single_jitter=True)
    u1 = np.array(jax.random.uniform(k1, (R, 1)))
    p = samplers.pdf_spacing_bins(b, T(w), S1, jitter=T(u1))
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=0, atol=2e-6)
    assert (p.diff(dim=-1) >= 0).all()


def test_per_edge_jittered_samplers_match_jax():
    """use_single_jitter=False: uniform and PDF bins from one uniform per
    bin edge, the uniforms JAX draws, at the single-jitter test's bounds."""
    R, S0, S1 = 40, 24, 10
    k0, k1 = jax.random.split(jax.random.PRNGKey(11))
    jb = jsamplers.uniform_spacing_bins(k0, R, S0, single_jitter=False)
    u0 = np.array(jax.random.uniform(k0, (R, S0 + 1)))
    b = samplers.uniform_spacing_bins(R, S0, jitter=T(u0))
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=0, atol=2.4e-7)
    assert b[:, 0].eq(0).all() and b[:, -1].eq(1).all()
    # the edges move independently: not one shift for the whole ray
    assert (b[:, 1:-1] - torch.linspace(0, 1, S0 + 1)[1:-1]).std(dim=1).min() > 0
    w = np.random.default_rng(4).exponential(size=(R, S0)).astype(np.float32)
    w[:5] = 0.0
    jp = jsamplers.pdf_spacing_bins(k1, jb, jnp.asarray(w), S1,
                                    single_jitter=False)
    u1 = np.array(jax.random.uniform(k1, (R, S1 + 1)))
    p = samplers.pdf_spacing_bins(b, T(w), S1, jitter=T(u1))
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=0, atol=2e-6)
    assert (p.diff(dim=-1) >= 0).all()


@pytest.mark.parametrize("single", [True, False])
def test_draws_follow_use_single_jitter(single):
    """JointPipeline.draw: (R, 1) uniforms a sampler with use_single_jitter,
    else one per bin edge of each sampler, (R, S + 1)."""
    cfg = factory.joint_config(tiny=True)
    cfg.vision_model = dataclasses.replace(cfg.vision_model,
                                           use_single_jitter=single)
    pipe = factory.build_joint_pipeline(grid_res=8, tiny=True, device="cpu",
                                        mixed_precision=False, config=cfg)
    d = pipe.draw(2, 6, 5, 3)
    R = cfg.vision_data.train_rays_per_batch
    (p0, p1), n = cfg.vision_model.num_proposal_samples, \
        cfg.vision_model.num_nerf_samples
    want = (1, 1, 1) if single else (p0 + 1, p1 + 1, n + 1)
    assert tuple(d[k].shape for k in ("u_init", "u_pdf0", "u_pdf1")) == tuple(
        (R, k) for k in want)
    assert all(float(d[k].min()) >= 0 and float(d[k].max()) < 1
               for k in ("u_init", "u_pdf0", "u_pdf1"))


# ------------------------------------------------------------------ losses
def test_interlevel_and_distortion_losses_match_jax():
    """Values, and gradients with respect to the proposal weights (the
    interlevel loss's only live input) and the final weights (distortion)."""
    rng = np.random.default_rng(1)
    R, S0, S1 = 30, 12, 20
    edges = lambda n: np.sort(np.concatenate(
        [np.zeros((R, 1)), rng.uniform(0, 1, (R, n - 1)), np.ones((R, 1))],
        -1), -1).astype(np.float32)
    e0, e1 = edges(S0), edges(S1)
    w0 = rng.uniform(0, 0.2, (R, S0)).astype(np.float32)
    w1 = rng.uniform(0, 0.2, (R, S1)).astype(np.float32)

    def jloss(w0, w1):
        inter = jrender.interlevel_loss(w0, e0[:, :-1], e0[:, 1:], w1,
                                        e1[:, :-1], e1[:, 1:])
        return inter, jrender.distortion_loss(w0, e0[:, :-1], e0[:, 1:])

    (ji, jd) = jloss(jnp.asarray(w0), jnp.asarray(w1))
    jgi = jax.grad(lambda a: jloss(jnp.asarray(w0), a)[0])(jnp.asarray(w1))
    jgd = jax.grad(lambda a: jloss(a, jnp.asarray(w1))[1])(jnp.asarray(w0))
    tw0, tw1 = T(w0).requires_grad_(), T(w1).requires_grad_()
    ti = render.interlevel_loss(tw0, T(e0[:, :-1]), T(e0[:, 1:]), tw1,
                                T(e1[:, :-1]), T(e1[:, 1:]))
    td = render.distortion_loss(tw0, T(e0[:, :-1]), T(e0[:, 1:]))
    np.testing.assert_allclose(float(ti.detach()), float(ji), rtol=1e-5)
    np.testing.assert_allclose(float(td.detach()), float(jd), rtol=1e-5)
    gi, = torch.autograd.grad(ti, tw1, retain_graph=True)
    assert torch.autograd.grad(ti, tw0, allow_unused=True)[0] is None
    gd, = torch.autograd.grad(td, tw0)
    _peak_close(gi.numpy(), jgi, 1e-5, "interlevel")
    _peak_close(gd.numpy(), jgd, 1e-5, "distortion")


def test_stft_and_audio_losses_match_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(-3, 1, (16, 2, 33)).astype(np.float32)
    y = rng.normal(-3, 1, (16, 2, 33)).astype(np.float32)
    for kind in ("l1", "mse"):
        ref = jlosses.stft_loss(jnp.asarray(x), jnp.asarray(y), kind)
        out = losses.stft_loss(T(x), T(y), kind)
        for k in ref:
            np.testing.assert_allclose(float(out[k]), float(ref[k]), rtol=1e-6)
    cfg = tconfig.AudioModelConfig(max_len=12, w_field=32).resolve()
    jcfg = jconfig.AudioModelConfig(max_len=12, w_field=32).resolve()
    ref = JAudioModel(config=jcfg).loss(jnp.asarray(x), jnp.asarray(y))
    xt = T(x).requires_grad_()
    out = AudioModel(cfg).loss(xt, T(y))
    assert set(out) == set(ref) == {"audio_sc_loss", "audio_mag_loss"}
    for k in ref:
        np.testing.assert_allclose(float(out[k]), float(ref[k]), rtol=1e-6)
    jg = jax.grad(lambda a: sum(JAudioModel(config=jcfg).loss(
        a, jnp.asarray(y)).values()))(jnp.asarray(x))
    g, = torch.autograd.grad(sum(out.values()), xt)
    _peak_close(g.numpy(), jg, 1e-5)


# -------------------------------------------------------------- camera opt
@pytest.mark.parametrize("scale", [0.0, 1e-9, 0.3])
def test_camera_opt_matches_jax(scale):
    """exp_map_so3 and apply_camera_opt, values and gradients, at the zero
    initialisation (a zero, not NaN, gradient of the norm), below the
    small-angle switch, and away from it."""
    rng = np.random.default_rng(3)
    params = (rng.normal(size=(4, 6)) * scale).astype(np.float32)
    idx = rng.integers(0, 4, 25)
    o = rng.normal(size=(25, 3)).astype(np.float32)
    d = rng.normal(size=(25, 3)).astype(np.float32)
    r = rng.normal(size=(25, 6)).astype(np.float32)

    def jf(p):
        no, nd = jcamera_opt.apply_camera_opt(p, jnp.asarray(idx),
                                              jnp.asarray(o), jnp.asarray(d))
        return jnp.sum(jnp.concatenate([no, nd], -1) * r)

    pt = T(params).requires_grad_()
    no, nd = camera_opt.apply_camera_opt(pt, T(idx), T(o), T(d))
    jno, jnd = jcamera_opt.apply_camera_opt(jnp.asarray(params),
                                            jnp.asarray(idx), jnp.asarray(o),
                                            jnp.asarray(d))
    np.testing.assert_allclose(no.detach().numpy(), np.asarray(jno), atol=1e-6)
    np.testing.assert_allclose(nd.detach().numpy(), np.asarray(jnd), atol=1e-6)
    np.testing.assert_allclose(
        camera_opt.exp_map_so3(pt[:, :3]).detach().numpy(),
        np.asarray(jcamera_opt.exp_map_so3(jnp.asarray(params[:, :3]))),
        atol=1e-6)
    (torch.cat([no, nd], -1) * T(r)).sum().backward()
    jg = jax.grad(jf)(jnp.asarray(params))
    assert torch.isfinite(pt.grad).all()
    _peak_close(pt.grad.numpy(), jg, 1e-5)


# ------------------------------------------------------------------- data
def test_gather_audio_batch_matches_jax():
    rng = np.random.default_rng(4)
    arrays = {"mic_pose": rng.normal(size=(6, 3)),
              "source_pose": rng.normal(size=(6, 3)),
              "rot": rng.uniform(size=(6, 3)),
              "log_stft": rng.normal(size=(6, 2, 9, 7))}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    rec, t = rng.integers(0, 6, 11), rng.integers(0, 7, 11)
    ref = jloader.gather_audio_batch({k: jnp.asarray(v) for k, v in
                                      arrays.items()}, jnp.asarray(rec),
                                     jnp.asarray(t))
    out = loader.gather_audio_batch(loader.audio_arrays(arrays, "cpu"), T(rec),
                                    T(t))
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]), k)
    gen = torch.Generator().manual_seed(0)
    b = loader.sample_audio_batch(loader.audio_arrays(arrays, "cpu"), 50, 7, gen)
    assert b["data"].shape == (50, 2, 9) and int(b["time_query"].max()) < 7
    cam, py, px = vision_data.sample_pixel_batch(3, 5, 4, 200, gen)
    assert cam.shape == py.shape == px.shape == (200,)
    assert int(cam.max()) < 3 and int(py.max()) < 5 and int(px.max()) < 4


# ------------------------------------------------------------------- bake
def test_viewing_directions_and_cells_match_jax():
    np.testing.assert_array_equal(grid.fixed_viewing_directions().numpy(),
                                  np.asarray(jgrid.fixed_viewing_directions()))
    np.testing.assert_array_equal(grid.single_viewing_direction().numpy(),
                                  np.asarray(jgrid.single_viewing_direction()))
    np.testing.assert_array_equal(grid.cell_centers(4), jgrid.cell_centers(4))


def test_bake_matches_jax_and_wraps():
    """compute_fresh_cells through one differentiable query (a small
    analytic field), bake_cells with the cursor wrapping, and the gradient
    reaching the query's parameter only through the fresh cells."""
    res, B = 4, 16
    rng = np.random.default_rng(5)
    A = rng.normal(size=(3, 3)).astype(np.float32)
    c = rng.normal(size=3).astype(np.float32)
    aabb = np.array([[-1.0] * 3, [1.0] * 3], np.float32)
    g0 = np.asarray(jgrid.init_grid(res)) + rng.normal(size=(res ** 3, 7)).astype(
        np.float32) * np.array([1, 1, 1, 1, 0, 0, 0], np.float32)
    cursor = res ** 3 - B  # the last batch: the cursor wraps to 0
    wsum = rng.normal(size=g0.shape).astype(np.float32)

    def jquery(theta):
        def q(pos, dirs):
            rgb = jax.nn.sigmoid(pos @ A + dirs * theta)
            return rgb, jax.nn.softplus(pos @ c) * theta
        return q

    def jtotal(theta):
        fresh = jgrid.compute_fresh_cells(
            jquery(theta), jnp.int32(cursor), jnp.asarray(grid.cell_centers(res)),
            jnp.asarray(aabb), B, jgrid.fixed_viewing_directions())
        new, cur = jgrid.bake_cells(jnp.asarray(g0), jnp.int32(cursor), fresh)
        return jnp.sum(new * wsum), (new, cur)

    (jv, (jnew, jcur)), jg = jax.value_and_grad(jtotal, has_aux=True)(
        jnp.float32(0.7))
    theta = torch.tensor(0.7, requires_grad=True)
    At, ct = T(A), T(c)
    q = lambda pos, dirs: (torch.sigmoid(pos @ At + dirs * theta),
                           torch.nn.functional.softplus(pos @ ct) * theta)
    fresh = grid.compute_fresh_cells(q, cursor, T(grid.cell_centers(res)),
                                     T(aabb), B, grid.fixed_viewing_directions())
    g0t = T(g0).requires_grad_()
    new, cur = grid.bake_cells(g0t, cursor, fresh)
    assert cur == int(jcur) == 0
    np.testing.assert_allclose(new.detach().numpy(), np.asarray(jnew), atol=1e-6)
    assert torch.equal(new[:cursor], g0t[:cursor]) and torch.equal(
        new[cursor:, 4:], g0t[cursor:, 4:])
    (new * T(wsum)).sum().backward()
    np.testing.assert_allclose(float(theta.grad), float(jg), rtol=1e-5)
    assert g0t.grad is None  # the carried grid is a constant


# ----------------------------------------------------------------- ResNet
def test_train_mode_resnet18_matches_flax():
    """Train-mode ResNet18 over a tie-free 32^3 grid: the output, the input
    gradient and flax's running-statistics update (momentum 0.9, biased
    variance), and no update while update_stats is off. f32 convolutions
    over 8 blocks: 1e-4 of the peak."""
    rng = np.random.default_rng(6)
    x = rng.uniform(0, 1, (1, 32, 32, 32, 7)).astype(np.float32)
    r = rng.normal(size=(1, 256)).astype(np.float32)
    jmodel = JResNet3D(backbone="resnet18", n_features=1024)
    variables = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x), train=True)

    def jf(xx):
        feat, mut = jmodel.apply(variables, xx, train=True,
                                 mutable=["batch_stats"])
        return jnp.sum(feat * r), (feat, mut["batch_stats"])

    (_, (jfeat, jstats)), jdx = jax.value_and_grad(jf, has_aux=True)(
        jnp.asarray(x))
    model = ResNet3D(backbone="resnet18", n_features=1024)
    load_state_dict(model, resnet_state_dict(variables["params"],
                                             variables["batch_stats"]))
    model.train()
    model.set_update_stats(False)
    xt = T(x).requires_grad_()
    model(xt)
    for v in resnet_state_dict(variables["params"],
                               variables["batch_stats"]).items():
        if "running" in v[0]:
            assert torch.equal(model.state_dict()[v[0]], v[1])
    model.set_update_stats(True)
    feat = model(xt)
    (feat * T(r)).sum().backward()
    _peak_close(feat.detach().numpy(), jfeat, 1e-4, "features")
    _peak_close(xt.grad.numpy(), jdx, 1e-4, "input gradient")
    assert float(np.abs(np.asarray(jdx)).max()) > 0
    want = resnet_state_dict(variables["params"], jstats)
    for k, v in model.state_dict().items():
        if "running" in k:
            _peak_close(v.numpy(), want[k].numpy(), 1e-4, k)
    # the biased variance: the first BN's var moved to 0.9 + 0.1 var_biased
    assert not torch.allclose(model.bn1.running_var, torch.ones(64))


# ------------------------------------------------------------- optimizers
def test_schedule_and_adam_match_optax():
    """The warmup + exponential-decay schedule, and five Adam(eps 1e-15)
    updates of ScheduledAdam against optax's chain (scale_by_adam,
    scale_by_schedule) on the same gradients: 1e-6 relative."""
    cfg = tconfig.OptimizerGroupConfig(lr=1e-3, lr_final=1e-5, max_steps=50,
                                       warmup_steps=3)
    jcfg = jconfig.OptimizerGroupConfig(lr=1e-3, lr_final=1e-5, max_steps=50,
                                        warmup_steps=3)
    sched = optimizers.exponential_decay_schedule(1e-3, 1e-5, 50, 3)
    jsched = joptimizers.exponential_decay_schedule(1e-3, 1e-5, 50, 3)
    for s in range(0, 60, 3):
        np.testing.assert_allclose(sched(s), float(jsched(s)), rtol=1e-6)
    rng = np.random.default_rng(8)
    p0 = rng.normal(size=(5, 4)).astype(np.float32)
    grads = rng.normal(size=(5, 5, 4)).astype(np.float32)
    opt = joptimizers.make_optimizer(jcfg)
    jp, st = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    p = torch.nn.Parameter(T(p0))
    adam = optimizers.ScheduledAdam([p], cfg)
    for g in grads:
        upd, st = opt.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
        p.grad = T(g)
        adam.step()
    assert adam.count == 5
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-9)


def test_joint_pipeline_optimizer_groups():
    """Four groups; the vision field is in both `fields` and `audio_fields`
    and takes both updates; every group steps every step, masked audio or
    not (a parameter without a gradient steps with a zero one)."""
    pipe = factory.build_joint_pipeline(grid_res=8, tiny=True, device="cpu",
                                        mixed_precision=False)
    opts = pipe.optimizers
    assert set(opts) == {"proposal_networks", "fields", "camera_opt",
                         "audio_fields"}
    field = {id(p) for p in pipe.vision_model.field.parameters()}
    audio = {id(p) for p in opts["audio_fields"].params}
    assert field <= audio and field == {id(p) for p in opts["fields"].params}
    assert {id(p) for p in pipe.resnet.parameters()} <= audio
    assert {id(p) for p in pipe.audio_model.parameters()} <= audio
    assert [id(p) for p in opts["camera_opt"].params] == [
        id(pipe.vision_model.camera_opt)]
    w = pipe.vision_model.field.base_out.bias
    before = w.detach().clone()
    w.grad = torch.ones_like(w)
    for name in ("fields", "audio_fields"):
        opts[name].step()
    # Adam's first update is lr * sign(g) in each group
    lr = opts["fields"].schedule(0) + opts["audio_fields"].schedule(0)
    np.testing.assert_allclose((before - w.detach()).numpy(), lr, rtol=1e-4)
    assert opts["camera_opt"].count == 0 and opts["fields"].count == 1


def test_bake_divisibility_asserted():
    with pytest.raises(AssertionError, match="must divide"):
        cfg = factory.joint_config(tiny=True)
        cfg.trainer.grid_bake_cells_per_step = 100
        from neraf_tpu_torch.engine.pipeline import JointPipeline
        from neraf_tpu_torch.models.vision import VisionModel

        acfg = cfg.audio_model
        resnet = ResNet3D(backbone=acfg.resnet_backbone)
        JointPipeline(cfg, VisionModel(cfg.vision_model, 8),
                      AudioModel(acfg, resnet.feature_dim), resnet,
                      factory.AUDIO_AABB, factory.VISION_AABB, 8,
                      device="cpu")


def test_train_step_draws_its_own_randoms():
    """Without `draws` the pipeline samples from its generator: same seed,
    same metrics; the cursor and step advance; the masked audio losses are
    0 until step > start_step_audio."""
    rng = np.random.default_rng(9)
    cams = vision_data.camera_arrays(vision_data.synthetic_cameras(8, 6, 5),
                                     "cpu")
    images = {"images": T(rng.uniform(0, 1, (8, 6, 5, 3)).astype(np.float32))}
    split = loader.audio_arrays(
        {"mic_pose": rng.normal(size=(3, 3)), "source_pose": rng.normal(
            size=(3, 3)), "rot": rng.uniform(size=(3, 3)),
         "log_stft": rng.normal(-3, 1, (3, 2, 257, 12))}, "cpu")
    runs = []
    for _ in range(2):
        pipe = factory.build_joint_pipeline(grid_res=8, tiny=True,
                                            device="cpu",
                                            mixed_precision=False, seed=4)
        runs.append([pipe.train_step(cams, split, images) for _ in range(3)])
    assert runs[0] == runs[1]
    assert pipe.step == 3 and pipe.cursor == (3 * 256) % 512
    assert [m["audio_mag_loss"] == 0.0 for m in runs[0]] == [True, True, False]
    assert all(np.isfinite(v) for m in runs[0] for v in m.values())
