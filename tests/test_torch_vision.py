"""The port's vision modules against the JAX package on the same inputs.

Ray ops (contraction, samplers, renderers), image metrics and ray
generation take the same numpy inputs on both sides; the fields and the
model take flax weights bridged into torch. All f32 on the CPU, where the
port's pe_mlp runs its plain version and the JAX fields their XLA chain.
Tolerances, unless a test says otherwise: 1e-5 relative plus 1e-6 absolute
for elementwise ops (float32 ulps of another summation order), 1e-4 for
the fields (f32 MLPs over angles of up to 2^8 turns).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neraf_tpu.data.vision_data import camera_arrays as jcamera_arrays
from neraf_tpu.data.vision_data import generate_rays as jgenerate_rays
from neraf_tpu.fields.nerfacto import NerfactoField as JNerfactoField
from neraf_tpu.fields.nerfacto import ProposalDensityField as JProposal
from neraf_tpu.fields.nerfacto import ProposalFieldSpec
from neraf_tpu.metrics import image as jimage
from neraf_tpu.models.vision import VisionModel as JVisionModel
from neraf_tpu.ops import contraction as jcontraction
from neraf_tpu.ops import render as jrender
from neraf_tpu.ops import samplers as jsamplers
from neraf_tpu_torch.bridge import load_vision_params
from neraf_tpu_torch.data.vision_data import camera_arrays, generate_rays
from neraf_tpu_torch.engine.factory import NUM_CAMERAS, vision_model_config
from neraf_tpu_torch.fields.nerfacto import (
    NerfactoField,
    ProposalDensityField,
    trunc_exp,
)
from neraf_tpu_torch.metrics import image
from neraf_tpu_torch.models.vision import VisionModel
from neraf_tpu_torch.ops import contraction, render, samplers

T = torch.from_numpy


def close(out, ref, rtol=1e-5, atol=1e-6):
    if isinstance(out, torch.Tensor):
        out = out.detach().numpy()
    np.testing.assert_allclose(out, np.asarray(ref), rtol=rtol, atol=atol)


def test_scene_contraction_matches_jax(rng):
    x = rng.normal(0.0, 2.0, (500, 3)).astype(np.float32)
    x[:10] *= 0.1  # inside the unit ball: identity
    close(contraction.scene_contraction(T(x)),
          jcontraction.scene_contraction(jnp.asarray(x)))
    close(contraction.contract_to_unit(T(x)),
          jcontraction.contract_to_unit(jnp.asarray(x)))


def test_spacing_maps_match_jax(rng):
    s = np.concatenate([rng.uniform(0, 1, 200), [0.0, 0.5, 1.0]]).astype(np.float32)
    t = np.concatenate([rng.uniform(0, 50, 200), [0.0, 1.0]]).astype(np.float32)
    close(samplers._spacing_to_euclidean(T(s)),
          jsamplers._spacing_to_euclidean(jnp.asarray(s)))
    close(samplers._euclidean_to_spacing(T(t)),
          jsamplers._euclidean_to_spacing(jnp.asarray(t)))
    bins = np.sort(rng.uniform(0, 1, (6, 9)), -1).astype(np.float32)
    near = rng.uniform(0.01, 0.5, 6).astype(np.float32)
    far = rng.uniform(5.0, 1000.0, 6).astype(np.float32)
    close(samplers.spacing_bins_to_euclidean(T(bins), T(near), T(far)),
          jsamplers.spacing_bins_to_euclidean(jnp.asarray(bins),
                                              jnp.asarray(near), jnp.asarray(far)))


def test_uniform_bins_match_jax():
    out = samplers.uniform_spacing_bins(5, 16)
    ref = jsamplers.uniform_spacing_bins(jax.random.PRNGKey(0), 5, 16,
                                         deterministic=True)
    assert out.shape == (5, 17)
    close(out, ref, rtol=0, atol=1e-7)


def _weights(rng, case, R=64, S=32):
    w = rng.uniform(0, 1, (R, S)).astype(np.float32)
    if case == "near_zero_tail":  # the mass ends early; the tail is ~0
        w[:, S // 3:] = rng.uniform(0, 1e-9, (R, S - S // 3))
    elif case == "one_hot":  # the cdf saturates at 1.0 (ties) past the spike
        w = np.zeros((R, S), np.float32)
        w[np.arange(R), rng.integers(0, S // 2, R)] = 1e3
    elif case == "all_zero":  # the histogram padding alone
        w[:] = 0.0
    return w


@pytest.mark.parametrize("case", ["random", "near_zero_tail", "one_hot",
                                  "all_zero"])
def test_pdf_spacing_bins_matches_jax(rng, case):
    """searchsorted + gather against the masked-reduction inverse CDF."""
    w = _weights(rng, case)
    bins = np.sort(rng.uniform(0, 1, (64, 33)), -1).astype(np.float32)
    bins[:, 0], bins[:, -1] = 0.0, 1.0
    out = samplers.pdf_spacing_bins(T(bins), T(w), 24)
    ref = jsamplers.pdf_spacing_bins(jax.random.PRNGKey(0), jnp.asarray(bins),
                                     jnp.asarray(w), 24, deterministic=True)
    assert out.shape == (64, 25)
    # the interpolation (u - cdf_lo) / (cdf_hi - cdf_lo) magnifies the
    # cumsum's float32 ulps (another summation order) by bin width / cdf step
    close(out, ref, rtol=0, atol=1e-5)
    assert bool((out[:, 1:] >= out[:, :-1]).all())


def test_pdf_spacing_bins_ties_at_cdf_one(rng):
    """A spike of weight makes the padded tail's pdf (~4e-12) vanish below
    float32's ulp of 1: min(1, cumsum) then repeats its value up to the
    last edge, and the search must step over those ties as the masked
    reductions do."""
    w = np.zeros((16, 32), np.float32)
    w[np.arange(16), rng.integers(0, 16, 16)] = 1e7
    bins = np.sort(rng.uniform(0, 1, (16, 33)), -1).astype(np.float32)
    bins[:, 0], bins[:, -1] = 0.0, 1.0
    pdf = (w + 0.01 / 32) / (w + 0.01 / 32).sum(-1, keepdims=True)
    cdf = np.minimum(1.0, np.cumsum(pdf[:, :-1], -1, dtype=np.float32))
    assert (cdf[:, 1:] == cdf[:, :-1]).any(axis=-1).all()
    out = samplers.pdf_spacing_bins(T(bins), T(w), 40)
    ref = jsamplers.pdf_spacing_bins(jax.random.PRNGKey(0), jnp.asarray(bins),
                                     jnp.asarray(w), 40, deterministic=True)
    close(out, ref, rtol=0, atol=1e-5)


def test_bins_to_samples_matches_jax(rng):
    bins = np.sort(rng.uniform(0, 1, (7, 12)), -1).astype(np.float32)
    o = rng.normal(size=(7, 3)).astype(np.float32)
    d = rng.normal(size=(7, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    near = np.full(7, 0.05, np.float32)
    far = np.full(7, 1000.0, np.float32)
    out = samplers.bins_to_samples(T(bins), T(o), T(d), T(near), T(far))
    ref = jsamplers.bins_to_samples(*(jnp.asarray(a) for a in
                                      (bins, o, d, near, far)))
    assert set(out) == set(ref)
    for k in ref:
        close(out[k], ref[k], rtol=1e-5, atol=1e-5)


def test_render_weights_and_accumulation_match_jax(rng):
    dens = rng.uniform(0, 5, (9, 20)).astype(np.float32)
    deltas = rng.uniform(0, 0.3, (9, 20)).astype(np.float32)
    w = render.render_weights(T(dens), T(deltas))
    jw = jrender.render_weights(jnp.asarray(dens), jnp.asarray(deltas))
    close(w, jw)
    close(render.render_accumulation(w), jrender.render_accumulation(jw))


@pytest.mark.parametrize("bg", ["last_sample", "white", "black"])
def test_render_rgb_matches_jax(rng, bg):
    rgb = rng.uniform(0, 1, (9, 20, 3)).astype(np.float32)
    w = rng.uniform(0, 0.05, (9, 20)).astype(np.float32)
    close(render.render_rgb(T(rgb), T(w), bg),
          jrender.render_rgb(jnp.asarray(rgb), jnp.asarray(w), bg))


@pytest.mark.parametrize("method", ["median", "expected"])
def test_render_depth_matches_jax(rng, method):
    w = rng.uniform(0, 0.1, (40, 16)).astype(np.float32)
    steps = np.cumsum(rng.uniform(0.1, 1, (40, 16)), -1).astype(np.float32)
    close(render.render_depth(T(w), T(steps), method),
          jrender.render_depth(jnp.asarray(w), jnp.asarray(steps), method))


def test_psnr_ssim_match_jax(rng):
    a = rng.uniform(0, 1, (24, 20, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    close(image.psnr(T(a), T(b)), jimage.psnr(jnp.asarray(a), jnp.asarray(b)),
          rtol=1e-5)
    close(image.ssim(T(a), T(b)), jimage.ssim(jnp.asarray(a), jnp.asarray(b)),
          rtol=1e-5)
    # identical images: the variance clamps keep SSIM at exactly 1
    assert abs(float(image.ssim(T(a), T(a))) - 1.0) < 1e-6


def test_trunc_exp_gradient_is_clamped():
    x = torch.tensor([-20.0, 0.5, 20.0], requires_grad=True)
    trunc_exp(x).sum().backward()
    close(x.grad, np.exp(np.clip([-20.0, 0.5, 20.0], -15.0, 15.0)), rtol=1e-6)


@pytest.mark.parametrize("distorted", [False, True])
def test_generate_rays_matches_jax(rng, distorted):
    n = 3
    c2w = np.zeros((n, 3, 4), np.float32)
    for i in range(n):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        c2w[i, :, :3], c2w[i, :, 3] = q, rng.normal(size=3)
    cams = SimpleNamespace(
        c2w=c2w, fx=np.full(n, 30.0, np.float32), fy=np.full(n, 28.0, np.float32),
        cx=np.full(n, 16.0, np.float32), cy=np.full(n, 12.0, np.float32),
        distortion=(rng.uniform(-0.05, 0.05, (n, 6)) if distorted
                    else np.zeros((n, 6))).astype(np.float32))
    idx = rng.integers(0, n, 50)
    px, py = rng.integers(0, 32, 50), rng.integers(0, 24, 50)
    arrays = camera_arrays(cams, "cpu")
    assert ("distortion" in arrays) == distorted
    out = generate_rays(arrays, T(idx), T(px), T(py))
    ref = jgenerate_rays(jcamera_arrays(cams), jnp.asarray(idx),
                         jnp.asarray(px), jnp.asarray(py))
    for k in ("origins", "directions"):
        close(out[k], ref[k], rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------- fields


@pytest.fixture(scope="module")
def models():
    """The tiny vision config in f32: the JAX model's init tree bridged into
    the port's VisionModel."""
    cfg = vision_model_config(tiny=True)
    jmodel = JVisionModel(config=cfg, num_cameras=NUM_CAMERAS, near=0.05,
                          far=1000.0)
    params = jmodel.init(jax.random.PRNGKey(3))
    model = VisionModel(cfg, num_cameras=NUM_CAMERAS, near=0.05, far=1000.0)
    load_vision_params(model, params)
    return jmodel, params, model


def test_proposal_field_matches_flax(models, rng):
    jmodel, params, model = models
    pos = rng.normal(0, 3, (40, 7, 3)).astype(np.float32)
    for level in (0, 1):
        out = model.proposal(level)(T(pos))
        ref = jmodel.proposal(level).apply(
            params["proposal_networks"][f"level_{level}"], jnp.asarray(pos))
        assert out.shape == (40, 7)
        close(out, ref, rtol=1e-4, atol=1e-7)
    # the default proposal spec is the one the port builds
    spec = ProposalFieldSpec()
    prop = ProposalDensityField()
    assert (prop.num_frequencies, prop.mlp[0].out_features, len(prop.mlp)) == (
        spec.num_frequencies, spec.mlp_width, spec.mlp_layers + 1)
    assert JProposal(spec=spec).spec == spec


@pytest.mark.parametrize("contract", [True, False])
def test_nerfacto_field_matches_flax(models, rng, contract):
    jmodel, params, model = models
    scale = 3.0 if contract else 0.7  # contract=False: some points leave the box
    pos = rng.normal(0, scale, (64, 3)).astype(np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    cam = rng.integers(0, NUM_CAMERAS, 64)
    field = JNerfactoField(config=jmodel.config, num_cameras=NUM_CAMERAS)
    for avg in (False, True):
        out = model.field(T(pos), T(d), T(cam), contract=contract,
                          use_average_appearance=avg)
        ref = field.apply(params["fields"], jnp.asarray(pos), jnp.asarray(d),
                          jnp.asarray(cam), contract=contract,
                          use_average_appearance=avg)
        close(out["density"], ref["density"], rtol=1e-4, atol=1e-7)
        close(out["rgb"], ref["rgb"], rtol=1e-4, atol=1e-5)
    if not contract:
        outside = np.any(np.abs(pos) >= 1.0, axis=-1)
        assert outside.any() and not out["density"][T(outside)].any()


def _rays(rng, n):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return {"origins": rng.normal(0, 0.3, (n, 3)).astype(np.float32),
            "directions": d / np.linalg.norm(d, axis=-1, keepdims=True),
            "camera_indices": rng.integers(0, NUM_CAMERAS, n).astype(np.int32)}


def test_vision_forward_matches_jax(models, rng):
    """VisionModel.forward(train=False): every output and every level's
    weights and bins. Tolerances: rgb and accumulation 1e-4 absolute,
    expected depth 1e-4 relative; the median depth may differ only where
    the cumulative weight lies within 1e-4 of 0.5."""
    jmodel, params, model = models
    rays = _rays(rng, 48)
    with torch.inference_mode():
        out = model({k: T(v).long() if k == "camera_indices" else T(v)
                     for k, v in rays.items()})
    ref = jax.jit(lambda p, r: jmodel.forward(
        p, r, jax.random.PRNGKey(0), train=False, apply_cam_opt=False))(
        params, {k: jnp.asarray(v) for k, v in rays.items()})
    close(out["rgb"], ref["rgb"], rtol=0, atol=1e-4)
    close(out["accumulation"], ref["accumulation"], rtol=0, atol=1e-4)
    close(out["expected_depth"], ref["expected_depth"], rtol=1e-4, atol=0)
    cum = np.cumsum(np.asarray(ref["weights_list"][-1]), -1)
    ambiguous = np.any(np.abs(cum - 0.5) < 1e-4, axis=-1)
    same = np.isclose(out["depth"].numpy(), np.asarray(ref["depth"]), rtol=1e-4)
    assert (same | ambiguous).all()
    for w, jw in zip(out["weights_list"], ref["weights_list"]):
        close(w, jw, rtol=0, atol=1e-4)
    for (s, e), (js, je) in zip(out["spacing_list"], ref["spacing_list"]):
        close(s, js, rtol=0, atol=1e-5)
        close(e, je, rtol=0, atol=1e-5)


def test_query_density_rgb_matches_jax(models, rng):
    jmodel, params, model = models
    pos = rng.uniform(-1.1, 1.1, (30, 3)).astype(np.float32)
    d = rng.normal(size=(30, 3)).astype(np.float32)
    rgb, dens = model.query_density_rgb(T(pos), T(d))
    jrgb, jdens = jmodel.query_density_rgb(params, jnp.asarray(pos),
                                           jnp.asarray(d))
    close(rgb, jrgb, rtol=1e-4, atol=1e-5)
    close(dens, jdens, rtol=1e-4, atol=1e-7)


def test_bridge_vision_raises_on_missing_and_unmapped_keys(models):
    _, params, model = models
    fields = {"params": dict(params["fields"]["params"])}
    del fields["params"]["head_1"]
    with pytest.raises(KeyError, match="missing"):
        load_vision_params(model, {**params, "fields": fields})
    fields = {"params": {**params["fields"]["params"], "extra": {"kernel": 0}}}
    with pytest.raises(KeyError, match="unmapped"):
        load_vision_params(model, {**params, "fields": fields})
