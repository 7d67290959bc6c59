"""The port's tiny vision render slice end to end against the JAX pipeline.

JAX: JointPipeline.render_image and evaluate_vision over the tiny fourier
vision config, with VisionModel.init's weights. Port: the same weights
through the bridge into build_vision_pipeline, the same cameras, the same
(small, ragged) chunk size. f32 on the CPU.

Tolerances: rgb and accumulation 1e-4 absolute; the median depth may
differ only at pixels whose cumulative weight lies within 1e-4 of 0.5 (the
reference's own weights decide); PSNR and SSIM to 1e-4 relative.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neraf_tpu.configs.config import AudioModelConfig, ExperimentConfig
from neraf_tpu.data.vision_data import camera_arrays as jcamera_arrays
from neraf_tpu.data.vision_data import generate_rays as jgenerate_rays
from neraf_tpu.engine.pipeline import JointPipeline
from neraf_tpu.models.audio import AudioModel as JAudioModel
from neraf_tpu.models.resnet3d import ResNet3D as JResNet3D
from neraf_tpu.models.vision import VisionModel as JVisionModel
from neraf_tpu_torch.data.vision_data import camera_arrays, synthetic_cameras
from neraf_tpu_torch.engine.factory import (
    FAR,
    NEAR,
    NUM_CAMERAS,
    build_vision_pipeline,
    vision_model_config,
)

CHUNK = 40  # not a divisor of the image's rays: the last chunk is ragged


@pytest.fixture(scope="module")
def vision_slice():
    cfg = ExperimentConfig(dataset="SoundSpaces")
    cfg.vision_model = vision_model_config(tiny=True)
    cfg.vision_model.eval_num_rays_per_chunk = CHUNK
    cfg.audio_model = AudioModelConfig(
        dataset="SoundSpaces", max_len=12, n_freq_stft=257, w_field=32,
        n_features=1024, resnet_backbone="resnet18").resolve()
    cfg.trainer.mixed_precision = False
    feat_dim = JResNet3D(backbone="resnet18", n_features=1024).feature_dim
    jmodel = JVisionModel(config=cfg.vision_model, num_cameras=NUM_CAMERAS,
                          near=NEAR, far=FAR)
    pipe = JointPipeline(
        config=cfg, vision_model=jmodel,
        audio_model=JAudioModel(config=cfg.audio_model,
                                grid_feature_dim=feat_dim),
        audio_aabb=jnp.asarray([[-3.0, -3.0, -3.0], [3.0, 3.0, 3.0]]),
        vision_aabb=jnp.asarray([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]]),
        grid_res=16)
    # the vision half of JointPipeline.init_state: render_image reads only it
    state = SimpleNamespace(params=jmodel.init(jax.random.PRNGKey(5)))
    port = build_vision_pipeline(tiny=True, device="cpu",
                                 mixed_precision=False, params=state.params)
    port.config.vision_model.eval_num_rays_per_chunk = CHUNK
    cams = synthetic_cameras(NUM_CAMERAS, 12, 10, seed=4)
    return pipe, state, port, cams


def test_render_image_matches_jax(vision_slice):
    pipe, state, port, cams = vision_slice
    H, W, cam = 12, 10, 3
    out = port.render_image(camera_arrays(cams, "cpu"), cam, H, W)
    ref = pipe.render_image(state, jcamera_arrays(cams), cam, H, W)
    for k, shape in (("rgb", (H, W, 3)), ("depth", (H, W)),
                     ("accumulation", (H, W))):
        assert tuple(out[k].shape) == shape == ref[k].shape, k
    np.testing.assert_allclose(out["rgb"].numpy(), ref["rgb"], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(out["accumulation"].numpy(),
                               ref["accumulation"], rtol=0, atol=1e-4)
    # median depth: the reference's weights on the same rays mark the
    # pixels where the 0.5 crossing is a float32 tie
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    rays = jgenerate_rays(jcamera_arrays(cams),
                          jnp.full((H * W,), cam, jnp.int32),
                          jnp.asarray(xs.reshape(-1)),
                          jnp.asarray(ys.reshape(-1)))
    jout = pipe._render_rays_eval(state.params, rays, True)
    cum = np.cumsum(np.asarray(jout["weights_list"][-1]), -1)
    ambiguous = np.any(np.abs(cum - 0.5) < 1e-4, axis=-1).reshape(H, W)
    same = np.isclose(out["depth"].numpy(), ref["depth"], rtol=1e-4)
    assert (same | ambiguous).all()
    assert not ambiguous.all()


def test_evaluate_vision_matches_jax(vision_slice):
    """PSNR/SSIM over two views against seeded ground truth; the LPIPS
    column is skipped explicitly on both sides (no weights). 16 x 12:
    SSIM's 11 x 11 window needs 11 pixels a side."""
    pipe, state, port, cams = vision_slice
    images = np.random.default_rng(6).uniform(0, 1, (2, 16, 12, 3)).astype(
        np.float32)
    res = port.evaluate_vision(camera_arrays(cams, "cpu"), images)
    ref = pipe.evaluate_vision(state, jcamera_arrays(cams), images)
    for k in ("psnr", "ssim", "psnr_std"):
        np.testing.assert_allclose(res[k], ref[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    assert res["lpips"] is None and ref["lpips"] is None
    assert res["lpips_skipped"] == ref["lpips_skipped"]
    assert set(res) == set(ref)
    assert res["num_rays_per_sec"] > 0 and res["fps"] > 0


def test_render_image_is_chunk_invariant(vision_slice):
    """One chunk or many: the same image (rays are independent)."""
    _, _, port, cams = vision_slice
    arrays = camera_arrays(cams, "cpu")
    small = port.render_image(arrays, 1, 12, 10)
    port.config.vision_model.eval_num_rays_per_chunk = 1 << 15
    try:
        whole = port.render_image(arrays, 1, 12, 10)
    finally:
        port.config.vision_model.eval_num_rays_per_chunk = CHUNK
    for k in small:
        torch.testing.assert_close(small[k], whole[k], rtol=1e-6, atol=1e-6)


def test_synthetic_cameras_geometry():
    cams = synthetic_cameras(5, 512, 512, hfov_deg=90.0, seed=1)
    np.testing.assert_allclose(cams.fx, 256.0)
    np.testing.assert_allclose(cams.cx, 256.0)
    rot = cams.c2w[:, :, :3]
    np.testing.assert_allclose(rot @ rot.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), rot.shape), atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(rot), 1.0, atol=1e-5)
    assert np.abs(cams.c2w[:, :, 3]).max() <= 1.0
