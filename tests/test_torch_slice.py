"""The port's tiny RIR render slice end to end against the JAX pipeline.

JAX: JointPipeline._render_rirs_impl -> log_to_magnitude -> Griffin-Lim
(the XLA matmul loop), with the audio params as JointPipeline.init_state
builds them. Port: the same weights through the bridge into
build_render_pipeline, the same grid and the same initial angles. f32 on CPU.
"""

import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neraf_tpu.configs.config import (
    AudioModelConfig,
    ExperimentConfig,
    VisionModelConfig,
)
from neraf_tpu.dsp.griffin_lim import _griffin_lim_matmul
from neraf_tpu.dsp.stft import log_to_magnitude as jlog_to_magnitude
from neraf_tpu.engine.pipeline import JointPipeline
from neraf_tpu.models.audio import AudioModel as JAudioModel
from neraf_tpu.models.grid import grid_to_volume, init_grid
from neraf_tpu.models.resnet3d import ResNet3D as JResNet3D
from neraf_tpu.models.vision import VisionModel
from neraf_tpu_torch.dsp.griffin_lim import griffin_lim, random_angles
from neraf_tpu_torch.dsp.stft import log_to_magnitude, stft_magnitude
from neraf_tpu_torch.engine.factory import build_render_pipeline

GRID_RES = 16


@pytest.fixture(scope="module")
def jax_slice():
    """The tiny configuration of __graft_entry__._build_pipeline in f32,
    with a random grid so the scene descriptor is not a constant."""
    cfg = ExperimentConfig(dataset="SoundSpaces")
    cfg.vision_model = VisionModelConfig(
        num_levels=4, log2_hashmap_size=10, base_res=4, max_res=32,
        hidden_dim=16, hidden_dim_color=16, geo_feat_dim=7,
        appearance_embed_dim=4, num_nerf_samples=8,
        num_proposal_samples=(16, 12))
    cfg.audio_model = AudioModelConfig(
        dataset="SoundSpaces", max_len=12, n_freq_stft=257, w_field=32,
        n_features=1024, resnet_backbone="resnet18").resolve()
    cfg.trainer.mixed_precision = False
    feat_dim = JResNet3D(backbone="resnet18", n_features=1024).feature_dim
    pipe = JointPipeline(
        config=cfg,
        vision_model=VisionModel(config=cfg.vision_model, num_cameras=8,
                                 near=0.05, far=1000.0),
        audio_model=JAudioModel(config=cfg.audio_model,
                                grid_feature_dim=feat_dim),
        audio_aabb=jnp.asarray([[-3.0, -3.0, -3.0], [3.0, 3.0, 3.0]]),
        vision_aabb=jnp.asarray([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]]),
        grid_res=GRID_RES)
    # the audio half of JointPipeline.init_state (the vision and optimizer
    # state it also builds take seconds and play no part in the render)
    ka, kr = jax.random.split(jax.random.PRNGKey(0))
    grid = np.asarray(init_grid(GRID_RES)).copy()
    grid[:, :4] = np.random.default_rng(7).uniform(0, 1, (grid.shape[0], 4))
    resnet_vars = pipe.resnet.init(kr, grid_to_volume(jnp.asarray(grid),
                                                      GRID_RES), train=True)
    state = SimpleNamespace(
        params={"audio": {"field": pipe.audio_model.init(ka),
                          "resnet": resnet_vars["params"]}},
        batch_stats=resnet_vars["batch_stats"], grid=jnp.asarray(grid))
    port = build_render_pipeline(
        grid_res=GRID_RES, tiny=True, mixed_precision=False,
        params=state.params, batch_stats=state.batch_stats, grid=grid)
    return pipe, state, port


def _requests(n):
    rng = np.random.default_rng(11)
    mic = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    src = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    rot = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    return mic, src, rot


def _jax_render(pipe, state, mic, src, rot):
    return np.asarray(pipe._render_rirs_impl(
        state.params, state.batch_stats, state.grid, jnp.asarray(mic),
        jnp.asarray(src), jnp.asarray(rot)))


def _jax_gl(cfg, log_pred, ang, n_iter):
    mag = jlog_to_magnitude(jnp.asarray(log_pred))
    return np.asarray(_griffin_lim_matmul(
        mag, jnp.asarray(ang.real.astype(np.float32)),
        jnp.asarray(ang.imag.astype(np.float32)), cfg.n_fft, cfg.hop_len,
        cfg.win_len, n_iter=n_iter, mom=0.99 / 1.99,
        length=cfg.hop_len * (cfg.max_len - 1)))


def test_tiny_slice_matches_jax_end_to_end(jax_slice):
    # log-mags: the resnet and field tolerances (f32, another summation
    # order); waveforms: 4 GL iterations from shared angles, the bound of
    # tests/test_pallas_gl.py
    pipe, state, port = jax_slice
    cfg = port.audio_model.config
    mic, src, rot = _requests(3)
    ref_log = _jax_render(pipe, state, mic, src, rot)
    log = port.render_rirs(mic, src, rot)
    assert log.shape == ref_log.shape == (3, 2, 257, 12)
    np.testing.assert_allclose(log.numpy(), ref_log, atol=1e-4, rtol=0)
    feat = port.grid_feature().numpy()
    ref_feat = np.asarray(pipe._grid_feature_eval_impl(
        state.params, state.batch_stats, state.grid))
    np.testing.assert_allclose(feat, ref_feat, atol=1e-4, rtol=1e-3)

    ang = random_angles(log.shape, torch.Generator().manual_seed(3))
    wav = griffin_lim(log_to_magnitude(log), n_fft=cfg.n_fft,
                      hop_length=cfg.hop_len, win_length=cfg.win_len,
                      n_iter=4, init_angles=ang)
    ref_wav = _jax_gl(cfg, ref_log, ang.numpy(), 4)
    assert wav.shape == ref_wav.shape == (3, 2, cfg.hop_len * 11)
    np.testing.assert_allclose(wav.numpy(), ref_wav, atol=5e-4, rtol=1e-3)


def test_render_waveforms_matches_jax_gl_quality(jax_slice):
    """The served request (32 iterations, angles from the generator) against
    the JAX loop from the same angles: GL amplifies float32 rounding over 32
    iterations, so hold it by the spectral convergence GL minimises (to
    1e-4) and the waveform to 1e-2 of its peak."""
    pipe, state, port = jax_slice
    cfg = port.audio_model.config
    mic, src, rot = _requests(2)
    wav = port.render_waveforms(mic, src, rot, torch.Generator().manual_seed(9))
    ang = random_angles((2, 2, 257, 12), torch.Generator().manual_seed(9))
    ref_log = _jax_render(pipe, state, mic, src, rot)
    ref_wav = _jax_gl(cfg, ref_log, ang.numpy(), 32)
    assert wav.shape == ref_wav.shape and torch.isfinite(wav).all()
    peak = np.abs(ref_wav).max()
    assert peak > 0
    assert np.abs(wav.numpy() - ref_wav).max() <= 1e-2 * peak
    mag = log_to_magnitude(torch.tensor(ref_log))
    sc = [float((stft_magnitude(torch.as_tensor(np.array(w)), cfg.n_fft,
                                cfg.hop_len, cfg.win_len) - mag).norm()
                / mag.norm())
          for w in (wav, ref_wav)]
    assert abs(sc[0] - sc[1]) <= 1e-4, sc


def test_render_rir_chunk_shares_angles(jax_slice):
    _, _, port = jax_slice
    mic, src, rot = _requests(2)
    log = port.render_rirs(mic, src, rot)
    log_pred, mag_pred, mag_gt, wav_pred, wav_gt = port.render_rir_chunk(
        mic, src, rot, log.numpy(), torch.Generator().manual_seed(1))
    torch.testing.assert_close(mag_pred, mag_gt)
    torch.testing.assert_close(wav_pred, wav_gt)  # same angles, same input
    assert wav_pred.shape == (2, 2, 128 * 11)


def test_bridge_raises_on_missing_and_unmapped_keys(jax_slice):
    from neraf_tpu_torch.bridge import load_render_params
    from neraf_tpu_torch.models.audio import AudioModel
    from neraf_tpu_torch.models.resnet3d import ResNet3D

    _, state, port = jax_slice
    resnet = ResNet3D(backbone="resnet18")
    model = AudioModel(port.audio_model.config, resnet.feature_dim)
    audio = state.params["audio"]

    field = {"params": dict(audio["field"]["params"])}
    del field["params"]["trunk_2"]
    params = {"audio": {"field": field, "resnet": audio["resnet"]}}
    with pytest.raises(KeyError, match="missing"):
        load_render_params(resnet, model.field, params, state.batch_stats)

    stats = dict(state.batch_stats)
    stats["extra_bn"] = stats["bn1"]
    with pytest.raises(KeyError, match="unmapped"):
        load_render_params(resnet, model.field,
                           {"audio": dict(audio)}, stats)


def test_port_never_imports_jax():
    """Import every module of the port in a fresh interpreter; only
    neraf_tpu.configs may come in from the JAX package."""
    code = (
        "import importlib, pkgutil, sys, neraf_tpu_torch\n"
        "for m in pkgutil.walk_packages(neraf_tpu_torch.__path__, "
        "'neraf_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax'))\n"
        "ref = sorted(m for m in sys.modules if m.startswith('neraf_tpu.'))\n"
        "assert not bad, bad\n"
        "assert set(ref) <= {'neraf_tpu.configs', 'neraf_tpu.configs.config'}"
        ", ref\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
