"""The port's JointPipeline eval paths against the JAX JointPipeline's, on
the CPU in float32.

Both start from one JAX init_state (the port through build_joint_pipeline's
bridge) at test_torch_train_slice.py's tiny size: tiny vision (fourier),
resnet18 over a 32^3 grid, w_field 32, with T 60 here (a synthetic GT of
60 x 128 samples decays past the 35 dB that T60 needs; T 12 does not).
The state is made non-trivial without a train step: every grid cell's
rgb and alpha and every BatchNorm statistic drawn from a numpy seed. The
eval split is data/synthetic.py::synth_scene's (5 RIRs, 2 chunks of 3, the
second ragged); the image views are make_cameras' sphere. The port is
handed the draws and Griffin-Lim angles the JAX paths make from their
keys (pipeline.py:458-467, griffin_lim.py:89-90).

Tolerances: eval_loss_dict's losses and quick metrics 1e-5 relative (the
interlevel and distortion terms also 1e-5 of the total, as the train
step's test); eval_image PSNR and SSIM atol 1e-4, panels atol 1e-6,
audio_mag 1e-5 relative, the rendered rgb atol 1e-4, accumulation atol
1e-3 (measured 2.8e-4 at 2 of 144 pixels: the PDF resampling on these
orbit views is that sensitive to float32 rounding; the render itself is
held at 1e-4 by test_torch_vision_slice.py), depth 1e-4 relative (a pixel whose log-magnitude sits within the
log-magnitudes' 1e-4 of a viridis bin edge may take the neighbouring
table entry: 1 pixel of the 2 x 257 x 60 did); query_grid_full 1e-4 of
each channel's peak, or 2^-23 where that is less (alpha = 1 - exp(-1e-2
density) is ~1e-4 here, below a float32 ulp of 1 after the subtraction);
evaluate_vision PSNR atol 1e-4; per chunk, the log-magnitudes at
test_torch_slice.py's 1e-4 and the magnitudes at 1e-4 relative. The sweeps'
metric dicts: C50 and audio_mag rtol 1e-3, T60 and EDT rtol 1e-2 with
equal invalid counts, as 32 Griffin-Lim iterations amplify float32
rounding: on these inputs the waveforms differ by up to ~1e-3 of their
peak. Measured gaps, relative: host sweep T60 and EDT 0 (3 of 5
instances invalid on both sides), C50 4.2e-6 (its std); device sweep T60
7.5e-8 (1 of 5 invalid), EDT 0, C50 2.0e-7, audio_mag 2.0e-6.

One more test (port only) checks that the eval paths leave the train
state, and the next train_step's metrics, bitwise as they would be
without them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neraf_tpu.configs.config import AudioModelConfig
from neraf_tpu.data.vision_data import camera_arrays as jcamera_arrays
from neraf_tpu.data.vision_data import sample_pixel_batch as jsample_pixel_batch
from neraf_tpu.engine.pipeline import JointPipeline as JJointPipeline
from neraf_tpu.models.audio import AudioModel as JAudioModel
from neraf_tpu.models.resnet3d import ResNet3D as JResNet3D
from neraf_tpu.models.vision import VisionModel as JVisionModel
from neraf_tpu_torch.data.synthetic import make_cameras, synth_scene
from neraf_tpu_torch.data.vision_data import camera_arrays
from neraf_tpu_torch.viz.panels import VIRIDIS
from neraf_tpu_torch.engine.factory import (
    FAR,
    NEAR,
    NUM_CAMERAS,
    build_joint_pipeline,
    joint_config,
)
from scripts.validate_learning import synth_scene as jsynth_scene
from test_torch_train_slice import _jax_config

GRID_RES, T, N_EVAL, CHUNK, SIZE = 32, 60, 5, 3, 12


def _audio_config():
    return AudioModelConfig(
        dataset="SoundSpaces", max_len=T, n_freq_stft=257, w_field=32,
        n_features=1024, resnet_backbone="resnet18").resolve()


def _randomized(state, seed=21):
    """The state with every grid cell's rgb and alpha and every BatchNorm
    statistic drawn from a numpy seed (mean N(0, 0.1), var U(0.5, 1.5))."""
    rng = np.random.default_rng(seed)
    grid = np.array(state.grid)
    grid[:, :4] = rng.uniform(0.0, 1.0, (grid.shape[0], 4))

    def stat(path, leaf):
        if path[-1].key == "mean":
            return jnp.asarray(rng.normal(0.0, 0.1, leaf.shape), jnp.float32)
        return jnp.asarray(rng.uniform(0.5, 1.5, leaf.shape), jnp.float32)

    stats = jax.tree_util.tree_map_with_path(stat, state.batch_stats)
    return state._replace(grid=jnp.asarray(grid), batch_stats=stats)


@pytest.fixture(scope="module")
def pipes():
    cfg = _jax_config("fourier")
    cfg.audio_model = _audio_config()
    feat_dim = JResNet3D(backbone="resnet18", n_features=1024).feature_dim
    jpipe = JJointPipeline(
        config=cfg,
        vision_model=JVisionModel(config=cfg.vision_model,
                                  num_cameras=NUM_CAMERAS, near=NEAR, far=FAR),
        audio_model=JAudioModel(config=cfg.audio_model,
                                grid_feature_dim=feat_dim),
        audio_aabb=jnp.asarray([[-3.0, -3.0, -3.0], [3.0, 3.0, 3.0]]),
        vision_aabb=jnp.asarray([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]]),
        grid_res=GRID_RES)
    state = _randomized(jpipe.init_state(seed=3))
    pcfg = joint_config(tiny=True)
    pcfg.audio_model = _audio_config()
    port = build_joint_pipeline(grid_res=GRID_RES, tiny=True, device="cpu",
                                mixed_precision=False, state=state,
                                config=pcfg)
    cams, images = make_cameras(NUM_CAMERAS, size=SIZE)
    ds, jds = synth_scene(N_EVAL, max_len=T, seed=1), jsynth_scene(
        N_EVAL, max_len=T, seed=1)
    return {"jpipe": jpipe, "state": state, "port": port, "cams": cams,
            "images": images, "ds": ds, "jds": jds}


def _close(a, b, rtol, what, atol=0.0):
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=what)


def _jax_angles(key, shape):
    """The unit phasors JAX's griffin_lim starts from (griffin_lim.py:89-90)."""
    ang0 = jax.random.uniform(key, shape, dtype=jnp.float32) * (2 * jnp.pi)
    return np.asarray(jnp.cos(ang0)) + 1j * np.asarray(jnp.sin(ang0))


def test_eval_loss_dict_matches_jax(pipes):
    p, port, state = pipes["jpipe"], pipes["port"], pipes["state"]
    images = pipes["images"]
    key = jax.random.PRNGKey(5)
    jout = p.eval_loss_dict(state, jcamera_arrays(pipes["cams"]),
                            pipes["jds"].slice_arrays(),
                            {"images": jnp.asarray(images)}, key)
    k_pix, k_aud, _ = jax.random.split(key, 3)
    R = p.config.vision_data.eval_rays_per_batch
    cam, py, px = jsample_pixel_batch(k_pix, NUM_CAMERAS, SIZE, SIZE, R)
    B = p.config.audio_data.batch_size
    idx = np.array(jax.random.randint(k_aud, (B,), 0, N_EVAL * T))
    draws = {"cam": np.array(cam), "py": np.array(py), "px": np.array(px),
             "rec": idx // T, "t": idx % T}
    out = port.eval_loss_dict(camera_arrays(pipes["cams"], "cpu"),
                              pipes["ds"].slice_arrays("cpu"),
                              {"images": torch.from_numpy(images)}, draws)
    assert set(out) == set(jout) == {
        "rgb_loss", "interlevel_loss", "distortion_loss", "audio_sc_loss",
        "audio_mag_loss", "audio_mag"}
    for k, v in jout.items():
        atol = (1e-5 * (jout["rgb_loss"] + jout["audio_mag_loss"])
                if k in ("interlevel_loss", "distortion_loss") else 0.0)
        _close(out[k], v, 1e-5, k, atol)
    # the default draws: an own generator seeded 0, the same each call
    again = [port.eval_loss_dict(camera_arrays(pipes["cams"], "cpu"),
                                 pipes["ds"].slice_arrays("cpu"),
                                 {"images": torch.from_numpy(images)})
             for _ in range(2)]
    assert again[0] == again[1]


def test_eval_image_matches_jax(pipes):
    p, port, state = pipes["jpipe"], pipes["port"], pipes["state"]
    jds, images = pipes["jds"], pipes["images"]
    o = jds.outputs
    item = {"mic_pose": o.microphone_poses[2], "source_pose": o.source_poses[2],
            "rot": o.rotations[2], "data": jds.log_stft[2]}
    jm, jim = p.eval_image(state, jcamera_arrays(pipes["cams"]), 3, images[3],
                           eval_audio_item=item)
    m, im = port.eval_image(camera_arrays(pipes["cams"], "cpu"), 3, images[3],
                            eval_audio_item=item)
    assert set(m) == set(jm) and set(im) == set(jim)
    assert m["lpips"] is None and "weights" in m["lpips_skipped"]
    assert m["num_rays"] == jm["num_rays"] == SIZE * SIZE
    for k in ("psnr", "ssim"):
        _close(m[k], jm[k], 0, k, 1e-4)
    _close(m["audio_mag"], jm["audio_mag"], 1e-5, "audio_mag")
    # the panels: a log-magnitude within its 1e-4 tolerance of a viridis
    # bin edge may take the neighbouring entry; every other pixel 1e-6
    jlog = np.asarray(p._render_rirs(
        state.params, state.batch_stats, state.grid,
        *(jnp.asarray(item[k], jnp.float32)[None]
          for k in ("mic_pose", "source_pose", "rot")))[0])
    for ch in range(2):
        k = f"comparison_ch_{ch}"
        assert im[k].shape == jim[k].shape == (257, 2 * T, 3)
        gt = np.flipud(item["data"][ch])
        scale = max(gt.max() - gt.min(), 1e-9)
        x = np.clip((np.flipud(jlog[ch]) - gt.min()) / scale, 0, 1) * 256
        edge = np.abs(x - np.round(x)) <= 1e-4 * 256 / scale
        near = np.concatenate([edge, np.zeros_like(edge)], axis=1)
        _close(im[k][~near], jim[k][~near], 0, k, 1e-6)
        steps = np.abs(VIRIDIS[:, None, :] - im[k][near][None]).sum(-1).argmin(0)
        jsteps = np.abs(VIRIDIS[:, None, :] - jim[k][near][None]).sum(-1).argmin(0)
        assert (np.abs(steps - jsteps) <= 1).all()
    for k in ("grid", "grid_density"):
        assert im[k].shape == (GRID_RES, GRID_RES, 3)
        _close(im[k], jim[k], 0, k, 1e-6)
    _close(im["img"], np.asarray(jim["img"]), 0, "img", 1e-4)
    _close(im["accumulation"], np.asarray(jim["accumulation"]), 0,
           "accumulation", 1e-3)
    _close(im["depth"], np.asarray(jim["depth"]), 1e-4, "depth")  # up to ~120


def test_query_grid_full_matches_jax(pipes):
    p, port, state = pipes["jpipe"], pipes["port"], pipes["state"]
    ref = np.asarray(p.query_grid_full(state, batch_size=64))
    grid0 = port.grid.clone()
    out = port.query_grid_full(batch_size=64)
    assert torch.equal(port.grid, grid0)  # the pipeline's grid untouched
    assert out.shape == (GRID_RES ** 3, 7)
    np.testing.assert_array_equal(out[:, 4:].numpy(), grid0[:, 4:].numpy())
    for c in range(4):
        # alpha = 1 - exp(-1e-2 density) is ~1e-4 here: a float32 ulp of 1
        # (2^-23 after the subtraction) is above 1e-4 of its peak
        atol = max(1e-4 * np.abs(ref[:, c]).max(), 2.0 ** -23)
        _close(out[:, c].numpy(), ref[:, c], 0, f"channel {c}", atol)
    with pytest.raises(ValueError):
        port.query_grid_full(batch_size=100)


def test_evaluate_vision_matches_jax(pipes):
    p, port, state = pipes["jpipe"], pipes["port"], pipes["state"]
    images = pipes["images"][:2]
    for avg in (True, False):
        ref = p.evaluate_vision(state, jcamera_arrays(pipes["cams"]), images,
                                use_average_appearance=avg)
        out = port.evaluate_vision(camera_arrays(pipes["cams"], "cpu"), images,
                                   use_average_appearance=avg)
        assert set(out) == set(ref)
        _close(out["psnr"], ref["psnr"], 0, "psnr", 1e-4)
        _close(out["psnr_std"], ref["psnr_std"], 0, "psnr_std", 1e-4)


@pytest.fixture(scope="module")
def audio_sweeps(pipes):
    p, port, state = pipes["jpipe"], pipes["port"], pipes["state"]
    ds, jds = pipes["ds"], pipes["jds"]
    key = jax.random.PRNGKey(8)
    ang = _jax_angles(key, (CHUNK, *ds.log_stft.shape[1:]))
    return {
        "key": key, "angles": ang,
        "host": (port.evaluate_audio(ds, chunk=CHUNK, init_angles=ang),
                 p.evaluate_audio(state, jds, key=key, chunk=CHUNK)),
        "device": (port.evaluate_audio_device(ds, chunk=CHUNK, init_angles=ang),
                   p.evaluate_audio_device(state, jds, key=key, chunk=CHUNK)),
    }


def test_render_rir_chunks_match_jax(pipes, audio_sweeps):
    """Each chunk of the sweep (the ragged last one padded on the JAX side,
    sliced on the port's) against _render_rir_chunk from the same key."""
    p, port, state, jds = pipes["jpipe"], pipes["port"], pipes["state"], pipes["jds"]
    o = jds.outputs
    ang = audio_sweeps["angles"]
    for i in range(0, N_EVAL, CHUNK):
        m = min(CHUNK, N_EVAL - i)
        pick = lambda a: np.concatenate(
            [a[i:i + m], np.repeat(a[-1:], CHUNK - m, axis=0)]).astype(np.float32)
        ref = p._render_rir_chunk(
            state.params, state.batch_stats, state.grid,
            *(jnp.asarray(pick(a)) for a in (o.microphone_poses, o.source_poses,
                                             o.rotations, jds.log_stft)),
            audio_sweeps["key"])
        out = port.render_rir_chunk(o.microphone_poses[i:i + m],
                                    o.source_poses[i:i + m], o.rotations[i:i + m],
                                    jds.log_stft[i:i + m],
                                    torch.as_tensor(ang[:m]).to(torch.complex64))
        ref = [np.asarray(r)[:m] for r in ref]
        assert [tuple(x.shape) for x in out] == [r.shape for r in ref]
        _close(out[0].numpy(), ref[0], 0, "log_pred", 1e-4)
        _close(out[1].numpy(), ref[1], 1e-4, "mag_pred", 1e-7)
        _close(out[2].numpy(), ref[2], 1e-4, "mag_gt", 1e-7)
        for w, r, what in ((out[3], ref[3], "wav_pred"), (out[4], ref[4], "wav_gt")):
            peak = np.abs(r).max()
            _close(w.numpy(), r, 0, what, 1e-2 * peak)


@pytest.mark.parametrize("sweep", ["host", "device"])
def test_audio_sweeps_match_jax(audio_sweeps, sweep):
    out, ref = audio_sweeps[sweep]
    assert set(out) == set(ref)
    assert out["audio_total_invalids_T60"] == ref["audio_total_invalids_T60"]
    for k, v in ref.items():
        if k.startswith(("fps", "num_rays")):
            assert out[k] > 0
        elif k.startswith(("audio_C50", "audio_mag")):
            _close(out[k], v, 1e-3, k)
        elif k.startswith(("audio_T60", "audio_EDT")):
            _close(out[k], v, 1e-2, k)


def test_eval_paths_leave_the_train_state_unchanged():
    """Two pipelines from one seed; the eval paths on one of them; then one
    train step on each (drawn from each pipeline's own generator): the
    metrics, weights, Adam state, BatchNorm statistics, grid, cursor, step
    and generator stay bitwise equal, and every model is back in train
    mode."""
    pipes = [build_joint_pipeline(grid_res=16, tiny=True, device="cpu",
                                  mixed_precision=False, seed=4)
             for _ in range(2)]
    ds = synth_scene(4, max_len=12, seed=2)
    cams, images = make_cameras(NUM_CAMERAS, size=12)
    arrays = (camera_arrays(cams, "cpu"), ds.slice_arrays("cpu"),
              {"images": torch.from_numpy(images)})
    for p in pipes:  # the audio branch live, so BatchNorm statistics move
        p.step = 3
        p.train_step(*arrays)
    probe = pipes[0]
    o = ds.outputs
    item = {"mic_pose": o.microphone_poses[0], "source_pose": o.source_poses[0],
            "rot": o.rotations[0], "data": ds.log_stft[0]}
    probe.eval_loss_dict(*arrays)
    probe.eval_image(arrays[0], 1, images[1], eval_audio_item=item)
    probe.evaluate_vision(arrays[0], images[:2])
    probe.query_grid_full(batch_size=256)
    probe.evaluate_audio(ds, chunk=3)
    probe.evaluate_audio_device(ds, chunk=3)
    probe.render_rirs(o.microphone_poses, o.source_poses, o.rotations)

    def state(p):
        out = {f"{name}.{k}": v for name, m in (
            ("vision", p.vision_model), ("audio", p.audio_model),
            ("resnet", p.resnet)) for k, v in m.state_dict().items()}
        for g, opt in p.optimizers.items():
            for i, s in enumerate(opt.opt.state.values()):
                out.update({f"adam.{g}.{i}.{k}": v for k, v in s.items()})
        out["grid"], out["generator"] = p.grid, p.generator.get_state()
        return out

    for p in pipes:
        assert all(m.training for m in (p.vision_model, p.audio_model, p.resnet))
    a, b = state(pipes[0]), state(pipes[1])
    assert set(a) == set(b) and len(a) > 50
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert (pipes[0].cursor, pipes[0].step) == (pipes[1].cursor, pipes[1].step)
    metrics = [p.train_step(*arrays) for p in pipes]
    assert metrics[0] == metrics[1] and metrics[0]["audio_mag_loss"] > 0
    a, b = state(pipes[0]), state(pipes[1])
    for k in a:
        assert torch.equal(a[k], b[k]), k
