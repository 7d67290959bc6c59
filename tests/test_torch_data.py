"""The port's data layer against the JAX package's, on scenes written both
ways: by tests/fixtures.py (scipy and PIL) and by the port's
data/synthetic.py (its own PNG writer), so that each package reads the
other's files. Then the port's build_pipeline against the JAX package's on
the same tiny scene and configuration, and one tiny joint step of the port's
bundle, loaded from the JAX bundle's state, against the JAX step with JAX's
draws.

Tolerances: parsed poses, orientations, AABBs and SoundSpaces log-STFTs
exact (the same float64 numpy arithmetic); RAF log-STFTs at
test_torch_dsp.py's STFT bound (pocketfft against XLA's FFT, atol 5e-5,
rtol 1e-4); SoundSpaces GT waveforms after the 44.1 -> 22.05 kHz resampling
to 1e-6 of the peak (the same Kaiser filter; measured 1.8e-7 of the peak,
float32 sums in another order); load_transforms' c2w to 1e-6 (float64 pose
math, cast to float32), intrinsics exact, images exact at downscale 1 and
within one 8-bit level (1/255) of PIL's BILINEAR resize at downscale 2
(the port's antialiased torch resize); the PNG decoder exact against PIL
at every filter type. The joint step: test_torch_train_slice.py's bounds.
"""

import dataclasses
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from fixtures import make_raf_scene, make_soundspaces_scene, make_vision_scene
from neraf_tpu.configs.config import default_config as jdefault_config
from neraf_tpu.data import dataparsers as jparsers
from neraf_tpu.data import datasets as jdatasets
from neraf_tpu.data.vision_data import camera_arrays as jcamera_arrays
from neraf_tpu.data.vision_data import load_transforms as jload_transforms
from neraf_tpu.data.vision_data import sample_pixel_batch as jsample_pixel_batch
from neraf_tpu.dsp.resample import resample_poly as jresample_poly
from neraf_tpu.engine import factory as jfactory
from neraf_tpu_torch.bridge import load_joint_state
from neraf_tpu_torch.configs.config import default_config
from neraf_tpu_torch.data import dataparsers, datasets
from neraf_tpu_torch.data.synthetic import (
    synth_scene,
    write_soundspaces_scene,
    write_vision_scene,
)
from neraf_tpu_torch.data.vision_data import camera_arrays, load_transforms
from neraf_tpu_torch.dsp.resample import resample_poly
from neraf_tpu_torch.engine import factory
from neraf_tpu_torch.utils import png
from test_torch_train_slice import (
    _check_gradients,
    _check_losses,
    _jax_grads,
    _port_grads,
    _recording,
)

WAV_TOL = 1e-6  # of the peak


def _same_outputs(a, b):
    assert list(a.audio_filenames) == list(b.audio_filenames)
    for k in ("microphone_poses", "source_poses", "rotations", "aabb"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """Both packages' scene writers: fixtures' SoundSpaces, RAF and vision
    scenes, and the port's synthetic SoundSpaces + sphere scene."""
    root = tmp_path_factory.mktemp("scenes")
    ss = make_soundspaces_scene(root, n_train=5, n_test=3, max_frames=30)
    make_vision_scene(root, n_frames=6, size=16, scene_dir="vision_scene")
    return {"fixture_ss": ss, "raf": make_raf_scene(root, n_recordings=4),
            "fixture_vision": root / "vision_scene",
            "port_ss": write_vision_scene(
                write_soundspaces_scene(root / "port", 6, 3, scene="office_4",
                                        max_len=20), n_views=12, size=16)}


@pytest.mark.parametrize("which", ["fixture_ss", "port_ss"])
@pytest.mark.parametrize("split", ["train", "test"])
def test_soundspaces_loader_matches_jax(scenes, which, split):
    scene = scenes[which]
    _same_outputs(dataparsers.parse_soundspaces(scene, split),
                  jparsers.parse_soundspaces(scene, split))
    out = datasets.load_soundspaces_dataset(scene, split, max_len=24)
    ref = jdatasets.load_soundspaces_dataset(scene, split, max_len=24)
    _same_outputs(out.outputs, ref.outputs)
    np.testing.assert_array_equal(out.log_stft, ref.log_stft)
    assert (out.max_len, out.fs, out.hop_len) == (ref.max_len, ref.fs, ref.hop_len)
    if split == "train":
        assert out.waveforms is None and ref.waveforms is None
    else:
        assert out.waveforms.shape == ref.waveforms.shape == (3, 2, 24 * 128)
        peak = np.abs(ref.waveforms).max()
        np.testing.assert_allclose(out.waveforms, ref.waveforms, rtol=0,
                                   atol=WAV_TOL * peak)


def test_port_scene_round_trips_synth_scene(scenes):
    """The written SoundSpaces scene reads back as synth_scene's recordings:
    poses exact; log-STFTs to 1e-6 (synth_scene takes the log of its
    float64 magnitudes, the loader of the float32 ones on disk: measured
    4.8e-7); the waveforms (upsampled on writing, downsampled on reading)
    within 0.15 in relative L2 (measured 0.093: the synthetic RIRs are
    white noise up to the Nyquist frequency, and the Kaiser lowpass of
    both resamplings takes their top band)."""
    ds = datasets.load_soundspaces_dataset(scenes["port_ss"], "test", max_len=20)
    ref = synth_scene(9, max_len=20, seed=0)
    np.testing.assert_array_equal(ds.outputs.microphone_poses,
                                  ref.outputs.microphone_poses[6:])
    np.testing.assert_array_equal(ds.outputs.source_poses,
                                  ref.outputs.source_poses[6:])
    np.testing.assert_array_equal(ds.outputs.rotations, ref.outputs.rotations[6:])
    np.testing.assert_allclose(ds.log_stft, ref.log_stft[6:], rtol=0, atol=1e-6)
    want = ref.waveforms[6:]
    assert ds.waveforms.shape == want.shape
    assert np.linalg.norm(ds.waveforms - want) < 0.15 * np.linalg.norm(want)


@pytest.mark.parametrize("split", ["train", "test"])
def test_raf_loader_matches_jax(scenes, split):
    scene = scenes["raf"]
    _same_outputs(dataparsers.parse_raf(scene, split),
                  jparsers.parse_raf(scene, split))
    out = datasets.load_raf_dataset(scene, split)
    ref = jdatasets.load_raf_dataset(scene, split)
    _same_outputs(out.outputs, ref.outputs)
    assert out.log_stft.shape == ref.log_stft.shape
    # log(|X| + 1e-3): the STFT bound, relative to |X| + 1e-3 >= 1e-3
    np.testing.assert_allclose(np.exp(out.log_stft), np.exp(ref.log_stft),
                               atol=5e-5, rtol=1e-4)
    if split == "test":
        np.testing.assert_array_equal(out.waveforms, ref.waveforms)


def test_inference_poses_match_jax(tmp_path, monkeypatch):
    import pickle

    rng = np.random.default_rng(3)
    traj = {"scene_obs": [{"pose": rng.uniform(-2, 2, 3).tolist(),
                           "quat": [0.0, np.sin(a / 2), 0.0, np.cos(a / 2)],
                           "source": rng.uniform(-2, 2, 3).tolist()}
                          for a in rng.uniform(-np.pi, np.pi, 5)]}
    pkl = tmp_path / "traj.pkl"
    pkl.write_bytes(pickle.dumps(traj))
    _same_outputs(dataparsers.parse_inference_poses_soundspaces(str(pkl)),
                  jparsers.parse_inference_poses_soundspaces(str(pkl)))
    npy = tmp_path / "traj.npy"
    np.save(npy, {"mic_poses": rng.uniform(-2, 2, (4, 3)),
                  "source_poses": rng.uniform(-2, 2, 3),
                  "rots": rng.uniform(0, 1, 3)}, allow_pickle=True)
    monkeypatch.setenv("AVN_RENDER_POSES", str(npy))
    _same_outputs(dataparsers.parse_raf(tmp_path, "inference"),
                  jparsers.parse_raf(tmp_path, "inference"))


@pytest.mark.parametrize("up,down", [(1, 2), (2, 1), (2, 3)])
def test_resample_poly_matches_jax(up, down):
    x = np.random.default_rng(up * 7 + down).normal(size=(2, 3, 301)).astype(np.float32)
    out = resample_poly(torch.from_numpy(x), up, down).numpy()
    ref = np.asarray(jresample_poly(jnp.asarray(x), up, down))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=WAV_TOL * np.abs(ref).max())


@pytest.mark.parametrize("which", ["fixture_vision", "port_ss"])
@pytest.mark.parametrize("eval_mode", ["fraction", "filename"])
@pytest.mark.parametrize("split", ["train", "eval"])
def test_load_transforms_matches_jax(scenes, which, eval_mode, split):
    scene = scenes[which]
    for factor in (1, 2):
        out = load_transforms(scene, split, eval_mode=eval_mode,
                              downscale_factor=factor)
        ref = jload_transforms(scene, split, eval_mode=eval_mode,
                               downscale_factor=factor)
        np.testing.assert_array_equal(out.indices, ref.indices)
        c, r = out.cameras, ref.cameras
        np.testing.assert_allclose(c.c2w, r.c2w, rtol=0, atol=1e-6)
        for k in ("fx", "fy", "cx", "cy", "distortion"):
            np.testing.assert_array_equal(getattr(c, k), getattr(r, k), err_msg=k)
        assert (c.width, c.height, c.scale_factor) == (r.width, r.height,
                                                       r.scale_factor)
        np.testing.assert_array_equal(out.aabb, ref.aabb)
        assert out.images.shape == ref.images.shape
        if factor == 1:
            np.testing.assert_array_equal(out.images, ref.images)
        else:
            np.testing.assert_allclose(out.images, ref.images, rtol=0,
                                       atol=1 / 255 + 1e-7)


def _filter_rows(img: np.ndarray, kind: int) -> bytes:
    """The PNG scanlines of (H, W, C) uint8 with one filter type on every
    row (PNG spec section 9.2), written by plain loops."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int64)
    out = bytearray()
    for y in range(h):
        cur, up = rows[y], rows[y - 1] if y else np.zeros(w * c, np.int64)
        line = []
        for x in range(w * c):
            a = cur[x - c] if x >= c else 0
            b, d = up[x], up[x - c] if x >= c else 0
            if kind == 0:
                pred = 0
            elif kind == 1:
                pred = a
            elif kind == 2:
                pred = b
            elif kind == 3:
                pred = (a + b) // 2
            else:
                p = a + b - d
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - d)
                pred = a if pa <= pb and pa <= pc else b if pb <= pc else d
            line.append((cur[x] - pred) % 256)
        out += bytes([kind]) + bytes(line)
    return bytes(out)


def _write_filtered_png(path, img: np.ndarray, kind: int) -> None:
    colour = {1: 0, 3: 2, 4: 6}[img.shape[-1]]

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body)))

    path.write_bytes(
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", img.shape[1], img.shape[0],
                                     8, colour, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(_filter_rows(img, kind)))
        + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("kind", range(5))
def test_png_decoder_matches_pil(tmp_path, channels, kind):
    rng = np.random.default_rng(channels * 10 + kind)
    yy, xx = np.mgrid[0:9, 0:11]
    smooth = (np.sin(xx / 3.0) + np.cos(yy / 2.0))[..., None] * 60 + 128
    img = np.clip(smooth + rng.integers(-40, 40, (9, 11, channels)), 0,
                  255).astype(np.uint8)
    path = tmp_path / "f.png"
    _write_filtered_png(path, img, kind)
    pil = Image.open(path)
    np.testing.assert_array_equal(png.read_png(path)[..., :channels].reshape(
        img.shape), img)
    np.testing.assert_array_equal(png.read_png(path).reshape(img.shape),
                                  np.asarray(pil).reshape(img.shape))
    np.testing.assert_array_equal(png.read_rgb(path),
                                  np.asarray(pil.convert("RGB")))
    # PIL's own (adaptive) filters, and the port's writer read back by PIL
    pil_path = tmp_path / "pil.png"
    Image.fromarray(img[..., 0] if channels == 1 else img).save(pil_path)
    np.testing.assert_array_equal(png.read_png(pil_path).reshape(img.shape), img)
    if channels == 3:
        png.write_png(tmp_path / "port.png", img)
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port.png")),
                                      img)


# ---------------------------------------------------------------- factory
def _tiny(cfg):
    """test_torch_train_slice.py's tiny joint configuration, on a 32^3 grid,
    on either package's config object."""
    vm = cfg.vision_model
    cfg.vision_model = dataclasses.replace(
        vm, num_frequencies=4, base_mlp_width=32, base_mlp_layers=2,
        geo_feat_dim=7, hidden_dim_color=16, appearance_embed_dim=4,
        num_nerf_samples=8, num_proposal_samples=(16, 12))
    cfg.audio_model = dataclasses.replace(
        cfg.audio_model, max_len=24, w_field=32, resnet_backbone="resnet18",
        grid_step=1.0 / 32)
    cfg.audio_data.max_len = 24
    cfg.audio_data.batch_size = 32
    cfg.vision_data.train_rays_per_batch = 64
    cfg.trainer.mixed_precision = False
    cfg.trainer.start_step_audio = 1
    cfg.trainer.grid_bake_cells_per_step = 256
    return cfg


@pytest.fixture(scope="module")
def bundles(scenes, tmp_path_factory):
    root = tmp_path_factory.mktemp("joint")
    scene = make_soundspaces_scene(root, n_train=5, n_test=3, max_frames=30)
    make_vision_scene(root, n_frames=6, size=12, scene_dir="mini_scene")
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("NeRAF_dataset", raising=False)
        mp.delenv("NeRAF_scene", raising=False)
        jcfg = _tiny(jdefault_config("SoundSpaces", "mini_scene",
                                     data_root=str(root)))
        cfg = _tiny(default_config("SoundSpaces", "mini_scene",
                                   data_root=str(root)))
    jb = jfactory.build_pipeline(jcfg)
    for attr in ("opt_prop", "opt_fields", "opt_cam", "opt_audio"):
        setattr(jb.pipeline, attr, _recording(getattr(jb.pipeline, attr)))
    return {"jax": jb, "port": factory.build_pipeline(cfg, device="cpu"),
            "scene": scene}


def test_build_pipeline_matches_jax(bundles):
    jb, pb = bundles["jax"], bundles["port"]
    jp, pp = jb.pipeline, pb.pipeline
    assert pp.vision_model.camera_opt.shape[0] == jp.vision_model.num_cameras == 6
    np.testing.assert_array_equal(pp.audio_aabb.numpy(), np.asarray(jp.audio_aabb))
    np.testing.assert_array_equal(pp.vision_aabb.numpy(), np.asarray(jp.vision_aabb))
    assert pp.grid_res == jp.grid_res == 32
    assert pp.vision_model.field.dtype == torch.float32
    assert jp.vision_model.compute_dtype == jnp.float32
    for split in ("audio_train", "audio_eval"):
        a, b = getattr(pb, split), getattr(jb, split)
        _same_outputs(a.outputs, b.outputs)
        np.testing.assert_array_equal(a.log_stft, b.log_stft)
    np.testing.assert_allclose(pb.audio_eval.waveforms, jb.audio_eval.waveforms,
                               rtol=0, atol=WAV_TOL * np.abs(jb.audio_eval.waveforms).max())
    for split in ("vision_train", "vision_eval"):
        a, b = getattr(pb, split), getattr(jb, split)
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_allclose(a.cameras.c2w, b.cameras.c2w, rtol=0, atol=1e-6)


def test_build_pipeline_mixed_precision_dtype(bundles):
    cfg = dataclasses.replace(bundles["port"].pipeline.config)
    cfg.trainer = dataclasses.replace(cfg.trainer, mixed_precision=True)
    pipe = factory.build_pipeline(cfg, device="cpu").pipeline
    assert pipe.vision_model.field.dtype == torch.bfloat16 and pipe.mixed


def test_bundle_joint_steps_match_jax(bundles):
    """Three steps of each bundle from the JAX bundle's init_state (the
    audio branch live at the third), the port loaded from JAX's state
    before each and handed the draws the JAX step makes from state.rng."""
    jb, pb = bundles["jax"], bundles["port"]
    jp, port = jb.pipeline, pb.pipeline
    cfg = jp.config
    state = jp.init_state(seed=cfg.seed)
    images = jb.vision_train.images
    n_cams, H, W = images.shape[:3]
    n_rec, T = jb.audio_train.log_stft.shape[0], cfg.audio_model.max_len
    R, B = cfg.vision_data.train_rays_per_batch, cfg.audio_data.batch_size
    jarrays = (jcamera_arrays(jb.vision_train.cameras),
               jb.audio_train.slice_arrays(), {"images": jnp.asarray(images)})
    arrays = (camera_arrays(pb.vision_train.cameras, "cpu"),
              pb.audio_train.slice_arrays("cpu"),
              {"images": torch.from_numpy(pb.vision_train.images)})
    for step in range(3):
        load_joint_state(port, state)
        _, k_pix, k_aud, k_render = jax.random.split(state.rng, 4)
        cam, py, px = jsample_pixel_batch(k_pix, n_cams, H, W, R)
        idx = jax.random.randint(k_aud, (B,), 0, n_rec * T)
        u = [jax.random.uniform(k, (R, 1)) for k in jax.random.split(k_render, 3)]
        draws = dict(zip(
            ("cam", "py", "px", "rec", "t", "u_init", "u_pdf0", "u_pdf1"),
            (np.array(v) for v in (cam, py, px, idx // T, idx % T, *u))))
        state, jm = jp.train_step(state, *jarrays)
        pm = port.train_step(*arrays, draws=draws)
        run = {"jax": {"metrics": {k: float(v) for k, v in jm.items()},
                       "grads": _jax_grads(state)},
               "port": {"metrics": pm, "grads": _port_grads(port)}}
        _check_losses(run, live=step > 1)
        _check_gradients(run, live=step > 1)
