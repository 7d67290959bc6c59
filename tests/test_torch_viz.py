"""The port's serving tools' modules against the JAX package's, on the CPU.

The same seeded numpy inputs go through both packages; the models share
one JAX init_state through bridge.py (test_torch_eval_paths.py's tiny
joint pipeline: tiny vision, resnet18 over a 16^3 grid, w_field 32, T 12,
float32, the grid and BatchNorm statistics drawn from a seed). Griffin-Lim
starts from the angles JAX draws from its key (griffin_lim.py:89-90).

Tolerances: fft_convolve, auralize and moving_listener_audio 1e-5 of the
output's peak (float32 FFTs of another library; scipy's float64 result is
held to the same); camera_to_audio_pose, the trajectory poses, the Habitat
pose conversion, the intrinsics and the loudness PNG bitwise; render_rir
atol 1e-4 on log-magnitudes in [-10, 10] (test_torch_slice.py's);
rir_from_log_stft after 4 iterations atol 5e-4 + rtol 1e-3
(test_torch_dsp.py:95's Griffin-Lim bound); the loudness map 1e-4 dB
absolute; process_rir_wav 1e-5 of the spectrogram's peak (the JAX
resampler and STFT against the port's).
"""

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from fixtures import make_soundspaces_scene
from neraf_tpu.dsp.filters import fft_convolve as jfft_convolve
from neraf_tpu.models.audio import camera_to_audio_pose as jcamera_to_audio_pose
from neraf_tpu_torch.dsp.filters import fft_convolve
from neraf_tpu_torch.models.audio import camera_to_audio_pose

REL = 1e-5


def _close_to_peak(a, b, tol=REL, what=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
    assert err <= tol, (what, err)


# ------------------------------------------------------------ fft_convolve
@pytest.mark.parametrize("shapes,mode", [
    (((37,), (11,)), "full"), (((37,), (11,)), "same"),
    (((3, 37), (3, 11)), "full"), (((3, 37), (3, 11)), "same"),
    (((1, 64), (2, 9)), "full"), (((9,), (40,)), "same")])
def test_fft_convolve_matches_jax_and_scipy(shapes, mode):
    rng = np.random.default_rng(len(shapes[0]) + shapes[1][-1])
    x, y = (rng.standard_normal(s).astype(np.float32) for s in shapes)
    out = fft_convolve(torch.from_numpy(x), torch.from_numpy(y), mode=mode)
    assert out.dtype == torch.float32
    _close_to_peak(out.numpy(), jfft_convolve(jnp.asarray(x), jnp.asarray(y),
                                              mode=mode), what="jax")
    lead = np.broadcast_shapes(x.shape[:-1], y.shape[:-1])
    ref = scipy.signal.fftconvolve(
        np.broadcast_to(x, lead + x.shape[-1:]).astype(np.float64),
        np.broadcast_to(y, lead + y.shape[-1:]).astype(np.float64), mode=mode,
        axes=-1)
    _close_to_peak(out.numpy(), ref, what="scipy")


# ------------------------------------------------------ camera_to_audio_pose
@pytest.mark.parametrize("dataset", ["SoundSpaces", "RAF"])
def test_camera_to_audio_pose_is_bitwise_jax(dataset):
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(7)
    cams = [np.eye(4)[:3]] + [
        np.concatenate([Rotation.random(random_state=int(s)).as_matrix(),
                        rng.uniform(-3, 3, (3, 1))], axis=1)
        for s in rng.integers(0, 2**31, 12)]
    for c2w in cams:
        mic, rot = camera_to_audio_pose(c2w, dataset)
        jmic, jrot = jcamera_to_audio_pose(c2w, dataset)
        assert mic.dtype == jmic.dtype and rot.dtype == jrot.dtype
        assert np.array_equal(mic, jmic) and np.array_equal(rot, jrot)
    if dataset == "RAF":
        assert np.array_equal(camera_to_audio_pose(cams[3], "RAF")[1],
                              [1.0, 0.5, 0.5])


# ------------------------------------------------------------- render_rir
@pytest.mark.parametrize("grid_feature_dim", [0, 24])
def test_render_rir_matches_jax(grid_feature_dim):
    from neraf_tpu.configs.config import AudioModelConfig as JConfig
    from neraf_tpu.models.audio import AudioModel as JAudioModel
    from neraf_tpu_torch.bridge import field_state_dict, load_state_dict
    from neraf_tpu_torch.configs.config import AudioModelConfig
    from neraf_tpu_torch.models.audio import AudioModel

    kw = dict(dataset="SoundSpaces", max_len=12, n_freq_stft=257, w_field=32)
    jmodel = JAudioModel(config=JConfig(**kw).resolve(),
                         grid_feature_dim=grid_feature_dim)
    params = jmodel.init(jax.random.PRNGKey(3))
    model = AudioModel(AudioModelConfig(**kw).resolve(), grid_feature_dim)
    load_state_dict(model.field, field_state_dict(params))
    rng = np.random.default_rng(5)
    aabb = np.array([[-3, -3, -3], [3, 3, 3]], np.float32)
    feat = (rng.standard_normal(grid_feature_dim).astype(np.float32)
            if grid_feature_dim else None)
    for _ in range(3):
        mic, src = rng.uniform(-2.5, 2.5, (2, 3)).astype(np.float32)
        rot = rng.uniform(0, 1, 3).astype(np.float32)
        want = jmodel.render_rir(params, jnp.asarray(mic), jnp.asarray(src),
                                 jnp.asarray(rot), jnp.asarray(aabb),
                                 None if feat is None else jnp.asarray(feat))
        with torch.no_grad():
            got = model.render_rir(
                *(torch.from_numpy(a) for a in (mic, src, rot, aabb)),
                None if feat is None else torch.from_numpy(feat))
            batch = model.render_rirs_batch(
                *(torch.from_numpy(a)[None] for a in (mic, src, rot)),
                torch.from_numpy(aabb),
                None if feat is None else torch.from_numpy(feat))[0]
        assert got.shape == (2, 257, 12)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
        assert torch.equal(got, batch)


# --------------------------------------------------------- rir_from_log_stft
GEOMETRIES = {"soundspaces": (512, 128, 512), "raf": (1024, 256, 512)}


def _jax_angles(key, shape):
    """The unit phasors JAX's griffin_lim starts from (griffin_lim.py:89-90)."""
    ang0 = jax.random.uniform(key, shape, dtype=jnp.float32) * (2 * jnp.pi)
    return np.asarray(jnp.cos(ang0)) + 1j * np.asarray(jnp.sin(ang0))


@pytest.mark.parametrize("geo", sorted(GEOMETRIES))
def test_rir_from_log_stft_matches_jax(geo):
    from neraf_tpu.viz.auralization import rir_from_log_stft as jrir
    from neraf_tpu_torch.viz.auralization import rir_from_log_stft

    n_fft, hop, win = GEOMETRIES[geo]
    rng = np.random.default_rng(11)
    log = rng.normal(-3.0, 1.5, (2, n_fft // 2 + 1, 9)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    kw = dict(n_fft=n_fft, hop_len=hop, win_len=win, n_iter=4)
    want = jrir(jnp.asarray(log), key=key, **kw)
    got = rir_from_log_stft(torch.from_numpy(log), init_angles=torch.from_numpy(
        _jax_angles(key, log.shape)), **kw)
    assert got.shape == want.shape == (2, hop * 8) and got.dtype == torch.float32
    assert float(got.abs().max()) <= 1.0
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=1e-3)


def test_auralize_matches_jax():
    """Stereo dry input longer than 5 s: averaged to mono, truncated, one
    convolution per RIR channel."""
    from neraf_tpu.viz.auralization import auralize as jauralize
    from neraf_tpu_torch.viz.auralization import auralize

    fs = 400
    rng = np.random.default_rng(2)
    dry = rng.standard_normal((6 * fs + 37, 2)).astype(np.float32)
    rir = (rng.standard_normal((2, 300)) * np.exp(-np.arange(300) / 40)
           ).astype(np.float32)
    want = jauralize(dry, rir, fs)
    got = auralize(dry, torch.from_numpy(rir), fs)
    assert got.shape == want.shape == (2, 5 * fs + 300 - 1)
    _close_to_peak(got.numpy(), want)
    assert torch.equal(auralize(torch.from_numpy(dry), torch.from_numpy(rir), fs),
                       got)


# -------------------------------------------- the tiny bridged joint pipeline
@pytest.fixture(scope="module")
def pipes():
    from neraf_tpu.engine.pipeline import JointPipeline as JJointPipeline
    from neraf_tpu.models.audio import AudioModel as JAudioModel
    from neraf_tpu.models.resnet3d import ResNet3D as JResNet3D
    from neraf_tpu.models.vision import VisionModel as JVisionModel
    from neraf_tpu_torch.configs.config import AudioModelConfig
    from neraf_tpu_torch.engine.factory import (
        FAR,
        NEAR,
        NUM_CAMERAS,
        build_joint_pipeline,
        joint_config,
    )
    from test_torch_eval_paths import _randomized
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
    state = _randomized(jpipe.init_state(seed=3))
    pcfg = joint_config(tiny=True)
    pcfg.audio_model = AudioModelConfig(
        dataset="SoundSpaces", max_len=12, n_freq_stft=257, w_field=32,
        n_features=1024, resnet_backbone="resnet18").resolve()
    port = build_joint_pipeline(grid_res=16, tiny=True, device="cpu",
                                mixed_precision=False, state=state, config=pcfg)

    def jrender(mic, src, rot):
        return jpipe._render_rirs(state.params, state.batch_stats, state.grid,
                                  jnp.asarray(mic), jnp.asarray(src),
                                  jnp.asarray(rot))

    return {"jrender": jrender, "port": port}


def test_auralize_on_the_bridged_pipeline_matches_jax(pipes):
    """Render -> Griffin-Lim (JAX's angles) -> auralize, as the viewer's
    /auralize does, in both packages."""
    from neraf_tpu.viz.auralization import auralize as jauralize
    from neraf_tpu.viz.auralization import rir_from_log_stft as jrir
    from neraf_tpu_torch.viz.auralization import auralize, rir_from_log_stft

    port = pipes["port"]
    cfg = port.audio_model.config
    mic = np.array([[0.3, -0.2, 0.5]], np.float32)
    src = np.array([[-0.5, 0.1, 0.2]], np.float32)
    rot = np.array([[1.0, 0.5, 0.5]], np.float32)
    jlog = np.asarray(pipes["jrender"](mic, src, rot))[0]
    log = port.render_rirs(mic, src, rot)[0]
    np.testing.assert_allclose(log.numpy(), jlog, atol=1e-4)
    key = jax.random.PRNGKey(0)
    kw = dict(n_fft=cfg.n_fft, hop_len=cfg.hop_len, win_len=cfg.win_len,
              n_iter=4)
    jwav = jrir(jlog, key=key, **kw)
    wav = rir_from_log_stft(log, init_angles=torch.from_numpy(
        _jax_angles(key, jlog.shape)), **kw)
    np.testing.assert_allclose(wav.numpy(), jwav, atol=5e-4, rtol=1e-3)
    dry = np.random.default_rng(8).standard_normal(3000).astype(np.float32)
    _close_to_peak(auralize(dry, torch.from_numpy(jwav), cfg.fs).numpy(),
                   jauralize(dry, jwav, cfg.fs))


def test_loudness_matches_jax(pipes):
    from neraf_tpu.viz.loudness import loudness_map as jloudness_map
    from neraf_tpu.viz.loudness import render_loudness_grid as jgrid
    from neraf_tpu_torch.viz.loudness import loudness_map, render_loudness_grid

    port = pipes["port"]
    aabb = port.audio_aabb.numpy()
    args = (np.array([0.4, -0.3, 0.2]), np.array([1.0, 0.5, 0.5]), aabb, 0.25)
    want = jgrid(pipes["jrender"], *args, resolution=5)
    got = render_loudness_grid(port.render_rirs, *args, resolution=5)
    assert got["shape"] == want["shape"] == (5, 5)
    assert np.array_equal(got["mic_positions"], want["mic_positions"])
    assert isinstance(got["log_stfts"], torch.Tensor)
    np.testing.assert_allclose(got["log_stfts"].numpy(), want["log_stfts"],
                               atol=1e-4)
    lm = loudness_map(got["log_stfts"], got["shape"])
    jlm = jloudness_map(want["log_stfts"], want["shape"])
    assert lm.shape == (5, 5) and lm.dtype == jlm.dtype == np.float32
    np.testing.assert_allclose(lm, jlm, atol=1e-4)
    assert np.ptp(lm) > 0


@pytest.mark.parametrize("res,kind", [(48, "random"), (7, "random"),
                                      (33, "ramp"), (5, "flat")])
def test_loudness_png_matches_matplotlib_and_pil(tmp_path, res, kind):
    """The CLI's image of a map: viridis of the min-max normalised map at
    512 x 512 by nearest neighbour, against the JAX CLI's matplotlib + PIL
    code on the same map, bitwise."""
    from matplotlib import cm
    from PIL import Image

    from neraf_tpu_torch.utils.png import read_png, write_png
    from neraf_tpu_torch.viz.loudness import loudness_image

    rng = np.random.default_rng(res)
    lm = {"random": rng.normal(-30.0, 6.0, (res, res)),
          "ramp": np.add.outer(np.arange(res), np.arange(res)) * -0.7,
          "flat": np.full((res, res), -12.5)}[kind].astype(np.float32)
    norm = (lm - lm.min()) / max(lm.max() - lm.min(), 1e-9)
    img = (cm.viridis(norm)[..., :3] * 255).astype(np.uint8)
    Image.fromarray(img).resize((512, 512), Image.NEAREST).save(tmp_path / "j.png")
    got = loudness_image(lm)
    assert got.shape == (512, 512, 3) and got.dtype == np.uint8
    want = np.asarray(Image.open(tmp_path / "j.png").convert("RGB"))
    assert np.array_equal(got, want)
    write_png(tmp_path / "p.png", got)
    assert np.array_equal(read_png(tmp_path / "p.png"), want)


# -------------------------------------------------------------- trajectory
def test_trajectory_poses_round_trip_as_jax(tmp_path, monkeypatch):
    from neraf_tpu.data.dataparsers import parse_inference_poses_raf as jparse
    from neraf_tpu.viz.trajectory import assemble_video_cmd as jcmd
    from neraf_tpu.viz.trajectory import make_trajectory_poses as jposes
    from neraf_tpu_torch.data.dataparsers import parse_raf
    from neraf_tpu_torch.viz.trajectory import (
        assemble_video_cmd,
        make_trajectory_poses,
        save_trajectory_npy,
    )

    args = (np.asarray([[0, 0, 0], [1, 0, 0], [1, 1, 0.5], [-1, 2, 0]]), 16,
            [0.5, 0.5, 0.5])
    poses, want = make_trajectory_poses(*args, rot_deg=30.0), jposes(
        *args, rot_deg=30.0)
    assert set(poses) == set(want)
    assert all(np.array_equal(poses[k], want[k]) and poses[k].dtype == want[k].dtype
               for k in want)
    path = save_trajectory_npy(poses, tmp_path / "traj" / "poses.npy")
    monkeypatch.setenv("AVN_RENDER_POSES", str(path))
    o, jo = parse_raf(tmp_path, "inference"), jparse(str(path))
    for k in ("microphone_poses", "source_poses", "rotations"):
        assert np.array_equal(getattr(o, k), getattr(jo, k))
    assert o.microphone_poses.shape == (16, 3)
    assert assemble_video_cmd("f/*.png", "a.wav", "o.mp4", 12.0) == jcmd(
        "f/*.png", "a.wav", "o.mp4", 12.0)


@pytest.mark.parametrize("n_dry", [16000, 3000])
def test_moving_listener_audio_matches_jax(n_dry):
    from neraf_tpu.viz.trajectory import moving_listener_audio as jmla
    from neraf_tpu_torch.viz.trajectory import moving_listener_audio

    fs = 8000
    rng = np.random.default_rng(n_dry)
    dry = rng.standard_normal(n_dry).astype(np.float32)
    rirs = (rng.standard_normal((16, 2, 120)) * np.exp(-np.arange(120) / 30)
            ).astype(np.float32)
    want = jmla(dry, rirs, fs, frame_rate=10.0)
    got = moving_listener_audio(dry, torch.from_numpy(rirs), fs, frame_rate=10.0)
    assert got.dtype == torch.float32
    _close_to_peak(got.numpy(), want)


# ------------------------------------------------------------ preprocessing
@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_soundspaces_scene(tmp_path_factory.mktemp("pre"), n_train=6,
                                  n_test=2)


def test_process_rir_wav_matches_jax(scene):
    from neraf_tpu.data.preprocess import process_rir_wav as jprocess
    from neraf_tpu_torch.data.preprocess import process_rir_wav

    paths = sorted((scene / "binaural_rirs").rglob("*.wav"))
    assert len(paths) == 8
    for p in paths:
        got, want = process_rir_wav(p, device="cpu"), jprocess(p)
        assert got.dtype == want.dtype == np.float32
        _close_to_peak(got, want, what=p.name)


def test_process_scene_matches_jax(scene, tmp_path):
    """The port's scene walk (on the CPU) against the JAX package's (its
    native ingest where built) and the JAX Python path per file."""
    import shutil

    from neraf_tpu.data.preprocess import process_rir_wav as jprocess
    from neraf_tpu.data.preprocess import process_scene as jscene
    from neraf_tpu_torch.data.preprocess import main, process_scene

    for name in ("port", "jax"):
        shutil.copytree(scene / "binaural_rirs", tmp_path / name / "binaural_rirs")
    assert process_scene(tmp_path / "port", out_dir="mags", device="cpu") == 8
    assert jscene(tmp_path / "jax", out_dir="mags") == 8
    ours = sorted(p.relative_to(tmp_path / "port")
                  for p in (tmp_path / "port" / "mags").rglob("*.npy"))
    assert ours == sorted(p.relative_to(tmp_path / "jax")
                          for p in (tmp_path / "jax" / "mags").rglob("*.npy"))
    for rel in ours:
        got = np.load(tmp_path / "port" / rel)
        _close_to_peak(got, np.load(tmp_path / "jax" / rel), what=str(rel))
        wav = (tmp_path / "port" / "binaural_rirs" / rel.relative_to("mags")
               ).with_suffix(".wav")
        _close_to_peak(got, jprocess(wav), what=str(rel))
    assert main(["--scene-dir", str(tmp_path / "port"), "--out-dir", "again"],
                device="cpu") == 8
    assert all(np.array_equal(np.load(tmp_path / "port" / rel), np.load(
        tmp_path / "port" / "again" / rel.relative_to("mags"))) for rel in ours)


def test_habitat_pose_and_intrinsics_are_bitwise_jax():
    from scipy.spatial.transform import Rotation

    from neraf_tpu.data.preprocess import habitat_camera_intrinsics as jintr
    from neraf_tpu.data.preprocess import habitat_pose_to_c2w as jc2w
    from neraf_tpu_torch.data.preprocess import (
        habitat_camera_intrinsics,
        habitat_pose_to_c2w,
    )

    rng = np.random.default_rng(3)
    for seed in range(8):
        pos = rng.uniform(-5, 5, 3)
        quat = Rotation.random(random_state=seed).as_quat()
        assert np.array_equal(habitat_pose_to_c2w(pos, quat), jc2w(pos, quat))
    for w, h, hfov in ((512, 512, 90.0), (640, 480, 70.0), (16, 12, 110.0)):
        assert habitat_camera_intrinsics(w, h, hfov) == jintr(w, h, hfov)


def _pose_pickles(scene_dir, n=3, seed=0, **settings):
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    name = scene_dir.name
    scene_dir.mkdir(parents=True)
    (scene_dir / f"{name}_SimParams.json").write_text(json.dumps(
        {"width": 12, "height": 10, "hfov": 90, "sensor_height": 1.5,
         **settings}))
    for split in ("Train", "Eval"):
        poses = {int(i): {"Position": rng.uniform(-3, 3, 3).tolist(),
                          "Quaternion": Rotation.random(
                              random_state=int(i)).as_quat().tolist()}
                 for i in rng.integers(0, 1000, n)}
        (scene_dir / f"{name}_{split}.pkl").write_bytes(pickle.dumps(poses))


def test_generate_vision_matches_jax(tmp_path):
    """A seeded render_fn at recorded poses: the port's transforms.json is
    the JAX package's with .png frames, its PNGs hold the rendered pixels,
    and the port's loader reads the scene back."""
    from neraf_tpu.data.preprocess import generate_vision as jgenerate
    from neraf_tpu_torch.data.preprocess import generate_vision
    from neraf_tpu_torch.data.vision_data import load_transforms
    from neraf_tpu_torch.utils.png import read_rgb

    def render(position, quat, settings):
        seed = int(abs(position[0]) * 1e6) % 2**31
        return np.random.default_rng(seed).integers(
            0, 256, (settings["height"], settings["width"], 4), dtype=np.uint8)

    for name in ("port", "jax"):
        _pose_pickles(tmp_path / name / "office_4")
    out = generate_vision(tmp_path / "port" / "office_4", render_fn=render,
                          limit_per_split=2)
    jout = jgenerate(tmp_path / "jax" / "office_4", render_fn=render,
                     limit_per_split=2, image_ext="png")
    t, jt = json.loads(out.read_text()), json.loads(jout.read_text())
    assert t == jt and len(t["frames"]) == 4
    assert t["frames"][2]["file_path"] == "images/eval_frame_00003.png"
    for f in t["frames"]:
        assert np.array_equal(read_rgb(out.parent / f["file_path"]),
                              read_rgb(jout.parent / f["file_path"]))
    train = load_transforms(out.parent, "train", eval_mode="filename")
    assert train.images.shape == (2, 10, 12, 3)


def test_generate_vision_drives_a_habitat_session(tmp_path, monkeypatch):
    """With habitat_sim importable (tests/test_generate_vision.py's stub),
    the default renderer drives the simulator session at every pose, RGBA
    frames become RGB, and NERAF_HABITAT_SCENE_ROOT remaps the asset
    paths, as the JAX package's does."""
    from neraf_tpu_torch.data.preprocess import generate_vision
    from neraf_tpu_torch.utils.png import read_rgb
    from test_generate_vision import _install_habitat_stub

    record = {"poses": []}
    _install_habitat_stub(monkeypatch, record)
    monkeypatch.setenv("NERAF_HABITAT_SCENE_ROOT", "/local/replica")
    _pose_pickles(tmp_path / "office_4", path="/data/replica",
                  scene="/data/replica/office_4/mesh.ply",
                  scene_dataset="/data/replica/replica.json",
                  navmesh="/data/replica/office_4/navmesh.bin")
    out = generate_vision(tmp_path / "office_4", width=8, height=6)
    frames = json.loads(out.read_text())["frames"]
    assert len(frames) == len(record["poses"]) == 6
    assert record["resolution"] == (6, 8)
    assert record["backend"].scene_id == "/local/replica/office_4/mesh.ply"
    assert record["navmesh"] == "/local/replica/office_4/navmesh.bin"
    for f, pos in zip(frames, record["poses"]):
        img = read_rgb(out.parent / f["file_path"])
        assert img.shape == (6, 8, 3)
        assert (img[..., 0] == int(abs(float(pos[0])) * 10) % 256).all()


def test_generate_vision_without_habitat_raises(tmp_path):
    from neraf_tpu_torch.data.preprocess import generate_vision

    _pose_pickles(tmp_path / "office_4")
    with pytest.raises(NotImplementedError, match="render_fn"):
        generate_vision(tmp_path / "office_4")


# --------------------------------------------------------------- profiling
def test_profiling_trace_and_section_timer(tmp_path):
    """trace() writes the Chrome trace, one line a span recorded in the
    block (the spans nested, a request's id on its children) and what each
    counter counted in it; the section timings are the spans' host ms."""
    from neraf_tpu_torch.utils import profiling

    profiling.count("test.before")
    with profiling.trace(tmp_path / "prof") as prof:
        with profiling.request("test.request"):
            for name in ("a", "b", "a"):
                with profiling.span(name):
                    torch.ones(64).cumsum(0)
                    profiling.count("test.sections")
    assert prof.key_averages()
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert {"neraf.test.request", "neraf.a", "neraf.b"} <= names
    lines = (tmp_path / "prof" / "spans.jsonl").read_text().splitlines()
    recs = [json.loads(line) for line in lines]
    assert sorted(r["name"] for r in recs) == ["a", "a", "b", "test.request"]
    top = next(r for r in recs if r["name"] == "test.request")
    assert all(r["parent"] == top["id"] and r["request"] == top["request"]
               for r in recs if r is not top)
    assert all(0 <= r["host_ms"] <= top["host_ms"] for r in recs)
    counted = json.loads((tmp_path / "prof" / "counters.json").read_text())
    assert counted == {"test.sections": 3}
