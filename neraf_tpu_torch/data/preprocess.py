"""Dataset preprocessing (counterpart of neraf_tpu/data/preprocess.py):
SoundSpaces RIR wavs -> magnitude-STFT .npy files, and the vision frames of
a scene's recorded poses.

The reference's data/SoundSpaces/process_audio.ipynb: binaural RIR wav ->
clip to [-1, 1] -> resample 44.1 kHz -> 22.05 kHz -> Spectrogram(n_fft=512,
hop=128, power=None) -> abs -> one .npy per "{rot}/{rx}_{tx}" (the NAF
layout). Waveforms are front-padded by n_fft / 2 zeros and extended to at
least 4410 samples before the STFT, as the notebook does. process_scene
runs the whole batch through the native C++ ingest (native/, a host thread
pool) as the JAX package does, unless NERAF_NATIVE=0; its Python path,
process_rir_wav, runs the port's resampler and STFT (dsp/resample.py,
dsp/stft.py) on the card unless device="cpu" is given.

generate_vision rebuilds data/SoundSpaces/generate_vision.ipynb: the pose
pickles, the Habitat-pose -> nerfstudio camera conversion, the intrinsics
and the transforms.json layout; the raster renderer is pluggable
(`render_fn`) and defaults to a Habitat-Sim session, which raises
NotImplementedError when habitat_sim is not installed. Frames are written
as PNG by utils/png.py (the JAX package's default is JPEG, through PIL,
which the card's machine lacks).

Usage:
    python -m neraf_tpu_torch.data.preprocess --scene-dir data/SoundSpaces/office_4 \
        [--in-dir binaural_rirs] [--out-dir binaural_magnitudes_sr22050]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import pickle
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from neraf_tpu_torch import native
from neraf_tpu_torch.dsp.resample import resample_poly
from neraf_tpu_torch.dsp.stft import stft_magnitude
from neraf_tpu_torch.utils.png import write_png
from neraf_tpu_torch.utils.wav import read_wav

N_FFT = 512
HOP = 128
TARGET_FS = 22050
MIN_SAMPLES = 4410


def process_rir_wav(path: Path, device="cuda") -> np.ndarray:
    """One wav -> (C, 257, T) float32 magnitude spectrogram at 22.05 kHz,
    computed on `device`."""
    sr, wav = read_wav(path)
    wav = np.clip(np.atleast_2d(wav.T if wav.ndim > 1 else wav[None]), -1.0, 1.0)
    x = torch.as_tensor(wav.astype(np.float32), device=device)
    if sr != TARGET_FS:
        x = resample_poly(x, TARGET_FS, sr)
    x = F.pad(x, (N_FFT // 2, 0))
    if x.shape[1] < MIN_SAMPLES:
        x = F.pad(x, (0, MIN_SAMPLES - x.shape[1]))
    return stft_magnitude(x, n_fft=N_FFT, hop_length=HOP).cpu().numpy()


def process_scene(scene_dir: Path, in_dir: str = "binaural_rirs",
                  out_dir: str = "binaural_magnitudes_sr22050",
                  device="cuda") -> int:
    """Every wav under scene_dir/in_dir -> its .npy under scene_dir/out_dir
    (the same relative path) -> how many. Natively in one batch unless
    NERAF_NATIVE=0, else one process_rir_wav each on `device`."""
    scene_dir = Path(scene_dir)
    src_root = scene_dir / in_dir
    dst_root = scene_dir / out_dir
    paths = sorted(src_root.rglob("*.wav"))
    if paths and native.available():
        mags = _process_native(paths)
    else:
        mags = (process_rir_wav(p, device=device) for p in paths)
    for wav_path, mag in zip(paths, mags):
        dst = dst_root / wav_path.relative_to(src_root).with_suffix(".npy")
        dst.parent.mkdir(parents=True, exist_ok=True)
        np.save(dst, mag)
    return len(paths)


def _process_native(paths: list) -> list:
    """process_rir_wav of each path through native.process_rir_batch: the
    frames each file's own resampled, padded length gives, its channels."""
    t_each = []
    for p in paths:
        sr, frames, _ = native.wav_info(p)
        g = math.gcd(TARGET_FS, sr)
        res_len = -(-frames * (TARGET_FS // g) // (sr // g))
        t_each.append(1 + max(res_len + N_FFT // 2, MIN_SAMPLES) // HOP)
    mags, chans = native.process_rir_batch(
        paths, target_fs=TARGET_FS, n_fft=N_FFT, hop=HOP, win=N_FFT,
        front_pad=N_FFT // 2, min_samples=MIN_SAMPLES, max_channels=2,
        n_frames=max(t_each))
    return [np.ascontiguousarray(m[:c, :, :t])
            for m, c, t in zip(mags, chans, t_each)]


# Habitat right-up-back camera coords -> left-up-back world coords: the
# axis transform the reference applies to every camera-to-world matrix
# (generate_vision.ipynb cell 15).
_HABITAT_TO_NERFSTUDIO = np.array([[-1.0, 0.0, 0.0, 0.0],
                                   [0.0, 0.0, 1.0, 0.0],
                                   [0.0, 1.0, 0.0, 0.0],
                                   [0.0, 0.0, 0.0, 1.0]])


def habitat_camera_intrinsics(width: int, height: int, hfov_deg: float):
    """Focal lengths in pixels, by the reference's formulas
    (generate_vision.ipynb cell 6): fx = 1 / tan(hfov / 2), then
    fx_px = width / (2 fx), i.e. width tan(hfov / 2) / 2, the reciprocal of
    the textbook pinhole focal length; the two agree at the shipped hfov of
    90 degrees, and any other hfov matches reference-generated data."""
    aspect = width / height
    fx = 1.0 / np.tan(np.deg2rad(hfov_deg) / 2.0)
    fy = fx * aspect
    return width / (2.0 * fx), height / (2.0 * fy)


def habitat_pose_to_c2w(position, quat_xyzw) -> np.ndarray:
    """Habitat agent pose (position + xyzw quaternion) -> nerfstudio c2w
    (generate_vision.ipynb cell 15): scipy's from_quat, then the
    right-up-back -> left-up-back axis transform. The translation is the
    agent's recorded position, without the sensor height, as in the
    reference notebook."""
    from scipy.spatial.transform import Rotation

    m = np.eye(4)
    m[:3, :3] = Rotation.from_quat(np.asarray(quat_xyzw, float)).as_matrix()
    m[:3, 3] = np.asarray(position, float)
    return _HABITAT_TO_NERFSTUDIO @ m


class HabitatSession:
    """Habitat-Sim RGB render session for generate_vision, built as the
    reference notebook builds its simulator (generate_vision.ipynb cells
    6-10): one pinhole colour sensor `sensor_height` above the agent, the
    agent teleported to each recorded (position, xyzw quaternion) pose.

    `settings` is the scene's *_SimParams.json dict with the Replica asset
    paths (scene, scene_dataset, navmesh); NERAF_HABITAT_SCENE_ROOT remaps
    its recorded dataset root (settings["path"]) onto the local disk.
    """

    def __init__(self, settings: dict):
        import habitat_sim

        settings = dict(settings)
        root = os.environ.get("NERAF_HABITAT_SCENE_ROOT")
        if root:
            old = settings.get("path", "")
            for k in ("scene", "scene_dataset", "navmesh"):
                if k in settings and old and settings[k].startswith(old):
                    settings[k] = root + settings[k][len(old):]

        rgb = habitat_sim.CameraSensorSpec()
        rgb.uuid = "color_sensor"
        rgb.sensor_type = habitat_sim.SensorType.COLOR
        rgb.sensor_subtype = habitat_sim.SensorSubType.PINHOLE
        rgb.resolution = [int(settings["height"]), int(settings["width"])]
        rgb.position = [0.0, float(settings["sensor_height"]), 0.0]
        rgb.orientation = [0.0, 0.0, 0.0]
        try:  # hfov is a magnum Deg in habitat's API; a float without magnum
            import magnum as mn

            rgb.hfov = mn.Deg(float(settings["hfov"]))
        except ImportError:
            rgb.hfov = float(settings["hfov"])

        backend = habitat_sim.SimulatorConfiguration()
        backend.gpu_device_id = int(settings.get("gpu_device_id", 0))
        backend.scene_id = settings["scene"]
        backend.scene_dataset_config_file = settings["scene_dataset"]
        backend.load_semantic_mesh = True
        backend.enable_physics = False

        agent = habitat_sim.AgentConfiguration()
        agent.sensor_specifications = [rgb]

        self.sim = habitat_sim.Simulator(
            habitat_sim.Configuration(backend, [agent]))
        if settings.get("navmesh"):
            self.sim.pathfinder.load_nav_mesh(settings["navmesh"])
        self.settings = settings

    def render(self, position, quat_xyzw, settings=None) -> np.ndarray:
        """Teleport the agent and capture one RGB uint8 (H, W, 3) frame."""
        from habitat_sim.utils.common import quat_from_coeffs

        agent = self.sim.get_agent(int(self.settings.get("default_agent", 0)))
        state = agent.get_state()
        state.position = np.asarray(position, np.float32)
        state.rotation = quat_from_coeffs(np.asarray(quat_xyzw, float))
        state.sensor_states = {}  # the sensor follows the agent
        agent.set_state(state, True)
        obs = self.sim.get_sensor_observations()
        return np.asarray(obs["color_sensor"])[..., :3].astype(np.uint8)

    def close(self) -> None:
        self.sim.close()


def _habitat_render_fn(settings: dict):
    """The default renderer: a Habitat-Sim session (needs habitat_sim)."""
    try:
        import habitat_sim  # noqa: F401
    except ImportError as e:
        raise NotImplementedError(
            "generate_vision's default renderer needs Habitat-Sim, which is "
            "not installed in this environment. Either install habitat-sim "
            "and the Replica scene assets (paths in the scene's "
            "*_SimParams.json), or pass render_fn=... producing an RGB "
            "uint8 (H, W, 3) array for an agent (position, quat_xyzw); the "
            "pose conversion, intrinsics and transforms.json layout are "
            "handled here either way.") from e
    return HabitatSession(settings).render


def generate_vision(scene_dir, render_fn=None, image_dir: str = "images",
                    width: int | None = None, height: int | None = None,
                    limit_per_split: int | None = None) -> Path:
    """RGB frames at the scene's Train / Eval agent poses and a
    nerfstudio-style transforms.json (generate_vision.ipynb cells 5-16).

    render_fn(position, quat_xyzw, settings) -> uint8 (H, W, 3) renders a
    frame (default: a Habitat-Sim session). Frames are
    {image_dir}/{split}_frame_{i:05d}.png, one counter from 1 across train
    then eval (the reference's naming); file_path entries are relative to
    transforms.json; the split is recovered downstream by filename.

    Returns the path of the written transforms.json.
    """
    scene_dir = Path(scene_dir)
    scene = scene_dir.name
    settings = json.loads((scene_dir / f"{scene}_SimParams.json").read_text())
    if width is not None:
        settings["width"] = width
    if height is not None:
        settings["height"] = height
    w, h = int(settings["width"]), int(settings["height"])
    fl_x, fl_y = habitat_camera_intrinsics(w, h, float(settings["hfov"]))
    if render_fn is None:
        render_fn = _habitat_render_fn(settings)

    imdir = scene_dir / image_dir
    imdir.mkdir(parents=True, exist_ok=True)
    transforms = {"camera_model": "OPENCV", "orientation_override": "none",
                  "frames": []}
    i = 1  # one counter across both splits, from 1 (the reference's)
    for split, pkl_name in (("train", f"{scene}_Train.pkl"),
                            ("eval", f"{scene}_Eval.pkl")):
        poses = pickle.loads((scene_dir / pkl_name).read_bytes())
        for n_done, data in enumerate(poses.values()):
            if limit_per_split is not None and n_done >= limit_per_split:
                break
            c2w = habitat_pose_to_c2w(data["Position"], data["Quaternion"])
            img = np.asarray(render_fn(np.asarray(data["Position"], float),
                                       np.asarray(data["Quaternion"], float),
                                       settings))
            name = f"{split}_frame_{i:05d}.png"
            write_png(imdir / name, img[..., :3])
            transforms["frames"].append({
                "fl_x": fl_x, "fl_y": fl_y,
                "cx": w / 2, "cy": h / 2, "w": w, "h": h,
                "file_path": f"{image_dir}/{name}",
                "transform_matrix": c2w.tolist(),
            })
            i += 1
    out_path = scene_dir / "transforms.json"
    out_path.write_text(json.dumps(transforms, indent=2))
    return out_path


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="neraf-preprocess-audio")
    p.add_argument("--scene-dir", required=True)
    p.add_argument("--in-dir", default="binaural_rirs")
    p.add_argument("--out-dir", default="binaural_magnitudes_sr22050")
    return p.parse_args(argv)


def main(argv=None, device="cuda") -> int:
    """Process a scene's RIR wavs -> how many."""
    args = parse_args(argv)
    n = process_scene(Path(args.scene_dir), args.in_dir, args.out_dir,
                      device=device)
    print(f"processed {n} RIRs")
    return n


if __name__ == "__main__":
    main()
