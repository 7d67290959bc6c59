"""The port's configuration round trip, Trainer and CLIs against the JAX
package's, on the CPU.

- Config: the port's save_config writes the bytes the JAX package's
  save_config writes (so yaml.safe_load of it is JAX's _to_dict), for the
  RAF and SoundSpaces defaults and an overridden config; the port's
  load_config of JAX's file, and JAX's load_config of the port's, equal
  the other package's config field by field; apply_overrides gives JAX's
  config on each raw value of the list below, and raises where JAX raises.
  Exact.
- Trainer: with stub states and steps, the port's and JAX's Trainers write
  the same (step, prefix) records to metrics.jsonl, the same config.yml and
  checkpoints at the same steps, keeping all or only the latest, and after
  an eval that raises, the same emergency checkpoint. A step that raises
  partway (after its draw and its update) saves no emergency checkpoint
  and leaves the last periodic one's bytes as they were.
- The CLIs on tests/fixtures.py's scene at a tiny size (tests/test_cli.py's
  configuration, given as --set values, float32): 4 steps straight against
  2 steps then a --load-dir resume to 4, every tensor, counter and the
  generator state of the step-4 checkpoints bitwise equal, joint and
  --audio-only; the joint run with every eval cadence on gives bitwise the
  checkpoint of the run with them off; cli.evaluate writes the JAX CLI's
  result keys (the audio-only ones against the JAX CLI's own run, the
  joint ones those of the JAX paths it composes, evaluate_vision and
  evaluate_audio, whose keys tests/test_torch_eval_paths.py holds to
  JAX's); AVN_RENDER_POSES renders a trajectory's STFTs; a streamed run
  (--streaming on, joint and --audio-only, and "auto" over a threshold of
  0) trains and writes the resident run's records (--num-devices above 1
  is held by tests/test_torch_parallel.py); every CLI's flags
  and defaults are the JAX CLI's (--viewer-port, ported now, is held by
  tests/test_torch_serving.py).
"""

import dataclasses
import json
import pickle
import shutil
from pathlib import Path
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from fixtures import make_raf_scene, make_soundspaces_scene, make_vision_scene
from neraf_tpu.cli import evaluate as jevaluate
from neraf_tpu.cli import train as jtrain
from neraf_tpu.configs import config as jconfig
from neraf_tpu.engine.trainer import Trainer as JTrainer
from neraf_tpu_torch.cli import evaluate, train
from neraf_tpu_torch.configs import config as pconfig
from neraf_tpu_torch.engine.trainer import Trainer

OVERRIDES = ["vision_model.encoding=hash", "optimizers.fields.lr=1e-3",
             "vision_model.num_proposal_samples=[16, 12]",
             "audio_data.streaming=off", "eval_save_dir=/tmp/a b",
             "experiment_name='run: one'", "trainer.mixed_precision=false",
             "seed=7"]
TINY = ["audio_model.max_len=12", "audio_data.max_len=12",
        "audio_model.w_field=32", "audio_model.resnet_backbone=resnet18",
        "audio_model.grid_step=0.125", "audio_data.batch_size=32",
        "vision_model.num_frequencies=4", "vision_model.base_mlp_width=32",
        "vision_model.base_mlp_layers=2", "vision_model.geo_feat_dim=7",
        "vision_model.hidden_dim_color=16", "vision_model.appearance_embed_dim=4",
        "vision_model.num_nerf_samples=8",
        "vision_model.num_proposal_samples=[16, 12]",
        "vision_model.eval_num_rays_per_chunk=128",
        "vision_data.train_rays_per_batch=64",
        "vision_data.eval_rays_per_batch=64", "trainer.start_step_audio=1",
        "trainer.grid_bake_cells_per_step=64", "trainer.mixed_precision=false",
        "trainer.steps_per_log=2", "trainer.steps_per_save=2"]
EVALS_OFF = ["trainer.steps_per_eval_batch=1000",
             "trainer.steps_per_eval_image=1000",
             "trainer.steps_per_eval_all_images=1000"]
EVALS_ON = ["trainer.steps_per_eval_batch=1", "trainer.steps_per_eval_image=2",
            "trainer.steps_per_eval_all_images=2"]
JOINT_KEYS = {"psnr", "ssim", "psnr_std", "num_rays_per_sec", "fps", "lpips",
              "lpips_skipped"} | {
    f"audio_{k}{s}" for k in ("T60_mean_error", "total_invalids_T60", "EDT",
                              "C50") for s in ("", "_std")} | {
    "fps_audio", "num_rays_per_sec_audio"}


@pytest.fixture(autouse=True)
def _no_scene_env(monkeypatch):
    monkeypatch.delenv("NeRAF_dataset", raising=False)
    monkeypatch.delenv("NeRAF_scene", raising=False)
    monkeypatch.delenv("AVN_RENDER_POSES", raising=False)


@pytest.fixture(autouse=True)
def _remove_tmp_path(request):
    """Each test's tmp_path is removed when the test ends: pytest keeps every
    test's directory, and a run directory of the tiny CLI configuration
    holds ~280 MB a checkpoint (resnet18's weights and Adam moments)."""
    path = (request.getfixturevalue("tmp_path")
            if "tmp_path" in request.fixturenames else None)
    yield
    if path is not None:
        shutil.rmtree(path, ignore_errors=True)


def _shared_fields(c, path) -> list:
    """c's field names but the port's own vision fields
    (pconfig.PORT_ONLY_VISION), which hold their defaults, the JAX
    package's model."""
    names = [f.name for f in dataclasses.fields(c)]
    if not isinstance(c, pconfig.VisionModelConfig):
        return names
    default = pconfig.VisionModelConfig()
    for n in pconfig.PORT_ONLY_VISION:
        assert getattr(c, n) == getattr(default, n), (path, n)
    return [n for n in names if n not in pconfig.PORT_ONLY_VISION]


def _same_config(a, b, path="cfg"):
    """One package's config and the other's, field by field."""
    if dataclasses.is_dataclass(b):
        names = _shared_fields(b, path)
        assert _shared_fields(a, path) == names, path
        for n in names:
            _same_config(getattr(a, n), getattr(b, n), f"{path}.{n}")
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def _configs(which):
    """(port, JAX) configs: a dataset's default, or SoundSpaces with
    OVERRIDES applied to both."""
    dataset = "SoundSpaces" if which == "overridden" else which
    p = pconfig.default_config(dataset, data_root="/data/scenes")
    j = jconfig.default_config(dataset, data_root="/data/scenes")
    if which == "overridden":
        pconfig.apply_overrides(p, OVERRIDES)
        jconfig.apply_overrides(j, OVERRIDES)
    return p, j


@pytest.mark.parametrize("which", ["RAF", "SoundSpaces", "overridden"])
def test_config_files_match_jax(tmp_path, which):
    p, j = _configs(which)
    _same_config(p, j)
    pconfig.save_config(p, tmp_path / "port.yml")
    jconfig.save_config(j, tmp_path / "jax.yml")
    text = (tmp_path / "port.yml").read_text()
    assert text == (tmp_path / "jax.yml").read_text()
    assert yaml.safe_load(text) == jconfig._to_dict(j)
    _same_config(pconfig.load_config(tmp_path / "jax.yml"),
                 jconfig.load_config(tmp_path / "jax.yml"))
    _same_config(jconfig.load_config(tmp_path / "port.yml"),
                 pconfig.load_config(tmp_path / "port.yml"))


@pytest.mark.parametrize("item", [
    "optimizers.fields.lr=1e-3", "optimizers.fields.lr=1.0e-3",
    "vision_model.num_proposal_samples=[16, 12]",
    "trainer.save_only_latest_checkpoint=true", "audio_data.streaming=off",
    "audio_data.streaming=on", "eval_save_dir=null",
    "experiment_name='a quoted: name'", "experiment_name=\"dq\"",
    "optimizers.fields.eps=3", "trainer.max_num_iterations=1e3",
    "scene=012", "audio_model.use_grid=no"])
def test_apply_overrides_matches_jax(item):
    p, j = _configs("SoundSpaces")
    pconfig.apply_overrides(p, [item])
    jconfig.apply_overrides(j, [item])
    _same_config(p, j)


@pytest.mark.parametrize("item", ["trainer.nope=1", "nope.lr=1", "seed"])
def test_apply_overrides_refuses_as_jax(item):
    p, j = _configs("SoundSpaces")
    with pytest.raises(ValueError):
        jconfig.apply_overrides(j, [item])
    with pytest.raises(ValueError):
        pconfig.apply_overrides(p, [item])


# ------------------------------------------------------------------ Trainer
class _JStub(NamedTuple):
    step: jnp.ndarray
    w: jnp.ndarray


class _Stub:
    """A train state with what a checkpoint holds: a module, no optimizer,
    a generator and the step."""

    def __init__(self):
        self.step = 0
        self.models = {"m": torch.nn.Linear(2, 2)}
        self.optimizers = {}
        self.generator = torch.Generator()


def _run_trainers(tmp_path, keep_all: bool, crash_at: int | None):
    """Both Trainers over 10 stub steps (log 2, eval batch 3, eval image 4,
    eval all 5, save 3) -> {package: (records, checkpoint steps, config)}."""
    out = {}
    for name, cfg_mod, trainer_cls, state in (
            ("jax", jconfig, JTrainer,
             _JStub(jnp.zeros((), jnp.int32), jnp.zeros(2))),
            ("port", pconfig, Trainer, _Stub())):
        cfg = cfg_mod.ExperimentConfig()
        cfg_mod.apply_overrides(cfg, [
            "trainer.steps_per_log=2", "trainer.steps_per_eval_batch=3",
            "trainer.steps_per_eval_image=4",
            "trainer.steps_per_eval_all_images=5", "trainer.steps_per_save=3",
            f"trainer.save_only_latest_checkpoint={not keep_all}"])
        run = tmp_path / name
        trainer = trainer_cls(config=cfg, pipeline=None, output_dir=run)

        def step_fn(s, name=name):
            if name == "jax":
                return s._replace(step=s.step + 1), {"loss": jnp.float32(1.0)}
            s.step += 1
            return s, {"loss": 1.0}

        def eval_image_fn(s, step):
            if step == crash_at:
                raise RuntimeError("simulated preemption")
            return {"i": float(step)}

        kwargs = dict(step_fn=step_fn, eval_fns={"eval_a": lambda s: {"x": 1.0}},
                      eval_batch_fn=lambda s: {"b": 2.0},
                      eval_image_fn=eval_image_fn, max_steps=10)
        if crash_at is None:
            trainer.train(state, **kwargs)
        else:
            with pytest.raises(RuntimeError):
                trainer.train(state, **kwargs)
        records = [(r["step"], r["prefix"]) for r in map(
            json.loads, (run / "metrics.jsonl").read_text().splitlines())]
        steps = sorted(int(p.name.split("-")[1].split(".")[0])
                       for p in (run / "neraf_models").glob("step-*"))
        out[name] = (records, steps, (run / "config.yml").read_text())
    return out


@pytest.mark.parametrize("keep_all,crash_at", [(True, None), (False, None),
                                               (True, 8)])
def test_trainer_matches_jax(tmp_path, keep_all, crash_at):
    out = _run_trainers(tmp_path, keep_all, crash_at)
    assert out["port"] == out["jax"]
    records, steps, _ = out["port"]
    if crash_at is None:
        assert steps == ([3, 6, 9, 10] if keep_all else [10])
        assert (5, "eval_a") in records and (4, "eval_image") in records
    else:
        assert steps == [3, 6, 8]  # the emergency checkpoint at step 8
        assert max(s for s, _ in records) <= 8


def test_emergency_checkpoint_restores(tmp_path):
    """The emergency checkpoint of a crash in step 2's eval restores a stub
    at step 2 with its module's weights."""
    from neraf_tpu_torch.engine.checkpoints import latest_checkpoint, restore_checkpoint

    cfg = pconfig.ExperimentConfig()
    pconfig.apply_overrides(cfg, ["trainer.steps_per_eval_batch=2"])
    stub = _Stub()
    trainer = Trainer(config=cfg, pipeline=stub, output_dir=tmp_path)

    def step_fn(s):
        s.step += 1
        return s, {}

    def eval_batch_fn(s):
        raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        trainer.train(stub, step_fn=step_fn, eval_batch_fn=eval_batch_fn,
                      max_steps=5)
    path = latest_checkpoint(trainer.ckpt_dir)
    assert path.name == "step-000000002.pt"
    fresh = _Stub()
    restore_checkpoint(path, fresh)
    assert fresh.step == 2
    for a, b in zip(fresh.models["m"].parameters(), stub.models["m"].parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("crash_in", [3, 4])
def test_no_emergency_checkpoint_of_a_torn_step(tmp_path, crash_in):
    """A step that raises after drawing from the generator and updating the
    weights saves nothing: step 2's checkpoint (saved every 2 steps) keeps
    its bytes, and no checkpoint of the torn state appears."""
    cfg = pconfig.ExperimentConfig()
    pconfig.apply_overrides(cfg, ["trainer.steps_per_save=2"])
    stub = _Stub()
    trainer = Trainer(config=cfg, pipeline=stub, output_dir=tmp_path)
    saved = {}

    def step_fn(s):
        draw = torch.rand(2, generator=s.generator)
        with torch.no_grad():
            s.models["m"].bias.add_(draw)
        if s.step + 1 == crash_in:
            if not saved:
                saved["bytes"] = (trainer.ckpt_dir / "step-000000002.pt").read_bytes()
            raise RuntimeError("simulated preemption mid-step")
        s.step += 1
        return s, {}

    with pytest.raises(RuntimeError):
        trainer.train(stub, step_fn=step_fn, max_steps=6)
    assert [p.name for p in trainer.ckpt_dir.iterdir()] == ["step-000000002.pt"]
    assert (trainer.ckpt_dir / "step-000000002.pt").read_bytes() == saved["bytes"]


# --------------------------------------------------------------------- CLIs
@pytest.fixture(scope="module")
def scene_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("scenes")
    make_soundspaces_scene(root, max_frames=12)
    make_vision_scene(root, n_frames=3, size=16, scene_dir="mini_scene")
    yield root
    shutil.rmtree(root, ignore_errors=True)


def _argv(root, run_dir, steps, *extra, sets=(), dataset="SoundSpaces",
          scene="mini_scene", tiny=TINY):
    argv = ["--dataset", dataset, "--scene", scene, "--data-root",
            str(root), "--max-iters", str(steps), "--run-dir", str(run_dir),
            *extra]
    for item in (*tiny, *sets):
        argv += ["--set", item]
    return argv


def _train(root, run_dir, steps, *extra, sets=EVALS_OFF, **scene):
    with pytest.MonkeyPatch.context() as mp:
        for k in ("NeRAF_dataset", "NeRAF_scene"):
            mp.delenv(k, raising=False)
        return train.main(_argv(root, run_dir, steps, *extra, sets=sets,
                                **scene), device="cpu")


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _bitwise_diffs(a, b, path=""):
    """Where two loaded checkpoints differ (tensors by dtype, shape and
    bytes; everything else by ==)."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        return [d for k in a for d in _bitwise_diffs(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in _bitwise_diffs(x, y, f"{path}/{i}")]
    if torch.is_tensor(a):
        same = (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
            a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))
        return [] if same else [path]
    return [] if type(a) is type(b) and a == b else [path]


@pytest.fixture(scope="module")
def runs(scene_root, tmp_path_factory):
    """Per mode: the straight 4-step run and the 2 + 2 resumed one."""
    out = {}
    for mode, extra in (("joint", ()), ("audio_only", ("--audio-only",))):
        base = tmp_path_factory.mktemp(mode)
        straight = _train(scene_root, base / "straight", 4, *extra)
        _train(scene_root, base / "first", 2, *extra)
        resumed = _train(scene_root, base / "resumed", 4, *extra, "--load-dir",
                         str(base / "first" / "neraf_models"))
        shutil.rmtree(base / "first")  # read by the resume alone
        out[mode] = {"base": base, "straight": straight, "resumed": resumed}
    yield out
    for run in out.values():
        shutil.rmtree(run["base"], ignore_errors=True)


@pytest.mark.parametrize("mode", ["joint", "audio_only"])
def test_resume_is_bitwise(runs, mode):
    base = runs[mode]["base"]
    ckpt = "neraf_models/step-000000004.pt"
    a, b = _load(base / "straight" / ckpt), _load(base / "resumed" / ckpt)
    assert a["step"] == b["step"] == 4
    assert not _bitwise_diffs(a, b)
    shutil.rmtree(base / "resumed" / "neraf_models")  # compared; read no more
    assert runs[mode]["resumed"].pipeline.step == 4
    counts = {k: o["count"] for k, o in a["optimizers"].items()}
    assert counts == ({"audio_fields": 4} if mode == "audio_only" else
                      {k: 4 for k in ("proposal_networks", "fields",
                                      "camera_opt", "audio_fields")})
    names = sorted(p.name for p in (base / "straight").iterdir())
    assert names == ["config.yml", "metrics.jsonl", "neraf_models"]
    assert sorted(p.name for p in (base / "straight/neraf_models").iterdir()) == [
        "step-000000002.pt", "step-000000004.pt"]


def test_evals_leave_training_unchanged(runs, scene_root):
    """Every eval cadence on: the same step-4 checkpoint, bitwise, and the
    eval records and eval_images/ written."""
    base = runs["joint"]["base"]
    _train(scene_root, base / "evals", 4, sets=EVALS_ON)
    ckpt = "neraf_models/step-000000004.pt"
    assert not _bitwise_diffs(_load(base / "straight" / ckpt),
                              _load(base / "evals" / ckpt))
    records = [(r["step"], r["prefix"]) for r in map(
        json.loads, (base / "evals/metrics.jsonl").read_text().splitlines())]
    assert records == [(1, "eval_batch"), (2, "train"), (2, "eval_batch"),
                       (2, "eval_image"), (2, "eval_vision"), (2, "eval_audio"),
                       (3, "eval_batch"), (4, "train"), (4, "eval_batch"),
                       (4, "eval_image"), (4, "eval_vision"), (4, "eval_audio")]
    pngs = {p.name for p in (base / "evals/eval_images").glob("*.png")}
    assert {"step_0000002_img.png", "step_0000004_comparison_ch_1.png",
            "step_0000004_grid_density.png"} <= pngs
    shutil.rmtree(base / "evals")


def test_joint_evaluate_writes_the_jax_keys(runs):
    run = runs["joint"]["base"] / "straight"
    results = evaluate.main(["--load-config", str(run / "config.yml"),
                             "--output-path", str(run / "results.json")],
                            device="cpu")
    saved = json.loads((run / "results.json").read_text())
    assert saved == {"experiment_name": "mini_scene_NeRAF",
                     "method_name": "NeRAF", "results": results}
    assert set(results) == JOINT_KEYS
    assert np.isfinite(results["psnr"]) and results["lpips"] is None


def test_joint_evaluate_reports_lpips_with_weights(runs, tmp_path, monkeypatch,
                                                   capsys):
    """With NERAF_LPIPS_WEIGHTS at converted weights (random vgg, whose
    16-pixel minimum the scene's 16 x 16 views meet) cli.evaluate prints
    the weights it uses and reports lpips and lpips_std, as the JAX CLI
    does; without, it prints the JAX CLI's skip (the test above holds the
    null)."""
    from neraf_tpu_torch.metrics import lpips_impl

    monkeypatch.setattr(lpips_impl, "_DEFAULT_PATHS", ())
    run = runs["joint"]["base"] / "straight"
    argv = ["--load-config", str(run / "config.yml")]
    monkeypatch.delenv("NERAF_LPIPS_WEIGHTS", raising=False)
    evaluate.main(argv, device="cpu")
    assert "lpips: SKIPPED" in capsys.readouterr().out
    path = tmp_path / "lpips_vgg.npz"
    lpips_impl.save_params_npz(path, lpips_impl.init_params("vgg"), net="vgg")
    monkeypatch.setenv("NERAF_LPIPS_WEIGHTS", str(path))
    results = evaluate.main(argv, device="cpu")
    assert f"lpips: using weights {path}" in capsys.readouterr().out
    assert set(results) == JOINT_KEYS - {"lpips_skipped"} | {"lpips_std"}
    assert np.isfinite(results["lpips"]) and results["lpips"] > 0


def test_audio_only_cli_matches_the_jax_cli(runs, scene_root, tmp_path):
    """The JAX CLI's own audio-only run: the same config.yml, both packages
    load each other's to an equal config, and cli.evaluate writes the JAX
    CLI's result keys."""
    ours = runs["audio_only"]["base"] / "straight"
    theirs = tmp_path / "jax_run"
    with pytest.MonkeyPatch.context() as mp:
        for k in ("NeRAF_dataset", "NeRAF_scene"):
            mp.delenv(k, raising=False)
        jtrain.main(_argv(scene_root, theirs, 2, "--audio-only", sets=EVALS_OFF))
    assert (theirs / "config.yml").read_text() == (ours / "config.yml").read_text()
    _same_config(jconfig.load_config(ours / "config.yml"),
                 pconfig.load_config(theirs / "config.yml"))
    jevaluate.main(["--load-config", str(theirs / "config.yml"),
                    "--output-path", str(theirs / "results.json")])
    evaluate.main(["--load-config", str(ours / "config.yml"),
                   "--output-path", str(ours / "results.json")], device="cpu")
    j, p = (json.loads((d / "results.json").read_text()) for d in (theirs, ours))
    assert set(p) == set(j) and set(p["results"]) == set(j["results"])
    assert (p["experiment_name"], p["method_name"]) == (j["experiment_name"],
                                                        j["method_name"])


# RAF's time axis is the loader's (0.32 s at hop 256: 60 frames), so the
# tiny configuration keeps it; its evaluator (the JAX package's
# RAFEvaluator) reports T60 and the STFT error where SoundSpaces' reports
# the T60 error
RAF = {"dataset": "RAF", "scene": "raf_scene",
       "tiny": [t for t in TINY if "max_len" not in t]}
RAF_JOINT_KEYS = JOINT_KEYS - {
    "audio_T60_mean_error", "audio_T60_mean_error_std"} | {
    f"audio_{k}{s}" for k in ("T60", "stft_error") for s in ("", "_std")}


def test_raf_cli_matches_the_jax_cli(tmp_path):
    """The default dataset, RAF (mono, 48 kHz, 513 bins, T 60), on
    tests/fixtures.py's RAF scene with 3 views: the port's joint cli.train
    (every eval cadence on) and cli.evaluate write the records and keys of
    the SoundSpaces runs; the port's and the JAX CLI's --audio-only runs
    write the same config.yml, each package loads the other's to an equal
    config, and their cli.evaluate the same result keys."""
    root = tmp_path / "scenes"
    make_raf_scene(root)
    make_vision_scene(root, n_frames=3, size=16, scene_dir="raf_scene")
    joint = tmp_path / "joint"
    trainer = _train(root, joint, 2, sets=EVALS_ON, **RAF)
    cfg = trainer.pipeline.config
    assert (cfg.dataset, cfg.audio_model.n_freq_stft, cfg.audio_model.mic_ch,
            cfg.audio_model.max_len) == ("RAF", 513, 1, 60)
    records = [(r["step"], r["prefix"]) for r in map(
        json.loads, (joint / "metrics.jsonl").read_text().splitlines())]
    assert records == [(1, "eval_batch"), (2, "train"), (2, "eval_batch"),
                       (2, "eval_image"), (2, "eval_vision"), (2, "eval_audio")]
    results = evaluate.main(["--load-config", str(joint / "config.yml")],
                            device="cpu")
    assert set(results) == RAF_JOINT_KEYS
    assert all(np.isfinite(v) for k, v in results.items()
               if isinstance(v, float) and not k.startswith("audio_EDT"))

    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    _train(root, ours, 2, "--audio-only", **RAF)
    with pytest.MonkeyPatch.context() as mp:
        for k in ("NeRAF_dataset", "NeRAF_scene"):
            mp.delenv(k, raising=False)
        jtrain.main(_argv(root, theirs, 2, "--audio-only", sets=EVALS_OFF,
                          **RAF))
    assert (theirs / "config.yml").read_text() == (ours / "config.yml").read_text()
    _same_config(jconfig.load_config(ours / "config.yml"),
                 pconfig.load_config(theirs / "config.yml"))
    jevaluate.main(["--load-config", str(theirs / "config.yml"),
                    "--output-path", str(theirs / "results.json")])
    evaluate.main(["--load-config", str(ours / "config.yml"),
                   "--output-path", str(ours / "results.json")], device="cpu")
    j, p = (json.loads((d / "results.json").read_text()) for d in (theirs, ours))
    assert set(p["results"]) == set(j["results"])
    assert (p["experiment_name"], p["method_name"]) == (
        j["experiment_name"], j["method_name"]) == ("raf_scene_NeRAF", "NeRAF")


def test_inference_mode_renders_the_trajectory(runs, tmp_path, monkeypatch):
    rng = np.random.default_rng(4)
    traj = {"scene_obs": [{"pose": rng.uniform(-2, 2, 3).tolist(),
                           "quat": [0.0, 0.0, 0.0, 1.0],
                           "source": rng.uniform(-2, 2, 3).tolist()}
                          for _ in range(3)]}
    (tmp_path / "traj.pkl").write_bytes(pickle.dumps(traj))
    monkeypatch.setenv("AVN_RENDER_POSES", str(tmp_path / "traj.pkl"))
    run = runs["joint"]["base"] / "straight"
    results = evaluate.main(["--load-config", str(run / "config.yml"),
                             "--render-output-path", str(tmp_path / "out")],
                            device="cpu")
    assert results == {"num_rendered": 3}
    stfts = sorted((tmp_path / "out").glob("stft_*.npy"))
    assert [p.name for p in stfts] == [f"stft_{i:05d}.npy" for i in range(3)]
    assert all(np.isfinite(np.load(p)).all() and np.load(p).shape == (2, 257, 12)
               for p in stfts)


@pytest.mark.parametrize("extra,sets", [
    (("--streaming", "on"), ()), (("--audio-only", "--streaming", "on"), ()),
    ((), ("audio_data.stream_threshold_gb=0",))])
def test_streamed_runs_train(scene_root, tmp_path, monkeypatch, extra, sets):
    """--streaming on (joint and --audio-only) and the "auto" decision
    above a threshold of 0 train through one StreamingAudioSampler, fed to
    every step and eval batch and stopped at the end: the run directory
    and its records are those of the resident run, every value finite."""
    samplers = []

    class Recorded(train.StreamingAudioSampler):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            samplers.append(self)

    monkeypatch.setattr(train, "StreamingAudioSampler", Recorded)
    audio_only = tuple(e for e in extra if e == "--audio-only")
    runs = {}
    for name, flags, more in (("resident", audio_only, ()),
                              ("streamed", extra, sets)):
        runs[name] = tmp_path / name
        _train(scene_root, runs[name], 2, *flags,
               sets=(*EVALS_OFF, "trainer.steps_per_eval_batch=1", *more))
    assert len(samplers) == 1
    (s,) = samplers
    assert s._stopped.is_set() and not s._thread.is_alive()
    assert s.device == torch.device("cpu") and s._dtype == torch.bfloat16
    assert s.batch_size == 32 and s.max_len == 12
    records = {}
    for name, run in runs.items():
        assert (run / "config.yml").is_file()
        assert sorted(p.name for p in (run / "neraf_models").iterdir()) == [
            "step-000000002.pt"]
        rows = [json.loads(line) for line in
                (run / "metrics.jsonl").read_text().splitlines()]
        assert all(np.isfinite(v) for r in rows for k, v in r.items()
                   if isinstance(v, float) and not k.startswith("audio_EDT"))
        records[name] = [(r["step"], r["prefix"]) for r in rows]
    assert records["streamed"] == records["resident"]
    assert (2, "train") in records["streamed"]
    if not audio_only:
        assert (1, "eval_batch") in records["streamed"]


def test_cli_entry_points_default_to_the_card():
    import inspect

    from neraf_tpu.cli import loudness as jloudness
    from neraf_tpu.cli import render as jrender
    from neraf_tpu.cli import viewer as jviewer
    from neraf_tpu_torch.cli import loudness, render, viewer
    from neraf_tpu_torch.data import preprocess
    from neraf_tpu_torch.viz.viewer import ViewerBackend

    for fn in (train.main, evaluate.main, render.main, loudness.main,
               viewer.main, preprocess.main, preprocess.process_rir_wav,
               preprocess.process_scene):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert "device" not in inspect.signature(ViewerBackend).parameters
    assert set(vars(train.parse_args(["--data-root", "x"]))) == set(
        vars(jtrain.parse_args(["--data-root", "x"])))
    for ours, theirs, argv in (
            (evaluate, jevaluate, ["--load-config", "x"]),
            (viewer, jviewer, ["--load-config", "x"]),
            (render, jrender, ["--load-config", "x", "--output-dir", "y"]),
            (loudness, jloudness, ["--load-config", "x", "--output-dir", "y"])):
        assert vars(ours.parse_args(argv)) == vars(theirs.parse_args(argv))
    assert set(vars(preprocess.parse_args(["--scene-dir", "x"]))) == {
        "scene_dir", "in_dir", "out_dir"}
