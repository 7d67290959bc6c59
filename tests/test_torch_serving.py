"""The port's serving entry points on the CPU: the HTTP viewer (standalone
and live during cli.train), cli.render, cli.loudness, cli.viewer and the
Trainer's on_metrics hook.

- The viewer (mirroring tests/test_viewer.py) on a tiny joint pipeline:
  every route's status and content type; every request's device work on
  the backend's one device thread; /render bitwise the pipeline's
  render_image quantised as the CLIs quantise it; /rir bitwise the RIR
  rendered and Griffin-Limed from a generator seeded 0, the pipeline's
  train generator, weights and module modes untouched; the source and
  orientation overrides; /auralize POST (int16 at 44.1 kHz, resampled)
  and GET under dry_audio_dir with its traversal guard; 403 / 400 / 404 /
  500. The orbit camera and the query parsing are bitwise the JAX
  package's.
- TrainThreadDispatcher: queued work runs on the pumping thread in the
  order it was queued, exceptions reach the caller, close() drains the
  queue and later work runs inline.
- cli.render / cli.loudness / cli.viewer on tests/test_torch_cli.py's tiny
  run: the JAX CLIs' file names, shapes and dtypes; each PNG bitwise the
  pipeline's own render; the loudness defaults (mean train mic height and
  source, first orientation) and its PNG.
- cli.train --viewer-port 0 with a client sending /render, /rir and /state
  during the run: every request answered, the first one by a pump between
  steps, and every checkpoint bitwise that of the same run without the
  viewer.
- Trainer.train(on_metrics=...) fires at the JAX Trainer's steps with the
  same scalar keys.
"""

import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from neraf_tpu_torch.cli import loudness, render, train
from neraf_tpu_torch.cli import viewer as cli_viewer
from neraf_tpu_torch.engine.factory import build_joint_pipeline
from neraf_tpu_torch.utils.png import quantize_rgb, read_png
from neraf_tpu_torch.viz import viewer
from neraf_tpu_torch.viz.auralization import rir_from_log_stft
from neraf_tpu_torch.viz.viewer import (
    TrainThreadDispatcher,
    ViewerBackend,
    _orbit_camera,
    serve,
)
from test_torch_cli import (  # noqa: F401  (pytest fixtures)
    _JStub,
    _Stub,
    _bitwise_diffs,
    _load,
    _no_scene_env,
    _train,
    scene_root,
)


@pytest.fixture(scope="module")
def pipe():
    return build_joint_pipeline(grid_res=8, tiny=True, device="cpu",
                                mixed_precision=False)


def _get(url):
    r = urllib.request.urlopen(url, timeout=120)
    return r.status, r.headers["Content-Type"], r.read()


def _status(url, data=None):
    try:
        return urllib.request.urlopen(urllib.request.Request(
            url, data=data, method="POST" if data else "GET"), timeout=120).status
    except urllib.error.HTTPError as e:
        return e.code


def _wav(body: bytes):
    return wavfile.read(io.BytesIO(body))


def _dry_wav_bytes(fs: int, seconds: float = 0.05, dtype=np.float32) -> bytes:
    t = np.arange(int(fs * seconds)) / fs
    dry = 0.5 * np.sin(2 * np.pi * 440 * t)
    if dtype == np.int16:
        dry = dry * 32767
    buf = io.BytesIO()
    wavfile.write(buf, fs, dry.astype(dtype))
    return buf.getvalue()


@pytest.fixture
def served(pipe, tmp_path):
    backend = ViewerBackend(pipe, dry_audio_dir=tmp_path / "dry")
    server = serve(backend, port=0, blocking=False)
    yield backend, f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()


def test_orbit_camera_and_query_parsing_are_bitwise_jax():
    from neraf_tpu.viz.viewer import _orbit_camera as j_orbit
    from neraf_tpu.viz.viewer import _parse_poses as j_parse

    for args in ((0.7, 0.3, 2.0), (0.0, 0.0, 1.0), (2.1, -1.2, 3.5),
                 (0.0, np.pi / 2, 1.0)):
        assert np.array_equal(_orbit_camera(*args), j_orbit(*args))
    for q in ({}, {"x": "1", "y": "-2.5"}, {"sx": "1", "rz": "0.1"},
              {"x": "0.3", "sy": "2", "sz": "-1", "rx": "0", "ry": "1"}):
        for a, b in zip(viewer._parse_poses(q), j_parse(q)):
            assert (a is None and b is None) or (
                a.dtype == b.dtype and np.array_equal(a, b))


def test_viewer_endpoints(pipe, served, tmp_path):
    backend, base = served
    gen_state = pipe.generator.get_state().clone()
    weights = {k: v.clone() for k, v in pipe.vision_model.state_dict().items()}
    assert _get(f"{base}/")[:2] == (200, "text/html")
    assert b"neraf-tpu viewer" in _get(f"{base}/")[2]

    status, ctype, png = _get(
        f"{base}/render?theta=0.4&phi=0.2&radius=2&w=16&h=12")
    assert (status, ctype) == (200, "image/png")
    (tmp_path / "v.png").write_bytes(png)
    cams = {"c2w": torch.as_tensor(_orbit_camera(0.4, 0.2, 2.0))[None],
            **{k: torch.tensor([v]) for k, v in (
                ("fx", 19.2), ("fy", 19.2), ("cx", 8.0), ("cy", 6.0))}}
    want = quantize_rgb(pipe.render_image(cams, 0, 12, 16)["rgb"])
    assert np.array_equal(read_png(tmp_path / "v.png"), want)

    status, ctype, wav = _get(f"{base}/rir?x=0.2&y=0&z=-0.1")
    assert (status, ctype) == (200, "audio/wav")
    fs, data = _wav(wav)
    cfg = pipe.audio_model.config
    log = pipe.render_rirs(np.array([[0.2, 0.0, -0.1]]),
                           pipe.audio_aabb.mean(0)[None],
                           np.array([[1.0, 0.5, 0.5]], np.float32))[0]
    rir = rir_from_log_stft(log, n_fft=cfg.n_fft, hop_len=cfg.hop_len,
                            win_len=cfg.win_len,
                            generator=torch.Generator().manual_seed(0))
    assert fs == cfg.fs and data.dtype == np.float32
    assert np.array_equal(data.T, rir.numpy()) and data.shape[1] == 2
    # the source-position and orientation override (the reference's viewer
    # source widget, NeRAF_model.py:215-219) changes the RIR
    wav2 = _get(f"{base}/rir?x=0.2&y=0&z=-0.1&sx=1&sy=0.5&sz=0.2&rx=0&ry=1&rz=0")[2]
    assert wav2[:4] == b"RIFF" and wav2 != wav

    status, ctype, body = _get(f"{base}/state")
    assert (status, ctype) == (200, "application/json")
    assert json.loads(body) == {"audio_aabb": [[-3.0] * 3, [3.0] * 3],
                                "grid_res": 8, "step": 0}
    assert _status(f"{base}/nope") == 404
    assert _status(f"{base}/render?w=abc") == 500
    # the train state is untouched: generator, weights, training modes
    assert torch.equal(pipe.generator.get_state(), gen_state)
    assert all(torch.equal(v, weights[k])
               for k, v in pipe.vision_model.state_dict().items())
    assert pipe.vision_model.training and pipe.resnet.training


def test_viewer_device_work_runs_on_one_thread(pipe, served, monkeypatch):
    """The server starts a thread a request; the standalone backend runs
    every request's device work on one long-lived thread of its own."""
    backend, base = served
    seen = []
    render_rirs = pipe.render_rirs

    def spy(*args):
        seen.append(threading.get_ident())
        return render_rirs(*args)

    monkeypatch.setattr(pipe, "render_rirs", spy)
    for x in ("0.1", "0.2", "0.3"):
        assert _get(f"{base}/rir?x={x}&y=0&z=0")[0] == 200
    assert len(seen) == 3 and len(set(seen)) == 1
    assert seen[0] != threading.get_ident()


def test_viewer_auralize_endpoint(pipe, served, tmp_path):
    backend, base = served
    fs = pipe.audio_model.config.fs
    status = urllib.request.urlopen(urllib.request.Request(
        f"{base}/auralize?x=0&y=0&z=0", method="POST",
        data=_dry_wav_bytes(44100, dtype=np.int16),
        headers={"Content-Type": "audio/wav"}), timeout=120)
    assert (status.status, status.headers["Content-Type"]) == (200, "audio/wav")
    got_fs, data = _wav(status.read())
    n_dry = -(-int(44100 * 0.05) * fs // 44100)  # resampled to the model's fs
    n_rir = pipe.audio_model.config.hop_len * (pipe.audio_model.config.max_len - 1)
    assert got_fs == fs and data.shape == (n_dry + n_rir - 1, 2)
    assert np.abs(data).max() <= 1.0 + 1e-6

    (tmp_path / "dry").mkdir()
    (tmp_path / "dry" / "dry48k.wav").write_bytes(_dry_wav_bytes(48000))
    status, ctype, wet = _get(f"{base}/auralize?x=0&y=0&z=0&file=dry48k.wav")
    assert (status, ctype) == (200, "audio/wav") and wet[:4] == b"RIFF"
    (tmp_path / "secret.wav").write_bytes(_dry_wav_bytes(fs))
    assert _status(f"{base}/auralize?x=0&y=0&z=0&file=../secret.wav") == 403
    assert _status(f"{base}/auralize?x=0&y=0&z=0") == 400
    assert _status(f"{base}/nope", data=b"x") == 404


def test_viewer_auralize_get_disabled_by_default(pipe):
    server = serve(ViewerBackend(pipe), port=0, blocking=False)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        assert _status(f"{base}/auralize?file=/etc/hostname") == 403
    finally:
        server.shutdown()
        server.server_close()


def _queue_from_threads(d, fns):
    """Each fn queued on d from a thread of its own, one after another ->
    (threads, results by index, exceptions by index)."""
    out, errs, threads = {}, {}, []
    for i, fn in enumerate(fns):
        def handler(i=i, fn=fn):
            try:
                out[i] = d(fn)
            except Exception as e:
                errs[i] = e
        t = threading.Thread(target=handler)
        t.start()
        threads.append(t)
        for _ in range(5000):
            if d._queue.qsize() == i + 1:
                break
            time.sleep(0.001)
    return threads, out, errs


def test_dispatcher_pumps_in_queue_order_on_the_training_thread():
    d = TrainThreadDispatcher(timeout_s=20)
    ran = []
    fns = [lambda i=i: ran.append((i, threading.get_ident())) or i * 10
           for i in range(3)] + [lambda: 1 / 0]
    threads, out, errs = _queue_from_threads(d, fns)
    assert d.pending() and not ran
    assert d.pump() == 4
    for t in threads:
        t.join(10)
    assert [i for i, _ in ran] == [0, 1, 2]
    assert {tid for _, tid in ran} == {threading.get_ident()}
    assert out == {0: 0, 1: 10, 2: 20}
    assert isinstance(errs[3], ZeroDivisionError)
    assert d.pump() == 0 and not d.pending()


def test_dispatcher_close_drains_then_runs_inline():
    d = TrainThreadDispatcher(timeout_s=20)
    threads, out, _ = _queue_from_threads(d, [lambda: "queued"])
    assert d.close() == 1
    threads[0].join(10)
    assert out == {0: "queued"}
    box = {}
    t = threading.Thread(target=lambda: box.update(
        v=d(lambda: threading.get_ident())))
    t.start()
    t.join(10)
    assert box["v"] == t.ident and not d.pending()


def test_trainer_on_metrics_matches_jax(tmp_path):
    from neraf_tpu.configs import config as jconfig
    from neraf_tpu.engine.trainer import Trainer as JTrainer
    from neraf_tpu_torch.configs import config as pconfig
    from neraf_tpu_torch.engine.trainer import Trainer

    import jax.numpy as jnp

    calls = {}
    for name, cfg_mod, trainer_cls, state in (
            ("jax", jconfig, JTrainer,
             _JStub(jnp.zeros((), jnp.int32), jnp.zeros(2))),
            ("port", pconfig, Trainer, _Stub())):
        cfg = cfg_mod.ExperimentConfig()
        cfg_mod.apply_overrides(cfg, ["trainer.steps_per_log=3"])

        def step_fn(s, name=name):
            if name == "jax":
                return s._replace(step=s.step + 1), {"loss": jnp.float32(2.0),
                                                     "lr": jnp.float32(0.5)}
            s.step += 1
            return s, {"loss": 2.0, "lr": 0.5}

        seen = calls[name] = []
        trainer_cls(config=cfg, pipeline=None, output_dir=tmp_path / name).train(
            state, step_fn=step_fn, max_steps=10,
            on_metrics=lambda step, scalars, seen=seen: seen.append(
                (step, sorted(scalars), scalars["loss"])))
    assert calls["port"] == calls["jax"] == [
        (s, ["loss", "lr", "steps_per_sec"], 2.0) for s in (3, 6, 9)]


# --------------------------------------------------------------- the CLIs
@pytest.fixture(scope="module")
def run(scene_root, tmp_path_factory):
    """tests/test_torch_cli.py's tiny joint run, 4 steps, checkpoints at 2
    and 4."""
    run_dir = tmp_path_factory.mktemp("serving") / "run"
    _train(scene_root, run_dir, 4)
    return run_dir


def _restored(run_dir):
    from neraf_tpu_torch.configs.config import load_config
    from neraf_tpu_torch.engine.checkpoints import restore_checkpoint
    from neraf_tpu_torch.engine.factory import build_pipeline

    bundle = build_pipeline(load_config(run_dir / "config.yml"), device="cpu")
    restore_checkpoint(run_dir / "neraf_models" / "step-000000004.pt",
                       bundle.pipeline)
    return bundle


@pytest.mark.parametrize("split", ["eval", "train"])
def test_cli_render_writes_the_jax_files(run, tmp_path, split):
    from neraf_tpu_torch.data.vision_data import camera_arrays

    out = render.main(["--load-config", str(run / "config.yml"),
                       "--output-dir", str(tmp_path / "out"), "--split", split],
                      device="cpu")
    bundle = _restored(run)
    ds = bundle.vision_eval if split == "eval" else bundle.vision_train
    n, H, W = len(ds.cameras), ds.cameras.height, ds.cameras.width
    assert n >= 1
    assert sorted(p.name for p in out.iterdir()) == sorted(
        [f"render_{i:04d}.png" for i in range(n)]
        + [f"depth_{i:04d}.npy" for i in range(n)])
    cams = camera_arrays(ds.cameras, "cpu")
    for i in range(n):
        img, depth = read_png(out / f"render_{i:04d}.png"), np.load(
            out / f"depth_{i:04d}.npy")
        assert img.shape == (H, W, 3) and img.dtype == np.uint8
        assert depth.shape == (H, W) and depth.dtype == np.float32
        want = bundle.pipeline.render_image(cams, i, H, W)
        assert np.array_equal(img, quantize_rgb(want["rgb"]))
        assert np.array_equal(depth, want["depth"].numpy())


def test_cli_loudness_writes_the_jax_files(run, tmp_path):
    from neraf_tpu_torch.viz.loudness import loudness_image

    argv = ["--load-config", str(run / "config.yml"), "--resolution", "6"]
    lm = loudness.main(argv + ["--output-dir", str(tmp_path / "a")], device="cpu")
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) == [
        "loudness_db.npy", "loudness_map.png"]
    saved = np.load(tmp_path / "a" / "loudness_db.npy")
    assert saved.shape == (6, 6) and saved.dtype == np.float32
    assert np.array_equal(saved, lm) and np.isfinite(lm).all()
    img = read_png(tmp_path / "a" / "loudness_map.png")
    assert img.shape == (512, 512, 3)
    assert np.array_equal(img, loudness_image(lm))
    # the defaults: mean train mic height and source, first orientation
    o = _restored(run).audio_train.outputs
    explicit = loudness.main(argv + [
        "--output-dir", str(tmp_path / "b"), "--height",
        repr(float(np.mean(o.microphone_poses[:, 1]))), "--source",
        *map(repr, np.mean(o.source_poses, axis=0).tolist())], device="cpu")
    assert np.array_equal(explicit, lm)


def test_cli_viewer_serves_the_run(run):
    server = cli_viewer.main(["--load-config", str(run / "config.yml"),
                              "--port", "0"], device="cpu", blocking=False)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        assert json.loads(_get(f"{base}/state")[2])["step"] == 4
        assert _get(f"{base}/render?w=8&h=8")[:2] == (200, "image/png")
    finally:
        server.shutdown()
        server.server_close()


def test_live_viewer_serves_during_training_bitwise(run, scene_root,
                                                    tmp_path, monkeypatch):
    """cli.train --viewer-port 0: a client's /render, /rir and /state are
    answered while the run trains (the first pump of the run waits for the
    first request, so it is served between steps), and the checkpoints of
    steps 2 and 4 are bitwise the run's without the viewer."""
    servers, pumps = [], []
    real_serve, real_pump = train.serve, TrainThreadDispatcher.pump

    def capture(*args, **kwargs):
        servers.append(real_serve(*args, **kwargs))
        return servers[-1]

    def pump(self):
        if not self._closed and not pumps:
            for _ in range(20000):
                if self.pending():
                    break
                time.sleep(0.001)
        n = real_pump(self)
        pumps.append((self._closed, n))
        return n

    monkeypatch.setattr(train, "serve", capture)
    monkeypatch.setattr(TrainThreadDispatcher, "pump", pump)
    answers = {}

    def client():
        for _ in range(20000):
            if servers:
                break
            time.sleep(0.001)
        base = f"http://127.0.0.1:{servers[0].server_address[1]}"
        for path in ("/render?w=8&h=8", "/rir?x=0.1&y=0&z=0", "/state"):
            answers[path] = _get(base + path)

    t = threading.Thread(target=client)
    t.start()
    _train(scene_root, tmp_path / "viewer", 4, "--viewer-port", "0")
    t.join(60)
    assert [answers[p][:2] for p in answers] == [
        (200, "image/png"), (200, "audio/wav"), (200, "application/json")]
    assert json.loads(answers["/state"][2])["step"] in (2, 4)
    assert pumps[0] == (False, 1) and sum(n for _, n in pumps) == 2
    assert pumps[-1][0]  # the run's end drained the queue
    with pytest.raises(urllib.error.URLError):  # the server stopped
        _get(f"http://127.0.0.1:{servers[0].server_address[1]}/state")
    for ckpt in ("step-000000002.pt", "step-000000004.pt"):
        assert not _bitwise_diffs(_load(run / "neraf_models" / ckpt),
                                  _load(tmp_path / "viewer/neraf_models" / ckpt))
