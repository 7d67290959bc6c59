"""Interactive viewer: an HTTP render server (counterpart of
neraf_tpu/viz/viewer.py, the reference's ns-viewer with its audio hooks,
NeRAF_model.py:215-267). A stdlib HTTP server exposing

  GET /                 — minimal HTML front end (orbit with arrow keys)
  GET /render?theta=..&phi=..&radius=..&w=..&h=..  — PNG render of that view
  GET /rir?x=..&y=..&z=..                          — WAV RIR at a mic position
  GET /auralize?x=..&y=..&z=..&file=dry.wav        — wet WAV (file relative to
                                                     the configured dry_audio_dir;
                                                     403 when unset)
  POST /auralize?x=..&y=..&z=..  (body = dry WAV)  — wet WAV (uploaded dry audio)
  GET /state                                        — JSON scene info

/render is JointPipeline.render_image (the PE+MLP forward kernel on a
card); /rir and /auralize render one RIR and Griffin-Lim it (the GL
kernel). Start with `python -m neraf_tpu_torch.cli.viewer --load-config
...`, during training with `cli.train --viewer-port`, or through serve().

Threads. The server starts a thread for every request, and torch keeps
some caches per thread (cuDNN's execution plans for the ResNet's
convolutions among them), so device work never runs on a handler thread:
standalone, it runs on one long-lived device thread of the backend's, one
request at a time. During training the pipeline's modules are the train
state itself: nothing is donated, so no snapshot is taken, but a render
flips the shared modules to eval mode (BatchNorm on its running
statistics) and the optimizers update the weights in place, so a render
from another thread during a step would change the step or read
half-updated weights. Viewer work therefore runs on the training thread:
handler threads queue it on a TrainThreadDispatcher, which the training
loop pumps from its on_metrics hook, between steps. Griffin-Lim's angles come from a generator of the
backend's own, seeded 0 for every request (the JAX default key is
PRNGKey(0)), never the pipeline's training generator, so a run with the
viewer on trains as it does without it.
"""

from __future__ import annotations

import io
import json
import math
import os.path as osp
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch
from scipy.io import wavfile

from neraf_tpu_torch.dsp.resample import resample_poly
from neraf_tpu_torch.utils.png import encode_png, quantize_rgb
from neraf_tpu_torch.viz.auralization import auralize, rir_from_log_stft

_INDEX_HTML = """<!doctype html>
<html><head><title>neraf-tpu viewer</title><style>
body{background:#111;color:#eee;font-family:monospace;text-align:center}
img{image-rendering:pixelated;border:1px solid #444;margin-top:1em}
</style></head><body>
<h3>neraf-tpu viewer</h3>
<div>arrow keys: orbit &nbsp; +/-: zoom</div>
<img id="v" width="512" height="512">
<script>
let th=0, ph=0.3, r=2.0;
function refresh(){
  document.getElementById('v').src=`/render?theta=${th}&phi=${ph}&radius=${r}&w=128&h=128&_=${Date.now()}`;
}
document.addEventListener('keydown',e=>{
  if(e.key==='ArrowLeft')th-=0.2; if(e.key==='ArrowRight')th+=0.2;
  if(e.key==='ArrowUp')ph=Math.min(1.4,ph+0.1); if(e.key==='ArrowDown')ph=Math.max(-1.4,ph-0.1);
  if(e.key==='+')r=Math.max(0.3,r-0.2); if(e.key==='-')r+=0.2;
  refresh();
});
refresh();
</script></body></html>"""


def _orbit_camera(theta: float, phi: float, radius: float) -> np.ndarray:
    """c2w for a camera orbiting the origin (OpenGL convention)."""
    pos = np.array([
        radius * np.cos(phi) * np.cos(theta),
        radius * np.cos(phi) * np.sin(theta),
        radius * np.sin(phi),
    ])
    forward = -pos / np.linalg.norm(pos)
    up0 = np.array([0.0, 0.0, 1.0])
    right = np.cross(forward, up0)
    n = np.linalg.norm(right)
    right = np.array([1.0, 0, 0]) if n < 1e-6 else right / n
    up = np.cross(right, forward)
    c2w = np.zeros((3, 4), dtype=np.float32)
    c2w[:, 0], c2w[:, 1], c2w[:, 2], c2w[:, 3] = right, up, -forward, pos
    return c2w


class TrainThreadDispatcher:
    """Runs viewer work on the training thread (module docstring).

    A handler thread calls dispatcher(fn): fn is queued and the handler
    blocks until the training loop's pump() has run it, in the order the
    requests were queued, and gets its result or its exception. After
    close() (training over) the queue is drained and later calls run fn
    at once, on the caller's thread.
    """

    def __init__(self, timeout_s: float = 300.0):
        self._queue = queue.Queue()
        self._lock = threading.Lock()
        self._closed = False
        self.timeout_s = timeout_s

    def __call__(self, fn):
        with self._lock:
            inline = self._closed
            if not inline:
                ev, box = threading.Event(), {}
                self._queue.put((fn, ev, box))
        if inline:
            return fn()
        if not ev.wait(self.timeout_s):
            raise TimeoutError(
                "training loop did not service the viewer request "
                f"within {self.timeout_s:.0f}s")
        if "err" in box:
            raise box["err"]
        return box["out"]

    def pending(self) -> bool:
        """True when at least one viewer request is waiting for pump()."""
        return not self._queue.empty()

    def pump(self) -> int:
        """Run the queued work on the calling (training) thread -> how many
        requests ran."""
        n = 0
        while True:
            try:
                fn, ev, box = self._queue.get_nowait()
            except queue.Empty:
                return n
            try:
                box["out"] = fn()
            except Exception as e:  # surfaced to the waiting handler
                box["err"] = e
            ev.set()
            n += 1

    def close(self) -> int:
        """Training is over: run what is queued, and every later request
        inline -> how many queued requests ran."""
        with self._lock:
            self._closed = True
        return self.pump()


# the seed of every request's Griffin-Lim angles, drawn from a CPU
# generator of the backend's own (a card and the CPU start from the same
# angles; the JAX default key is PRNGKey(0))
GL_SEED = 0


class ViewerBackend:
    """Bridges HTTP requests to a JointPipeline's renders, one at a time.

    dispatch: a callable that runs each unit of device work (a
    TrainThreadDispatcher during training); by default the backend's own
    device thread runs it. WAVs are written at the audio model's rate.
    """

    def __init__(self, pipeline, dispatch=None, dry_audio_dir=None):
        self.pipeline = pipeline
        # GET /auralize?file=... serves wavs under this directory only; when
        # None the GET variant is disabled (POST the wav body instead): the
        # HTTP server must not be an arbitrary-file read oracle
        self.dry_audio_dir = dry_audio_dir
        self.step_hint: int | None = None  # the step last pumped (training)
        if dispatch is None:
            device_thread = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="viewer-device")
            dispatch = lambda fn: device_thread.submit(fn).result()
        self._dispatch = dispatch
        self._lock = threading.Lock()
        # read once here: /state stays free of device work
        self._aabb_list = pipeline.audio_aabb.cpu().numpy().tolist()

    def render_view(self, theta: float, phi: float, radius: float,
                    w: int, h: int) -> bytes:
        """A (h, w) PNG of the orbit camera at (theta, phi, radius)."""
        c2w = _orbit_camera(theta, phi, radius)
        focal = 1.2 * w

        def _work():
            dev = self.pipeline.device
            row = lambda v: torch.tensor([v], dtype=torch.float32, device=dev)
            cams = {"c2w": torch.as_tensor(c2w, device=dev)[None],
                    "fx": row(focal), "fy": row(focal),
                    "cx": row(w / 2.0), "cy": row(h / 2.0)}
            return quantize_rgb(self.pipeline.render_image(cams, 0, h, w)["rgb"])

        with self._lock:
            rgb = self._dispatch(_work)
        return encode_png(rgb)

    def _rir(self, mic: np.ndarray, src: np.ndarray | None = None,
             rot: np.ndarray | None = None) -> torch.Tensor:
        """Device work: the (C, L) RIR waveform at `mic`, on the pipeline's
        device; call only through self._dispatch.

        src / rot default to the audio box's centre and a fixed
        orientation; the reference offers the same override as a viewer
        source-position widget (NeRAF_model.py:215-219).
        """
        pipe = self.pipeline
        cfg = pipe.audio_model.config
        if src is None:
            src = pipe.audio_aabb.mean(dim=0)
        if rot is None:
            rot = np.array([1.0, 0.5, 0.5], np.float32)
        log_pred = pipe.render_rirs(np.asarray(mic)[None],
                                    torch.as_tensor(src)[None],
                                    np.asarray(rot)[None])[0]
        return rir_from_log_stft(
            log_pred, n_fft=cfg.n_fft, hop_len=cfg.hop_len, win_len=cfg.win_len,
            generator=torch.Generator().manual_seed(GL_SEED))

    def predict_rir(self, mic: np.ndarray, src: np.ndarray | None = None,
                    rot: np.ndarray | None = None) -> np.ndarray:
        """The (C, L) RIR waveform at a mic position."""
        with self._lock:
            return self._dispatch(
                lambda: self._rir(mic, src, rot).cpu().numpy())

    def _wav_bytes(self, wav: np.ndarray) -> bytes:
        buf = io.BytesIO()
        wavfile.write(buf, self.pipeline.audio_model.config.fs,
                      np.asarray(wav, np.float32).T)
        return buf.getvalue()

    def render_rir_wav(self, mic: np.ndarray, src: np.ndarray | None = None,
                       rot: np.ndarray | None = None) -> bytes:
        return self._wav_bytes(self.predict_rir(mic, src, rot))

    def auralize_wav(self, mic: np.ndarray, wav_bytes: bytes,
                     src: np.ndarray | None = None,
                     rot: np.ndarray | None = None) -> bytes:
        """Dry WAV bytes -> wet WAV convolved with the RIR at `mic` (the
        reference's viewer auralization button, NeRAF_model.py:221-267):
        PCM scaled by its original dtype, stereo averaged, resampled to the
        model's rate, then viz/auralization.py::auralize; peak-normalised
        when it exceeds 1."""
        cfg = self.pipeline.audio_model.config
        in_fs, dry = wavfile.read(io.BytesIO(wav_bytes))
        # PCM scaling decided on the ORIGINAL dtype, before any float cast
        if dry.dtype == np.int16:
            dry = dry.astype(np.float32) / 32768.0
        elif dry.dtype == np.int32:
            dry = dry.astype(np.float32) / 2147483648.0
        elif dry.dtype == np.uint8:
            dry = (dry.astype(np.float32) - 128.0) / 128.0
        else:
            dry = np.array(dry, np.float32)  # a writable copy
        if dry.ndim == 2:
            dry = dry.mean(axis=-1)

        def _work():  # all device work in one dispatched unit
            d = torch.as_tensor(dry, device=self.pipeline.device)
            if in_fs != cfg.fs:
                g = math.gcd(int(cfg.fs), int(in_fs))
                d = resample_poly(d, cfg.fs // g, in_fs // g)
            return auralize(d, self._rir(mic, src, rot), cfg.fs).cpu().numpy()

        with self._lock:
            wet = self._dispatch(_work)
        peak = np.abs(wet).max()
        if peak > 1.0:
            wet = wet / peak
        return self._wav_bytes(wet)

    def scene_state(self) -> dict:
        """Scene info; no device work (the step is step_hint during
        training, else the pipeline's host-side counter)."""
        step = self.step_hint if self.step_hint is not None else int(
            self.pipeline.step)
        return {"audio_aabb": self._aabb_list,
                "grid_res": self.pipeline.grid_res, "step": step}


def _parse_poses(q: dict):
    """(mic, src, rot) from query params; src / rot None unless overridden
    (sx/sy/sz the source position, rx/ry/rz the orientation encoding)."""
    mic = np.array([float(q.get("x", 0)), float(q.get("y", 0)),
                    float(q.get("z", 0))])
    src = rot = None
    if any(k in q for k in ("sx", "sy", "sz")):
        src = np.array([float(q.get("sx", 0)), float(q.get("sy", 0)),
                        float(q.get("sz", 0))])
    if any(k in q for k in ("rx", "ry", "rz")):
        rot = np.array([float(q.get("rx", 1.0)), float(q.get("ry", 0.5)),
                        float(q.get("rz", 0.5))], np.float32)
    return mic, src, rot


def make_handler(backend: ViewerBackend):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            q = {k: v[0] for k, v in parse_qs(url.query).items()}
            try:
                if url.path == "/":
                    self._send(200, _INDEX_HTML.encode(), "text/html")
                elif url.path == "/render":
                    png = backend.render_view(
                        float(q.get("theta", 0)), float(q.get("phi", 0.3)),
                        float(q.get("radius", 2.0)),
                        int(q.get("w", 128)), int(q.get("h", 128)))
                    self._send(200, png, "image/png")
                elif url.path == "/rir":
                    mic, src, rot = _parse_poses(q)
                    self._send(200, backend.render_rir_wav(mic, src, rot),
                               "audio/wav")
                elif url.path == "/auralize":
                    # GET variant: a server-side dry WAV, restricted to
                    # backend.dry_audio_dir (no path traversal)
                    mic, src, rot = _parse_poses(q)
                    path = q.get("file")
                    if backend.dry_audio_dir is None:
                        self._send(403, b"server-side dry files disabled; "
                                   b"POST a wav body, or start the viewer "
                                   b"with a dry_audio_dir", "text/plain")
                    elif not path:
                        self._send(400, b"missing ?file= (or POST a wav body)",
                                   "text/plain")
                    else:
                        root = osp.realpath(str(backend.dry_audio_dir))
                        full = osp.realpath(osp.join(root, path))
                        if not (full == root or
                                full.startswith(root + osp.sep)):
                            self._send(403, b"file outside dry_audio_dir",
                                       "text/plain")
                        else:
                            with open(full, "rb") as f:
                                body = f.read()
                            self._send(200,
                                       backend.auralize_wav(mic, body, src, rot),
                                       "audio/wav")
                elif url.path == "/state":
                    self._send(200, json.dumps(backend.scene_state()).encode(),
                               "application/json")
                else:
                    self._send(404, b"not found", "text/plain")
            except Exception as e:  # render errors reach the client
                self._send(500, str(e).encode(), "text/plain")

        def do_POST(self):
            url = urlparse(self.path)
            q = {k: v[0] for k, v in parse_qs(url.query).items()}
            try:
                if url.path == "/auralize":
                    # POST body = dry WAV -> wet WAV at the queried poses
                    mic, src, rot = _parse_poses(q)
                    n = int(self.headers.get("Content-Length", 0))
                    body = self.rfile.read(n)
                    self._send(200, backend.auralize_wav(mic, body, src, rot),
                               "audio/wav")
                else:
                    self._send(404, b"not found", "text/plain")
            except Exception as e:
                self._send(500, str(e).encode(), "text/plain")

    return Handler


def serve(backend: ViewerBackend, host: str = "127.0.0.1", port: int = 7007,
          blocking: bool = True) -> ThreadingHTTPServer:
    """Serve the backend on host:port (0 picks a free port) and print the
    bound address; blocking serves until interrupted, else a daemon thread
    serves and the server is returned (server_address[1] is the port,
    server.backend the backend)."""
    server = ThreadingHTTPServer((host, port), make_handler(backend))
    server.backend = backend
    print(f"viewer at http://{host}:{server.server_address[1]}", flush=True)
    if blocking:
        try:
            server.serve_forever()
        finally:
            server.server_close()
    else:
        threading.Thread(target=server.serve_forever, daemon=True).start()
    return server
