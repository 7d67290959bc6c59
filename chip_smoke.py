#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (neraf_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. report the card (name, power limit);
  2. build the CUDA kernels from neraf_tpu_torch/csrc with nvcc;
  3. the Griffin-Lim kernel against griffin_lim_plain on the card, at the
     SoundSpaces geometry (128 and 1024 channels) and the RAF one (64);
  4. the full-width render slice (resnet50 over a 7x128^3 grid, w_field 512,
     T 78) serving three requests of 64 RIRs and two of 512 through
     render_waveforms (the first request pays the cold start), with the
     kernel launch counter read around the run;
  5. the tiny slice in float32 on the card against the same slice on the CPU.

The last line of stdout is {"ok": true, "device": {...}}; the line before it
lists the kernels with their launch counts, errors and times.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# Griffin-Lim amplifies float32 rounding over its iterations: against a
# float64 run, the kernel and cuFFT's torch.stft/istft both drift by ~1e-3 of
# the peak after 32 iterations, more in a channel where a bin's update is
# near zero (measured on an H100), while a wrong kernel is off by O(1). So
# waveforms are compared sample by sample after 4 iterations, to 1e-3 of their
# peak (the JAX package's Pallas-vs-XLA test uses the same bound), and after
# the served 32 iterations by the spectral convergence
# ||(|STFT(wav)| - mag)|| / ||mag||, the quantity GL minimises, to 1e-4.
GL_REL_TOL = 1e-3
SC_ABS_TOL = 1e-4
LOG_ABS_TOL = 1e-3  # card vs CPU f32 log-magnitudes (in [-10, 10])


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(torch, fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def poses(n: int, rng: np.random.Generator):
    mic = rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
    src = rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
    yaw = rng.uniform(0.0, 2 * np.pi, n)
    rot = ((np.stack([np.cos(yaw), np.zeros(n), np.sin(yaw)], -1) + 1) / 2)
    return mic, src, rot.astype(np.float32)


def rir_like_magnitudes(M, n_fft, hop, win, T, gen):
    """|STFT| of seeded exponentially decaying noise: (M, F, T) float32."""
    import torch

    from neraf_tpu_torch.dsp.stft import stft_magnitude

    t = torch.arange(hop * (T - 1)) / float(hop * (T - 1))
    x = torch.randn((M, t.shape[0]), generator=gen) * torch.exp(-6.0 * t)
    return stft_magnitude(x, n_fft, hop, win).contiguous()


def spectral_convergence(wav, mag, n_fft, hop, win) -> float:
    from neraf_tpu_torch.dsp.stft import stft_magnitude

    rebuilt = stft_magnitude(wav, n_fft, hop, win)
    return float((rebuilt - mag).norm() / mag.norm())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    from neraf_tpu_torch.dsp.griffin_lim import (
        griffin_lim,
        griffin_lim_plain,
        random_angles,
    )
    from neraf_tpu_torch.dsp.stft import log_to_magnitude
    from neraf_tpu_torch.engine.factory import build_render_pipeline
    from neraf_tpu_torch.ops.cuda import build
    from neraf_tpu_torch.ops.cuda import griffin_lim as gl_cuda

    dev = torch.device("cuda")
    # phase 1: the card
    name = torch.cuda.get_device_name(0)
    smi_line = smi("name,power.limit")
    print(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"nvidia-smi: {smi_line}", flush=True)

    # phase 2: build
    t0 = time.perf_counter()
    build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({build.library_path().name})")
    print(build.build_log(), flush=True)

    # phase 3: the GL kernel against the plain version on the card
    gl_rows = {}
    for geo, n_fft, hop, win, T, M in (("soundspaces", 512, 128, 512, 78, 128),
                                       ("soundspaces", 512, 128, 512, 78, 1024),
                                       ("raf", 1024, 256, 512, 60, 64)):
        gen = torch.Generator().manual_seed(M)
        F = n_fft // 2 + 1
        mag = rir_like_magnitudes(M, n_fft, hop, win, T, gen).to(dev)
        ang = random_angles(mag.shape, gen, dev)
        kw = dict(n_fft=n_fft, hop_length=hop, win_length=win)
        run_k = lambda n: gl_cuda.griffin_lim_cuda(mag, ang, n_iter=n, **kw)
        run_p = lambda n: griffin_lim_plain(mag, init_angles=ang, n_iter=n, **kw)
        k4, p4 = run_k(4), run_p(4)
        out_k, out_p = run_k(32), run_p(32)
        torch.cuda.synchronize()
        if out_k.shape != (M, hop * (T - 1)):
            fail(f"GL kernel shape {tuple(out_k.shape)}")
        err = float((k4 - p4).abs().max())
        rel = err / float(p4.abs().max())
        err32 = float((out_k - out_p).abs().max())
        chan = ((out_k - out_p).abs().amax(-1) / out_p.abs().amax(-1)).cpu()
        sc_k, sc_p = (spectral_convergence(w, mag, n_fft, hop, win)
                      for w in (out_k, out_p))
        reps = 3
        p1, k1, k2, p2 = (cuda_ms(torch, f, reps) for f in (
            lambda: run_p(32), lambda: run_k(32), lambda: run_k(32),
            lambda: run_p(32)))
        ms_k, ms_p = (k1 + k2) / 2, (p1 + p2) / 2
        print(f"gl {geo} M={M} F={F} T={T}: 4 iter max_abs_err={err:.3e} "
              f"rel={rel:.3e} (tol {GL_REL_TOL}); 32 iter max_abs_err="
              f"{err32:.3e}, per-channel rel median {float(chan.median()):.3e}"
              f" max {float(chan.max()):.3e}, spectral convergence "
              f"{sc_k:.7f} vs {sc_p:.7f} (tol {SC_ABS_TOL}); 32 iter kernel "
              f"{ms_k:.3f} ms [{k1:.3f}, {k2:.3f}] plain {ms_p:.3f} ms "
              f"[{p1:.3f}, {p2:.3f}]", flush=True)
        if not (rel <= GL_REL_TOL and abs(sc_k - sc_p) <= SC_ABS_TOL):
            fail(f"GL kernel disagrees with plain at {geo} M={M}: rel {rel}, "
                 f"spectral convergence {sc_k} vs {sc_p}")
        gl_rows[(geo, M)] = (err, err32, ms_k, ms_p)
    print(f"nvidia-smi clocks.sm,power.draw,power.limit,temp: "
          f"{smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    # phase 4: the full-width slice through the served entry point
    t0 = time.perf_counter()
    pipe = build_render_pipeline(grid_res=128, tiny=False, device=dev, seed=0)
    torch.cuda.synchronize()
    print(f"slice: built full-width pipeline in {time.perf_counter() - t0:.2f}"
          f" s ({pipe.resnet.backbone}, grid 128^3, "
          f"w_field {pipe.audio_model.config.w_field}, "
          f"T {pipe.audio_model.config.max_len}, {pipe.dtype})", flush=True)
    cfg = pipe.audio_model.config
    length = cfg.hop_len * (cfg.max_len - 1)
    rng = np.random.default_rng(0)
    requests = [poses(n, rng) for n in (64, 64, 64, 512, 512)]
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gl_cuda.LAUNCHES = 0
    times = []
    for mic, src, rot in requests:
        t0 = time.perf_counter()
        wav = pipe.render_waveforms(mic, src, rot, generator=gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        n = mic.shape[0]
        if wav.shape != (n, cfg.mic_ch, length):
            fail(f"slice output shape {tuple(wav.shape)}")
        if not bool(torch.isfinite(wav).all()):
            fail("slice output not finite")
        if not float(wav.abs().max()) > 0:
            fail("slice output is all zero")
    launches = gl_cuda.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    if launches != len(requests):
        fail(f"GL kernel launched {launches} times for {len(requests)} requests")
    for (mic, _, _), dt in zip(requests, times):
        print(f"slice request {mic.shape[0]} RIRs: {dt * 1e3:.2f} ms, "
              f"{mic.shape[0] / dt:.2f} RIRs/s")
    print(f"slice: GL launches {launches}, peak memory {peak / 2**30:.3f} GiB")

    # breakdown of one request, stage by stage (outside the counted run)
    for n in (64, 512):
        mic, src, rot = requests[-1] if n == 512 else requests[0]
        log = pipe.render_rirs(mic, src, rot)
        mag = log_to_magnitude(log)
        ang = random_angles(mag.shape, gen, dev)
        stages = {
            "grid_feature": lambda: pipe.grid_feature(),
            "render_rirs": lambda: pipe.render_rirs(mic, src, rot),
            "griffin_lim": lambda: pipe._griffin_lim(mag, ang),
        }
        parts = {k: cuda_ms(torch, f, 3) for k, f in stages.items()}
        print(f"slice breakdown {n} RIRs (ms): " +
              ", ".join(f"{k} {v:.3f}" for k, v in parts.items()), flush=True)

    # phase 5: tiny slice, f32 without TF32, card against CPU
    on = {d: build_render_pipeline(grid_res=16, tiny=True, device=d, seed=0,
                                   mixed_precision=False)
          for d in ("cpu", "cuda")}
    mic, src, rot = poses(4, np.random.default_rng(1))
    log = {d: p.render_rirs(mic, src, rot).cpu() for d, p in on.items()}
    log_err = float((log["cuda"] - log["cpu"]).abs().max())
    ang = random_angles(log["cpu"].shape, torch.Generator().manual_seed(2))
    tcfg = on["cpu"].audio_model.config
    geo = (tcfg.n_fft, tcfg.hop_len, tcfg.win_len)
    mag = {d: log_to_magnitude(v) for d, v in log.items()}
    wav = {(d, n): griffin_lim(mag[d].to(d), init_angles=ang.to(d), n_iter=n,
                               n_fft=geo[0], hop_length=geo[1],
                               win_length=geo[2]).cpu()
           for d in ("cpu", "cuda") for n in (4, 32)}
    w4 = wav[("cpu", 4)]
    wav_rel = float((wav[("cuda", 4)] - w4).abs().max() / w4.abs().max())
    sc_gpu, sc_cpu = (spectral_convergence(wav[(d, 32)], mag["cpu"], *geo)
                      for d in ("cuda", "cpu"))
    print(f"tiny card vs cpu: log max_abs_err {log_err:.3e} (tol "
          f"{LOG_ABS_TOL}); 4 iter wav rel err {wav_rel:.3e} (tol "
          f"{GL_REL_TOL}); 32 iter spectral convergence {sc_gpu:.7f} vs "
          f"{sc_cpu:.7f} (tol {SC_ABS_TOL})")
    if not log_err <= LOG_ABS_TOL:
        fail(f"tiny slice log-mags differ card vs CPU: {log_err}")
    if not (wav_rel <= GL_REL_TOL and abs(sc_gpu - sc_cpu) <= SC_ABS_TOL):
        fail(f"tiny slice waveforms differ card vs CPU: {wav_rel}, "
             f"{sc_gpu} vs {sc_cpu}")

    err, err32, ms_k, ms_p = gl_rows[("soundspaces", 1024)]
    print(json.dumps({"kernels": [{
        "name": "griffin_lim", "route": "cuda",
        "source": "neraf_tpu_torch/csrc/griffin_lim.cu",
        "replaces": "neraf_tpu/ops/pallas/griffin_lim_kernel.py:148",
        "launches": launches, "max_abs_err": err, "ms": ms_k,
        "plain_ms": ms_p, "max_abs_err_32_iter": err32}]}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
