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
  5. the tiny slice in float32 on the card against the same slice on the CPU;
  6. the fused PE+MLP kernel against pe_mlp_plain on the card, in bf16 and
     f32, at the proposal-0 shape (8,388,608 rows, 39 -> 128 -> 128 -> 1)
     and the main field's (1,572,864 rows, 63 -> 256 x 4 -> 16);
  7. the full-width vision slice: a 512 x 512 synthetic SoundSpaces view
     (hfov 90 degrees, 8 chunks of 32,768 rays) through render_image three
     times (the first pays the cold start) and a second view once, then
     evaluate_vision over both views, with the launch counters read around
     the run; then a per-chunk breakdown of one more image;
  8. the tiny vision slice in float32 on the card against the CPU.

The last line of stdout is {"ok": true, "device": {...}}; the line before it
is the card's name and power limit, and the one before that lists the
kernels with their launch counts, errors and times.
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

# Fused PE+MLP, relative to the output's peak. bf16: the plain chain rounds
# every layer's product and bias add to bf16, the kernel adds the bias in
# f32 before one cast, so the two differ by bf16 rounding (9.2e-3 of the
# peak at most, measured on an H100 at both field shapes); a wrong product
# is O(1). The kernel must also be no further from the float64 chain than
# 1.5 times the plain bf16 chain is. f32: against the plain chain in float64
# (the f32 chain itself is 3e-5 of the peak off, from rounding angles of up
# to 2^8 turns, which the kernel reduces exactly), rtol 2e-4 plus atol 2e-5
# of the peak, the JAX package's bound for its kernel.
PE_BF16_REL_TOL, PE_BF16_VS_PLAIN = 1.5e-2, 1.5
PE_F32_RTOL, PE_F32_ATOL = 2e-4, 2e-5
RGB_ABS_TOL = 1e-4  # tiny vision slice, f32, card vs CPU
EVAL_NOISE, EVAL_MIN_PSNR = 0.02, 30.0  # evaluate_vision against render + noise


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


def pe_mlp_check(torch, dev, name, layers, F, n, seed):
    """Phase 6 at one shape: the kernel against the plain version, bf16
    and f32, and both timed (plain, kernel, kernel, plain)."""
    from neraf_tpu_torch.ops.cuda.pe_mlp import pe_mlp_cuda
    from neraf_tpu_torch.ops.pe_mlp import pe_mlp_plain

    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand((n, 3), generator=gen, device=dev)
    # the model's weights, with seeded biases so that the bias add is held
    layers = [(w.detach(), 0.1 * torch.randn(b.shape, generator=gen, device=dev))
              for w, b in layers]
    ref = pe_mlp_plain(x.double(), [(w.double(), b.double())
                                    for w, b in layers], F, 0.0, 8.0,
                       torch.float64)
    peak = float(ref.abs().max())
    row = {"rows": n}
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        out = pe_mlp_cuda(x, layers, F, 0.0, 8.0, dtype)
        torch.cuda.synchronize()
        if out.shape != ref.shape or not bool(torch.isfinite(out).all()):
            fail(f"pe_mlp {name} {tag}: shape {tuple(out.shape)} or not finite")
        diff64 = (out.double() - ref).abs()
        if dtype == torch.bfloat16:
            plain = pe_mlp_plain(x, layers, F, 0.0, 8.0, dtype)
            err = float((out - plain).abs().max())
            err64 = float(diff64.max())
            plain64 = float((plain.double() - ref).abs().max())
            ok = (err <= PE_BF16_REL_TOL * peak
                  and err64 <= PE_BF16_VS_PLAIN * plain64)
            bound = (f"{PE_BF16_REL_TOL} of the peak; against float64 "
                     f"{err64 / peak:.3e} vs plain bf16 {plain64 / peak:.3e}")
            del plain
        else:
            err = float(diff64.max())
            excess = float((diff64 - PE_F32_RTOL * ref.abs()).max())
            ok = excess <= PE_F32_ATOL * peak
            bound = (f"against float64, rtol {PE_F32_RTOL} + atol "
                     f"{PE_F32_ATOL} of the peak")
        del diff64
        reps = 5
        p1, k1, k2, p2 = (cuda_ms(torch, f, reps) for f in (
            lambda: pe_mlp_plain(x, layers, F, 0.0, 8.0, dtype),
            lambda: pe_mlp_cuda(x, layers, F, 0.0, 8.0, dtype),
            lambda: pe_mlp_cuda(x, layers, F, 0.0, 8.0, dtype),
            lambda: pe_mlp_plain(x, layers, F, 0.0, 8.0, dtype)))
        ms_k, ms_p = (k1 + k2) / 2, (p1 + p2) / 2
        print(f"pe_mlp {name} {n} rows {tag}: max_abs_err {err:.3e}, "
              f"rel {err / peak:.3e} (bound {bound}); kernel {ms_k:.3f} ms "
              f"[{k1:.3f}, {k2:.3f}] plain {ms_p:.3f} ms [{p1:.3f}, "
              f"{p2:.3f}]", flush=True)
        if not ok:
            fail(f"pe_mlp kernel disagrees with plain at {name} {tag}: "
                 f"max_abs_err {err}, peak {peak}")
        row[tag] = {"max_abs_err": err, "rel_err": err / peak, "ms": ms_k,
                    "plain_ms": ms_p}
        torch.cuda.empty_cache()
    return row


def check_image(torch, out, H, W, what):
    if tuple(out["rgb"].shape) != (H, W, 3) or tuple(
            out["depth"].shape) != (H, W) or tuple(
            out["accumulation"].shape) != (H, W):
        fail(f"{what}: shapes {[tuple(v.shape) for v in out.values()]}")
    if not all(bool(torch.isfinite(v).all()) for v in out.values()):
        fail(f"{what}: not finite")
    if not (float(out["rgb"].min()) >= 0.0 and float(out["rgb"].max()) <= 1.0):
        fail(f"{what}: rgb outside [0, 1]")
    acc = out["accumulation"]
    if not (float(acc.min()) >= 0.0 and float(acc.max()) <= 1.0 + 1e-3):
        fail(f"{what}: accumulation outside [0, 1]")


def chunk_breakdown(torch, pipe, arrays, H, W):
    """Per-chunk device time of one image (CUDA events from forward hooks):
    proposal 0, proposal 1, the main field, and the rest of the chunk."""
    model = pipe.vision_model
    parts = {"proposal_0": model.proposal_networks[0],
             "proposal_1": model.proposal_networks[1],
             "main_field": model.field, "chunk": model}
    events = {k: [] for k in parts}
    handles = []
    for k, mod in parts.items():
        def pre(_m, _a, k=k):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events[k].append([ev])

        def post(_m, _a, _o, k=k):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events[k][-1].append(ev)

        handles += [mod.register_forward_pre_hook(pre),
                    mod.register_forward_hook(post)]
    try:
        pipe.render_image(arrays, 0, H, W)
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    ms = {k: float(np.mean([a.elapsed_time(b) for a, b in v]))
          for k, v in events.items()}
    ms["rest"] = ms["chunk"] - ms["proposal_0"] - ms["proposal_1"] - ms[
        "main_field"]
    return ms, len(events["chunk"])


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
    from neraf_tpu_torch.data.vision_data import camera_arrays, synthetic_cameras
    from neraf_tpu_torch.dsp.stft import log_to_magnitude
    from neraf_tpu_torch.engine.factory import (
        build_render_pipeline,
        build_vision_pipeline,
    )
    from neraf_tpu_torch.ops.cuda import build
    from neraf_tpu_torch.ops.cuda import griffin_lim as gl_cuda
    from neraf_tpu_torch.ops.cuda import pe_mlp as pe_cuda

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
    gl_cuda.LAUNCHES = pe_cuda.LAUNCHES = 0
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
    launches, rir_pe_launches = gl_cuda.LAUNCHES, pe_cuda.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    if launches != len(requests) or rir_pe_launches != 0:
        fail(f"RIR path: GL kernel launched {launches} times for "
             f"{len(requests)} requests, pe_mlp {rir_pe_launches} times")
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
    del pipe, on
    torch.cuda.empty_cache()

    # phase 6: the fused PE+MLP kernel against the plain version, at the
    # shapes one 32,768-ray chunk of the full-width vision model gives it
    vpipe = build_vision_pipeline(tiny=False, device=dev, seed=0)
    vmodel = vpipe.vision_model
    vcfg = vmodel.config
    chunk = vcfg.eval_num_rays_per_chunk
    prop0 = vmodel.proposal(0)
    pe_rows = {
        "proposal_0": pe_mlp_check(
            torch, dev, "proposal_0", [(l.weight, l.bias) for l in prop0.mlp],
            prop0.num_frequencies, chunk * vcfg.num_proposal_samples[0], 1),
        "main_field": pe_mlp_check(
            torch, dev, "main_field", vmodel.field.base_layers(),
            vcfg.num_frequencies, chunk * vcfg.num_nerf_samples, 2),
    }

    # phase 7: the full-width vision slice through render_image and
    # evaluate_vision
    H = W = 512
    cams = synthetic_cameras(8, H, W, hfov_deg=90.0, seed=0)
    arrays = camera_arrays(cams, dev)
    n_chunks = -(-H * W // chunk)
    print(f"vision: full-width model (fourier F {vcfg.num_frequencies}, base "
          f"{vcfg.base_mlp_layers} x {vcfg.base_mlp_width}, samples "
          f"{vcfg.num_proposal_samples} -> {vcfg.num_nerf_samples}, "
          f"{vmodel.field.dtype}), {H} x {W} view, fx {float(cams.fx[0])}, "
          f"{n_chunks} chunks of {chunk} rays", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gl_cuda.LAUNCHES = pe_cuda.LAUNCHES = 0
    renders, img_times = [], []
    for cam in (0, 0, 0, 1):
        t0 = time.perf_counter()
        out = vpipe.render_image(arrays, cam, H, W)
        torch.cuda.synchronize()
        img_times.append(time.perf_counter() - t0)
        check_image(torch, out, H, W, f"render_image view {cam}")
        renders.append(out)
    noise = np.random.default_rng(3).normal(0.0, EVAL_NOISE, (2, H, W, 3))
    gt = np.clip(np.stack([renders[0]["rgb"].cpu().numpy(),
                           renders[3]["rgb"].cpu().numpy()]) + noise,
                 0.0, 1.0).astype(np.float32)
    ev = vpipe.evaluate_vision(arrays, gt)
    vis_launches, vis_gl_launches = pe_cuda.LAUNCHES, gl_cuda.LAUNCHES
    vis_peak = torch.cuda.max_memory_allocated()
    n_images = len(renders) + 2
    for cam, dt in zip((0, 0, 0, 1), img_times):
        print(f"vision render_image view {cam}: {dt * 1e3:.2f} ms, "
              f"{H * W / dt:.1f} rays/s")
    print(f"vision evaluate_vision (2 views): {json.dumps(ev)}")
    print(f"vision: pe_mlp launches {vis_launches} for {n_images} images of "
          f"{n_chunks} chunks, GL launches {vis_gl_launches}, peak memory "
          f"{vis_peak / 2**30:.3f} GiB", flush=True)
    if vis_launches != 3 * n_chunks * n_images or vis_gl_launches != 0:
        fail(f"vision path: pe_mlp launched {vis_launches} times, expected "
             f"{3 * n_chunks * n_images}; GL {vis_gl_launches} times")
    if not (np.isfinite(ev["psnr"]) and ev["psnr"] >= EVAL_MIN_PSNR
            and 0.0 < ev["ssim"] <= 1.0 and ev["lpips"] is None):
        fail(f"evaluate_vision against the renders plus noise: {ev}")
    repeat_err = max(float((a["rgb"] - renders[0]["rgb"]).abs().max())
                     for a in renders[1:3])
    print(f"vision: view 0 rendered three times, rgb max_abs_err between "
          f"renders {repeat_err:.3e}")
    if not repeat_err <= 1e-6:
        fail(f"render_image of one view differs between calls: {repeat_err}")
    parts, n_timed = chunk_breakdown(torch, vpipe, arrays, H, W)
    print(f"vision breakdown, mean of {n_timed} chunks (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts.items()), flush=True)
    print(f"nvidia-smi clocks.sm,power.draw,power.limit,temp: "
          f"{smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    del vpipe, vmodel, renders
    torch.cuda.empty_cache()

    # phase 8: tiny vision slice, f32 without TF32, card against CPU
    tiny = {d: build_vision_pipeline(tiny=True, device=d, seed=0,
                                     mixed_precision=False)
            for d in ("cpu", "cuda")}
    tcams = synthetic_cameras(8, 24, 20, seed=1)
    timg = {d: {k: v.cpu() for k, v in p.render_image(
        camera_arrays(tcams, d), 2, 24, 20).items()} for d, p in tiny.items()}
    rgb_err = float((timg["cuda"]["rgb"] - timg["cpu"]["rgb"]).abs().max())
    acc_err = float((timg["cuda"]["accumulation"]
                     - timg["cpu"]["accumulation"]).abs().max())
    print(f"tiny vision card vs cpu: rgb max_abs_err {rgb_err:.3e}, "
          f"accumulation {acc_err:.3e} (tol {RGB_ABS_TOL})")
    if not (rgb_err <= RGB_ABS_TOL and acc_err <= RGB_ABS_TOL):
        fail(f"tiny vision slice differs card vs CPU: rgb {rgb_err}, "
             f"accumulation {acc_err}")

    err, err32, ms_k, ms_p = gl_rows[("soundspaces", 1024)]
    main_bf16 = pe_rows["main_field"]["bf16"]
    print(json.dumps({"kernels": [{
        "name": "griffin_lim", "route": "cuda",
        "source": "neraf_tpu_torch/csrc/griffin_lim.cu",
        "replaces": "neraf_tpu/ops/pallas/griffin_lim_kernel.py:148",
        "launches": launches, "max_abs_err": err, "ms": ms_k,
        "plain_ms": ms_p, "max_abs_err_32_iter": err32}, {
        "name": "pe_mlp_fwd", "route": "cuda",
        "source": "neraf_tpu_torch/csrc/pe_mlp.cu",
        "replaces": "neraf_tpu/ops/pallas/fused_pe_mlp.py:373",
        "launches": vis_launches, "max_abs_err": main_bf16["max_abs_err"],
        "ms": main_bf16["ms"], "plain_ms": main_bf16["plain_ms"],
        "shapes": pe_rows}]}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
