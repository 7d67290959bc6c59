#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (neraf_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. report the card (name, power limit);
  2. build the CUDA kernels from neraf_tpu_torch/csrc with nvcc;
  3. the Griffin-Lim kernel against griffin_lim_plain on the card, at the
     SoundSpaces geometry (128 and 1024 channels) and the RAF one (64): its
     launch plan, two launches bitwise equal, timed in turns with the plain
     version beside its bound and the per-bin state's bytes a call;
  4. the full-width render slice (resnet50 over a 7x128^3 grid, w_field 512,
     T 78) serving three requests of 64 RIRs and two of 512 through
     render_waveforms (the first request pays the cold start), with the
     kernel launch counter read around the run;
  5. the tiny slice in float32 on the card against the same slice on the CPU;
  6. the fused PE+MLP kernel against pe_mlp_plain on the card, in bf16 and
     f32, at the proposal-0 shape (8,388,608 rows, 39 -> 128 -> 128 -> 1)
     and the main field's (1,572,864 rows, 63 -> 256 x 4 -> 16), timed in
     turns with the plain chain beside its bound and its share of it;
  7. the full-width vision slice: a 512 x 512 synthetic SoundSpaces view
     (hfov 90 degrees, 8 chunks of 32,768 rays) through render_image three
     times (the first pays the cold start) and a second view once, then
     evaluate_vision over both views, with the launch counters read around
     the run; then a per-chunk breakdown of one more image;
  8. the tiny vision slice in float32 on the card against the CPU;
  9. the PE+MLP forward and backward kernels against pe_mlp_plain and its
     autograd on the card, bf16 and f32, at the four shapes one joint train
     step gives them (proposal 0: 1,048,576 rows, proposal 1: 393,216, main
     field: 196,608, grid bake: 73,728 without dx), with the training
     model's weights and seeded biases; the forward alone, the backward
     alone and forward + backward timed in turns with the plain chain, each
     beside its bound and share, and the backward's device kernels of one
     call under torch.profiler;
 10. the full-width joint train step (JointPipeline.train_step: 4096 rays,
     2048 STFT slices, 4096 grid cells, resnet50 over 7x128^3, bf16) on the
     bench.py inputs with the audio branch live: one cold step, two more
     while the allocator settles, then ten warm ones, finite metrics,
     cursor, step and grid advanced as the JAX step does them, exactly 4
     forward and 4 backward pe_mlp launches a step and no GL launch, ms per
     step, rays/s, peak memory and a per-stage breakdown by CUDA events;
     then 3 steps under torch.profiler (device busy time, idle share, the
     PE+MLP wrappers' device kernels a step) and the ResNet and its stem
     convolution timed alone;
 11. the tiny joint step in float32 on the card against the same step on
     the CPU with its fields in float64, from the same weights and draws;
 12. the hash-encoding forward and backward kernels against the plain
     version and its autograd on the card, at the full-width grid (8 levels
     x 4 features, 2^19 rows a level): at uniform random points of the
     three row counts the main path gives them (train step's main field
     196,608 rows, grid bake 73,728, a render chunk's main field
     1,572,864) and at tcnn's 16 x 2 layout, then at the main path's own
     points, taken by a forward hook on the HashTable from a render chunk
     and from one full-width hash joint step; each timed beside the plain
     version and its bound, with the table gradient atomics and the
     forward's L2 sector requests counted from the points (also alone:
     scripts/hash_check.py);
 13. the full-width hash render (VisionPipeline with encoding="hash") as
     phase 7: 1 hash forward and 2 pe_mlp launches a chunk;
 14. the full-width hash joint step as phase 10: 2 hash forward + 2 hash
     backward and 2 + 2 pe_mlp launches a step, the table changed, the
     hash kernels' device time a step, and the table's zeroed gradient and
     its two Adam updates timed alone;
 15. the tiny hash joint step (4 levels, 2^10 rows, resolutions 4-32) card
     against CPU as phase 11, at 2 and at 4 features a level;
 16. cuDNN's bf16 stem convolution (forward, input gradient, weight
     gradient) at the step's shape with 7 input channels and with the 8 of
     the packed volume, on the same inputs, each width held against the
     other and timed in turns beside its bound, and the pack timed alone;
     then the stem weight-gradient kernel against stem_wgrad_plain in
     float64 on the same inputs, bf16 and f32, two calls bitwise equal, at
     the step's shape (x 7 x 128^3, g 64 x 64^3), a small cube and two D !=
     H != W volumes (one with 8 input channels), timed at each beside the
     plain version and cuDNN's weight gradient;
 17. the full-width fourier joint step as phase 10 with
     NERAF_STEM_WGRAD_PALLAS=1: exactly one stem-kernel launch a step (and
     none in phases 10 and 14), its ms per step, device busy time and the
     stem kernel's three device kernels a step beside cuDNN's weight-gradient
     kernels, against phase 10's run with the gate off in the same call
     (both profiles also list any cuDNN kernel on f32 operands, "f32f32");
     then steps of a gate-off and the gate-on pipeline in turns;
 18. the tiny f32 joint step with the gate on, card against CPU, as phase
     11 (the card's stem weight gradient from the f32 kernel, the CPU's
     from the plain version);
 19. the shifted-slice concat kernel against torch.cat, bitwise, at (8, 19,
     128) t 16, (8, 19, 256) t 16 and (1024, 79, 128) t 78, timed at the
     last beside torch.cat;
 20. the joint pipeline's eval paths on the full-width fourier pipeline
     (seed 0, bf16, two train steps first) and a synthetic SoundSpaces eval
     split of 1,024 RIRs (data/synthetic.py): evaluate_audio and
     evaluate_audio_device at chunks of 512, twice each, with the JAX
     paths' keys, finite values, 4 and 2 GL launches a sweep and no
     pe_mlp launch, fps_audio, ms a chunk and the host metrics' seconds;
     the batched estimators against the host ones per RIR on the GT
     waveforms (fatal) and on one chunk's predictions (printed);
     eval_loss_dict (3 pe_mlp launches), eval_image on a 512 x 512 view
     and one RIR (24), query_grid_full over 2,097,152 cells (512), each
     timed; the train state bitwise unchanged by the phase; then the tiny
     f32 eval_loss_dict and the GT estimates, card against CPU.

The last line of stdout is {"ok": true, "device": {...}}; the line before it
is the card's name and power limit, and the one before that lists the
kernels with their launch counts, errors and times.
"""

from __future__ import annotations

import dataclasses
import json
import os
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
# PE+MLP backward. bf16, by relative L2 error ||a - b|| / ||b|| of each of
# dx, dW, db: a ReLU mask flips wherever bf16 rounding moves a
# pre-activation across 0, at different units in the kernel and the plain
# chain, and a flipped unit's whole gradient moves, so both sit ~5% (about
# the square root of the flipped fraction) from the float64 backward, and
# ~5-9% from each other (measured on an H100); a wrong product is O(1).
# Against the plain bf16 backward to 0.15, and no further from the float64
# backward than 1.5 times the plain bf16 backward is (the sharp test: the
# kernel was the closer one for every tensor but a few, by at most 1.25x).
# f32: even f32 rounding flips masks against float64 at 2^20 rows (measured
# 1.6e-2 of the peak elementwise on dx, 1.3e-3 in L2 at the bake), so the
# cotangent is zeroed on rows with a float64 pre-activation within 1e-4 of
# its layer's peak (as tests/test_fused_pe_mlp.py filters rows), and on the
# rest every output is held to float64 at 1e-4 of its peak (f32 sums over
# up to 2^20 rows).
PE_BWD_BF16_REL_L2, PE_BWD_F32_REL, PE_BWD_CLEAR = 0.15, 1e-4, 1e-4
RGB_ABS_TOL = 1e-4  # tiny vision slice, f32, card vs CPU
# Tiny joint step, f32, card (f32 kernels) against the CPU (plain chains,
# the fields in float64), each step from the same state. Losses 1e-4
# relative, the interlevel and distortion terms also 1e-4 of the total
# (differences of f32 cumulative sums). Every gradient to TRAIN_GRAD_TOL of
# its tensor's peak (measured on an H100: 1.6e-4 at most). The CPU's fields
# run in float64 because positions enter the encoding at up to 2^8 turns,
# which the card's kernels reduce exactly and a float32 chain rounds by
# ~1e-4 rad. The grid and the BatchNorm statistics to 1e-4 of their peak.
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL = 1e-4, 1e-3
# Hash encoding, kernel against the plain version on the same inputs,
# relative to each output's peak. Forward 1e-6: both sum the weighted
# corners as the same float32 FMAs in the same order. Table gradient 1e-5,
# against the plain version's summed in float64: the kernel adds with
# atomics, in an order that changes from run to run. A float32 reference
# adds its own error, of the gate's order at a render chunk's own points
# (a coarse row there sums many terms of random sign); it is printed
# beside.
# dx 1e-5, on rows clear of the clip bounds (sums over corners and levels
# in another order).
HASH_FWD_TOL, HASH_BWD_TOL = 1e-6, 1e-5
# Stem weight gradient, kernel against the plain version in float64 on the
# same inputs, relative to the peak: the bf16 products are exact in f32, so
# both types differ from float64 only by the kernel's f32 sums over up to
# 262,144 products a slice and 66 slices (a wrong tap or axis is O(1)).
STEM_REL_TOL = 1e-4
# cuDNN's bf16 stem conv at 8 input channels (a zero channel, zero weights)
# against the same conv at 7, relative to the peak: both round f32 sums of
# the same bf16 products to bf16 outputs (2^-8 of a value at most), summed
# in another order; a wrong channel or tap is O(1).
STEM_CONV_BF16_TOL = 2 ** -7
H100_BF16, H100_F32, H100_BYTES = 989e12, 67e12, 3.35e12  # per second
EVAL_NOISE, EVAL_MIN_PSNR = 0.02, 30.0  # evaluate_vision against render + noise
GATE = "NERAF_STEM_WGRAD_PALLAS"


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


GL_SHAPES = (("soundspaces", 512, 128, 512, 78, 128),
             ("soundspaces", 512, 128, 512, 78, 1024),
             ("raf", 1024, 256, 512, 60, 64))


def gl_state_bytes(M, n_fft, T, n_iter=32) -> int:
    """The per-bin state's traffic of one kernel call: each iteration reads
    and writes tprev (8 B a bin) and reads mag_t (4 B); the first pass reads
    mag and the phasors and writes both (24 B a bin)."""
    return M * T * (n_fft // 2 + 1) * (20 * n_iter + 24)


def gl_blocks_per_sm(n_fft, plan) -> int:
    """Blocks of the GL kernel's launch plan that the card keeps resident
    on one SM (its occupancy query)."""
    import ctypes

    from neraf_tpu_torch.ops.cuda import build

    lib, blocks = build.load(), ctypes.c_int(0)
    err = lib.neraf_gl_blocks_per_sm(n_fft, plan.warps, plan.smem_bytes,
                                     ctypes.byref(blocks))
    build.check(lib, err, "griffin_lim occupancy query")
    return blocks.value


def gl_check(torch, dev, n_fft, hop, win, T, M) -> dict:
    """The GL kernel against griffin_lim_plain on M seeded channels: 1e-3 of
    the peak after 4 iterations, the spectral convergence after 32 within
    SC_ABS_TOL, two launches bitwise equal; both timed in turns."""
    from neraf_tpu_torch.dsp.griffin_lim import griffin_lim_plain, random_angles
    from neraf_tpu_torch.ops.cuda import griffin_lim as gl_cuda

    gen = torch.Generator().manual_seed(M)
    F = n_fft // 2 + 1
    mag = rir_like_magnitudes(M, n_fft, hop, win, T, gen).to(dev)
    ang = random_angles(mag.shape, gen, dev)
    kw = dict(n_fft=n_fft, hop_length=hop, win_length=win)
    run_k = lambda n: gl_cuda.griffin_lim_cuda(mag, ang, n_iter=n, **kw)
    run_p = lambda n: griffin_lim_plain(mag, init_angles=ang, n_iter=n, **kw)
    k4, p4 = run_k(4), run_p(4)
    out_k, out_p, again = run_k(32), run_p(32), run_k(32)
    torch.cuda.synchronize()
    if out_k.shape != (M, hop * (T - 1)):
        fail(f"GL kernel shape {tuple(out_k.shape)}")
    if not torch.equal(out_k, again):
        fail(f"GL kernel: two launches differ at n_fft {n_fft} M={M} "
             f"(max {float((out_k - again).abs().max()):.3e})")
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
    plan = gl_cuda.gl_launch_plan(n_fft, hop, T, hop * (T - 1))
    blocks = gl_blocks_per_sm(n_fft, plan)
    bound, by = gl_bound_ms(M, n_fft, T)
    state = gl_state_bytes(M, n_fft, T)
    print(f"gl n_fft {n_fft} hop {hop} M={M} F={F} T={T}: plan {plan.warps} "
          f"warps, {plan.smem_bytes} B shared, {blocks} blocks resident an "
          f"SM; 4 iter max_abs_err={err:.3e} rel={rel:.3e} (tol "
          f"{GL_REL_TOL}); 32 iter max_abs_err={err32:.3e}, per-channel rel "
          f"median {float(chan.median()):.3e} max {float(chan.max()):.3e}, "
          f"spectral convergence {sc_k:.7f} vs {sc_p:.7f} (tol {SC_ABS_TOL}); "
          f"two launches bitwise equal; 32 iter kernel {ms_k:.3f} ms "
          f"[{k1:.3f}, {k2:.3f}] plain {ms_p:.3f} ms [{p1:.3f}, {p2:.3f}], "
          f"bound {bound:.3f} ms ({by}); per-bin state {state / 1e9:.3f} GB "
          f"a call, {state / H100_BYTES * 1e3:.3f} ms at device-memory rate",
          flush=True)
    if not (rel <= GL_REL_TOL and abs(sc_k - sc_p) <= SC_ABS_TOL):
        fail(f"GL kernel disagrees with plain at n_fft {n_fft} M={M}: rel "
             f"{rel}, spectral convergence {sc_k} vs {sc_p}")
    return {"err": err, "err32": err32, "ms": ms_k, "plain_ms": ms_p,
            "plan": {**plan._asdict(), "blocks_per_sm": blocks}}


def pe_fwd_errors(torch, out, x, layers, F, dtype, ref, what):
    """A PE+MLP forward kernel's output against the plain chain: bf16 to
    PE_BF16_REL_TOL of the peak and no further from float64 (`ref`) than
    PE_BF16_VS_PLAIN times the plain bf16 chain; f32 to float64 at rtol
    PE_F32_RTOL + atol PE_F32_ATOL of the peak -> (max_abs_err, peak, ok,
    the bound as text)."""
    from neraf_tpu_torch.ops.pe_mlp import pe_mlp_plain

    torch.cuda.synchronize()
    if out.shape != ref.shape or not bool(torch.isfinite(out).all()):
        fail(f"{what}: shape {tuple(out.shape)} or not finite")
    peak = float(ref.abs().max())
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
    else:
        err = float(diff64.max())
        excess = float((diff64 - PE_F32_RTOL * ref.abs()).max())
        ok = excess <= PE_F32_ATOL * peak
        bound = (f"against float64, rtol {PE_F32_RTOL} + atol "
                 f"{PE_F32_ATOL} of the peak")
    return err, peak, ok, bound


def pe_mlp_check(torch, dev, name, layers, F, n, seed):
    """Phase 6 at one shape: the kernel against the plain version, bf16
    and f32, and both timed (plain, kernel, kernel, plain), beside the
    kernel's bound and its share of it."""
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
    row = {"rows": n}
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        out = pe_mlp_cuda(x, layers, F, 0.0, 8.0, dtype)
        err, peak, ok, bound = pe_fwd_errors(torch, out, x, layers, F, dtype,
                                             ref, f"pe_mlp {name} {tag}")
        del out
        reps = 5
        p1, k1, k2, p2 = (cuda_ms(torch, f, reps) for f in (
            lambda: pe_mlp_plain(x, layers, F, 0.0, 8.0, dtype),
            lambda: pe_mlp_cuda(x, layers, F, 0.0, 8.0, dtype),
            lambda: pe_mlp_cuda(x, layers, F, 0.0, 8.0, dtype),
            lambda: pe_mlp_plain(x, layers, F, 0.0, 8.0, dtype)))
        ms_k, ms_p = (k1 + k2) / 2, (p1 + p2) / 2
        b_ms, b_by = pe_fwd_bound_ms(mlp_shape(layers), F, n, dtype)
        print(f"pe_mlp {name} {n} rows {tag}: max_abs_err {err:.3e}, "
              f"rel {err / peak:.3e} (bound {bound}); kernel {ms_k:.3f} ms "
              f"[{k1:.3f}, {k2:.3f}] plain {ms_p:.3f} ms [{p1:.3f}, "
              f"{p2:.3f}]; bound {b_ms:.3f} ms ({b_by}), kernel at "
              f"{b_ms / ms_k:.1%} of it", flush=True)
        if not ok:
            fail(f"pe_mlp kernel disagrees with plain at {name} {tag}: "
                 f"max_abs_err {err}, peak {peak}")
        row[tag] = {"max_abs_err": err, "rel_err": err / peak, "ms": ms_k,
                    "plain_ms": ms_p, "bound_ms": b_ms, "bound_by": b_by}
        torch.cuda.empty_cache()
    return row


def pe_mlp_flops(dims_in, F, n):
    """Multiply-adds x 2 of one pe_mlp forward: (K0, H, L, O) layer chain."""
    k0, h, n_hidden, o = dims_in
    return 2.0 * n * (k0 * h + (n_hidden - 1) * h * h + h * o)


def mlp_shape(layers) -> tuple:
    """(K0, H, hidden layers, O) of a pe_mlp layer list."""
    return (layers[0][0].shape[1], layers[0][0].shape[0], len(layers) - 1,
            layers[-1][0].shape[0])


def pe_bwd_check(torch, dev, name, layers, F, n, seed, need_dx):
    """Phase 9 at one training shape: the forward kernel against
    pe_mlp_plain (phase 6's bounds) and the backward kernel against
    autograd of pe_mlp_plain, on the same inputs, bf16 and f32, and the
    backward alone timed beside the plain chain's backward (plain, kernel,
    kernel, plain); then forward + backward of both."""
    from neraf_tpu_torch.ops.cuda import pe_mlp as pe_cuda
    from neraf_tpu_torch.ops.encodings import nerf_encoding
    from neraf_tpu_torch.ops.pe_mlp import (
        pe_mlp_plain,
        pe_mlp_vjp_plain,
        unpack_layers,
    )

    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand((n, 3), generator=gen, device=dev)
    layers = [(w.detach(), 0.1 * torch.randn(b.shape, generator=gen, device=dev))
              for w, b in layers]
    out_dim = layers[-1][0].shape[0]
    g = torch.randn((n, out_dim), generator=gen, device=dev)

    def flat(dx, grads):
        return ([dx] if need_dx else []) + [t for wb in grads for t in wb]

    layers64 = [(w.double(), b.double()) for w, b in layers]
    ref_fwd = pe_mlp_plain(x.double(), layers64, F, 0.0, 8.0, torch.float64)
    ref = flat(*pe_mlp_vjp_plain(x.double(), layers64, g.double(), F, 0.0,
                                 8.0, torch.float64))
    # rows clear of every ReLU's kink, for the f32 check
    h, clear = nerf_encoding(x.double(), F), torch.ones(n, dtype=torch.bool,
                                                        device=dev)
    for w, b in layers64[:-1]:
        pre = h @ w.T + b
        clear &= (pre.abs() > PE_BWD_CLEAR * pre.abs().max()).all(dim=-1)
        h = torch.relu(pre)
    del h, pre
    g_clear = g * clear[:, None]
    ref_clear = flat(*pe_mlp_vjp_plain(x.double(), layers64, g_clear.double(),
                                       F, 0.0, 8.0, torch.float64))
    rel = lambda a, b: float((a.double() - b.double()).norm() / b.double().norm())
    row = {"rows": n}
    k0, h = layers[0][0].shape[1], layers[0][0].shape[0]
    shape = (k0, h, len(layers) - 1, out_dim)
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        w, b, dims = pe_cuda._pack(layers, F, dtype)
        # the forward kernel at this shape, as the train step launches it
        out = pe_cuda._forward(x, w, b, dims, F, 0.0, 8.0, dtype)
        f_err, f_peak, f_ok, f_bound = pe_fwd_errors(
            torch, out, x, layers, F, dtype, ref_fwd,
            f"pe_mlp forward {name} {tag}")
        del out
        # the forward alone at this shape: plain, kernel, kernel, plain
        fwd_p = lambda: pe_mlp_plain(x, layers, F, 0.0, 8.0, dtype)
        fwd_k = lambda: pe_cuda._forward(x, w, b, dims, F, 0.0, 8.0, dtype)
        f1, e1, e2, f2 = (cuda_ms(torch, f, 3) for f in (fwd_p, fwd_k, fwd_k,
                                                          fwd_p))
        fwd_ms, fwd_plain = (e1 + e2) / 2, (f1 + f2) / 2
        fwd_bound, fwd_by = pe_fwd_bound_ms(shape, F, n, dtype)
        run_k = lambda: pe_cuda.pe_mlp_bwd_cuda(x, g, w, b, dims, F, 0.0, 8.0,
                                                dtype, need_dx=need_dx)
        dx, packed = (run_k() if dtype == torch.bfloat16 else
                      pe_cuda.pe_mlp_bwd_cuda(x, g_clear, w, b, dims, F, 0.0,
                                              8.0, dtype, need_dx=need_dx))
        got = flat(dx, unpack_layers(*packed, dims, F, h))
        torch.cuda.synchronize()
        if not all(bool(torch.isfinite(t).all()) for t in got):
            fail(f"pe_mlp backward {name} {tag}: not finite")
        if dtype == torch.bfloat16:
            plain = flat(*pe_mlp_vjp_plain(x, layers, g, F, 0.0, 8.0, dtype))
            errs = [rel(a, p) for a, p in zip(got, plain)]
            errs64 = [rel(a, r) for a, r in zip(got, ref)]
            plain64 = [rel(p, r) for p, r in zip(plain, ref)]
            max_abs = max(float((a - p.float()).abs().max())
                          for a, p in zip(got, plain))
            ok = (max(errs) <= PE_BWD_BF16_REL_L2 and all(
                e <= PE_BF16_VS_PLAIN * p for e, p in zip(errs64, plain64)))
            detail = (f"rel L2 vs plain bf16 max {max(errs):.3e} (tol "
                      f"{PE_BWD_BF16_REL_L2}); vs float64 kernel/plain "
                      + ", ".join(f"{e:.2e}/{p:.2e}" for e, p in
                                  zip(errs64, plain64)))
            del plain
        else:
            peak_frac = max(float((a.double() - r).abs().max())
                            / float(r.abs().max())
                            for a, r in zip(got, ref_clear))
            max_abs = max(float((a.double() - r).abs().max())
                          for a, r in zip(got, ref_clear))
            ok = peak_frac <= PE_BWD_F32_REL
            detail = (f"on the {int(clear.sum())} rows clear of the kinks, vs "
                      f"float64 max {peak_frac:.3e} of each tensor's peak (tol "
                      f"{PE_BWD_F32_REL})")
        del got, dx, packed
        # the backward alone: the kernel vs autograd through the plain chain
        xs = x.clone().requires_grad_(need_dx)
        ps = [t.clone().requires_grad_() for wb in layers for t in wb]
        out = pe_mlp_plain(xs, list(zip(ps[::2], ps[1::2])), F, 0.0, 8.0, dtype)
        ins = ([xs] if need_dx else []) + ps
        run_p = lambda: torch.autograd.grad(out, ins, g, retain_graph=True)
        reps = 3
        p1, k1, k2, p2 = (cuda_ms(torch, f, reps) for f in (run_p, run_k, run_k,
                                                             run_p))
        del out, run_p
        # the backward's device kernels, one call under the profiler
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            run_k()
            torch.cuda.synchronize()
        parts = [(e.name.split("::")[-1].split("(")[0],
                  (e.time_range.end - e.time_range.start) / 1e3)
                 for e in prof.events() if e.device_type.name == "CUDA"
                 and "pe_mlp" in e.name]
        print(f"pe_mlp backward {name} {tag} device kernels (ms): " + ", ".join(
            f"{k} {v:.3f}" for k, v in parts), flush=True)
        # forward + backward through autograd, as the train step runs them
        def fb(fn):
            def step():
                o = fn(xs, list(zip(ps[::2], ps[1::2])), F, 0.0, 8.0, dtype)
                torch.autograd.grad(o, ins, g)
            return step
        q1, c1, c2, q2 = (cuda_ms(torch, f, reps) for f in (
            fb(pe_mlp_plain), fb(pe_cuda.pe_mlp_cuda), fb(pe_cuda.pe_mlp_cuda),
            fb(pe_mlp_plain)))
        ms_k, ms_p = (k1 + k2) / 2, (p1 + p2) / 2
        # the backward's products (the forward recomputed, dh and dW; no
        # dh at layer 0 without dx) against x, g, dx, dW and db once
        flops = 2 * pe_mlp_flops(shape, F, n) - (
            0 if need_dx else 2.0 * n * k0 * h)
        n_w, n_b = pe_cuda.packed_sizes(dims)
        nbytes = 4.0 * n * (3 + out_dim + (3 if need_dx else 0)) + 4.0 * (
            n_w + n_b) * 2
        peak_rate = H100_BF16 if dtype == torch.bfloat16 else H100_F32
        t_ops, t_bytes = flops / peak_rate, nbytes / H100_BYTES
        bound = max(t_ops, t_bytes) * 1e3
        bound_by = "operations" if t_ops > t_bytes else "bytes"
        print(f"pe_mlp forward {name} {n} rows {tag}: max_abs_err "
              f"{f_err:.3e}, rel {f_err / f_peak:.3e} (bound {f_bound}); "
              f"forward kernel {fwd_ms:.3f} ms [{e1:.3f}, {e2:.3f}] plain "
              f"{fwd_plain:.3f} ms [{f1:.3f}, {f2:.3f}] bound {fwd_bound:.3f} "
              f"ms ({fwd_by}), kernel at {fwd_bound / fwd_ms:.1%} of it; "
              f"backward: {detail}; max_abs_err "
              f"{max_abs:.3e}; backward kernel {ms_k:.3f} ms [{k1:.3f}, "
              f"{k2:.3f}] plain {ms_p:.3f} ms [{p1:.3f}, {p2:.3f}] bound "
              f"{bound:.3f} ms ({bound_by}, {flops / 1e9:.1f} GFLOP), kernel "
              f"at {bound / ms_k:.1%} of it; forward+backward "
              f"kernel {(c1 + c2) / 2:.3f} ms plain {(q1 + q2) / 2:.3f} ms",
              flush=True)
        if not f_ok:
            fail(f"pe_mlp forward kernel disagrees with plain at {name} {tag}: "
                 f"max_abs_err {f_err}, peak {f_peak}")
        if not ok:
            fail(f"pe_mlp backward kernel disagrees with plain at {name} {tag}")
        if dtype == torch.bfloat16:
            row["rel_l2_vs_plain"] = max(errs)
        row[tag] = {"max_abs_err": max_abs, "ms": ms_k, "plain_ms": ms_p,
                    "bound_ms": bound, "bound_by": bound_by,
                    "fwd_ms": fwd_ms, "fwd_plain_ms": fwd_plain,
                    "fwd_bound_ms": fwd_bound, "fwd_bound_by": fwd_by,
                    "fwd_bwd_ms": (c1 + c2) / 2,
                    "plain_fwd_bwd_ms": (q1 + q2) / 2,
                    "fwd_max_abs_err": f_err, "fwd_rel_err": f_err / f_peak}
        del xs, ps, ins
        torch.cuda.empty_cache()
    return row


def gl_bound_ms(M, n_fft, T, n_iter=32) -> float:
    """The least time of n_iter GL iterations on M channels: each iteration
    a real FFT and an inverse real FFT of n_fft per frame (2.5 N log2 N
    flops each) and ~20 flops per bin of projection and momentum, in f32
    on the CUDA cores; against the bytes of mag, the initial phasors and
    the waveform."""
    F = n_fft // 2 + 1
    flops = n_iter * M * T * (2 * 2.5 * n_fft * np.log2(n_fft) + 20 * F)
    nbytes = M * F * T * (4 + 8) + M * (T - 1) * (n_fft // 4) * 4
    return max(flops / H100_F32, nbytes / H100_BYTES) * 1e3, (
        "operations" if flops / H100_F32 > nbytes / H100_BYTES else "bytes")


def pe_fwd_bound_ms(shape, F, n, dtype=None) -> tuple:
    """The forward's products at the peak of their type (bf16 unless dtype
    is float32) against x and the output's bytes."""
    flops = pe_mlp_flops(shape, F, n)
    nbytes = n * (12 + 4 * shape[3])
    f32 = dtype is not None and "float32" in str(dtype)
    t_ops, t_bytes = flops / (H100_F32 if f32 else H100_BF16), nbytes / H100_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def stage_ms(torch, marks):
    """Consecutive (stage, CUDA event) marks -> ms per stage."""
    torch.cuda.synchronize()
    return {name: a.elapsed_time(b) for (_, a), (name, b)
            in zip(marks[:-1], marks[1:])}


def bench_inputs(torch, dev):
    """bench.py:186-201: 8 cameras at 512 x 512, fx = fy = 400, identity
    c2w; seeded images; 100 recordings of (2, 257, 78) log-STFTs."""
    n_cams, H, W, n_rec = 8, 512, 512, 100
    gen = torch.Generator(device=dev).manual_seed(0)
    c2w = torch.zeros((n_cams, 3, 4), device=dev)
    c2w[:, :, :3] = torch.eye(3, device=dev)
    full = lambda v: torch.full((n_cams,), float(v), device=dev)
    cams = {"c2w": c2w, "fx": full(400.0), "fy": full(400.0),
            "cx": full(W / 2), "cy": full(H / 2)}
    images = {"images": torch.rand((n_cams, H, W, 3), generator=gen, device=dev)}
    audio = {"mic_pose": torch.rand((n_rec, 3), generator=gen, device=dev) * 4 - 2,
             "source_pose": torch.zeros((n_rec, 3), device=dev),
             "rot": torch.full((n_rec, 3), 0.5, device=dev),
             "log_stft": torch.randn((n_rec, 2, 257, 78), generator=gen,
                                     device=dev) * 0.5 - 3}
    return cams, audio, images


def check_metrics(metrics, what):
    keys = {"rgb_loss", "interlevel_loss", "distortion_loss", "audio_sc_loss",
            "audio_mag_loss", "total_loss", "lr_fields", "lr_audio_fields"}
    if set(metrics) != keys or not all(np.isfinite(v) for v in metrics.values()):
        fail(f"{what}: metrics {metrics}")


def reset_counts() -> None:
    """Every kernel wrapper's launch count to 0."""
    from neraf_tpu_torch.ops.cuda import griffin_lim as gl_cuda
    from neraf_tpu_torch.ops.cuda import hash_encoding as hash_cuda
    from neraf_tpu_torch.ops.cuda import pe_mlp as pe_cuda
    from neraf_tpu_torch.ops.cuda import shifted_concat as sc_cuda
    from neraf_tpu_torch.ops.cuda import stem_wgrad as stem_cuda

    gl_cuda.LAUNCHES = pe_cuda.LAUNCHES = pe_cuda.BWD_LAUNCHES = 0
    hash_cuda.FWD_LAUNCHES = hash_cuda.BWD_LAUNCHES = 0
    stem_cuda.LAUNCHES = sc_cuda.LAUNCHES = 0


def read_counts() -> dict:
    """Every kernel wrapper's launch count."""
    from neraf_tpu_torch.ops.cuda import griffin_lim as gl_cuda
    from neraf_tpu_torch.ops.cuda import hash_encoding as hash_cuda
    from neraf_tpu_torch.ops.cuda import pe_mlp as pe_cuda
    from neraf_tpu_torch.ops.cuda import shifted_concat as sc_cuda
    from neraf_tpu_torch.ops.cuda import stem_wgrad as stem_cuda

    return {"pe_fwd": pe_cuda.LAUNCHES, "pe_bwd": pe_cuda.BWD_LAUNCHES,
            "hash_fwd": hash_cuda.FWD_LAUNCHES,
            "hash_bwd": hash_cuda.BWD_LAUNCHES, "stem": stem_cuda.LAUNCHES,
            "concat": sc_cuda.LAUNCHES, "gl": gl_cuda.LAUNCHES}


class stem_gate:
    """NERAF_STEM_WGRAD_PALLAS=1 while pipelines are built (they read it
    once), then the environment as it was."""

    def __enter__(self):
        self.old = os.environ.get(GATE)
        os.environ[GATE] = "1"

    def __exit__(self, *exc):
        if self.old is None:
            os.environ.pop(GATE)
        else:
            os.environ[GATE] = self.old


def joint_step_phase(torch, pipe, per_step: dict, what: str = "joint step",
                     stem: bool = True):
    """Phases 10, 14 and 17: the full-width joint step on the bench.py
    inputs, with every kernel's launch count set to 0 just before the run
    and read just after; `per_step` is the launches a step expected of each
    counter (pe_fwd, pe_bwd, hash_fwd, hash_bwd, stem; the others none)."""

    cams, audio, images = bench_inputs(torch, pipe.device)
    pipe.step = 3000  # past start_step_audio: the audio branch is live
    bake = pipe.config.trainer.grid_bake_cells_per_step
    rays = pipe.config.vision_data.train_rays_per_batch
    n_settle, n_warm = 2, 10  # the caching allocator grows over the first steps
    torch.cuda.synchronize()
    reset_counts()
    times, metrics = [], []
    for i in range(1 + n_settle + n_warm):
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        grid0, cursor0, step0 = pipe.grid.clone(), pipe.cursor, pipe.step
        t0 = time.perf_counter()
        m = pipe.train_step(cams, audio, images)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check_metrics(m, f"{what} {i}")
        metrics.append(m)
        if pipe.cursor != (cursor0 + bake) % pipe.grid.shape[0] or (
                pipe.step != step0 + 1):
            fail(f"{what} {i}: cursor {cursor0} -> {pipe.cursor}, step "
                 f"{step0} -> {pipe.step}")
        changed = (pipe.grid != grid0).any(dim=1).nonzero()[:, 0]
        if not (changed.numel() == bake and int(changed[0]) == cursor0
                and int(changed[-1]) == cursor0 + bake - 1):
            fail(f"{what} {i}: the grid changed at {changed.numel()} "
                 f"cells, not the {bake} at cursor {cursor0}")
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = 1 + n_settle + n_warm
    want = {k: per_step.get(k, 0) * steps for k in counts}
    if counts != want:
        fail(f"{what}: launches {counts} in {steps} steps, expected {want}")
    if not metrics[-1]["audio_mag_loss"] > 0:
        fail(f"{what}: the audio branch is not live")
    warm = times[1 + n_settle:]
    ms = 1e3 * float(np.median(warm))
    print(f"{what}: cold {times[0] * 1e3:.2f} ms, then "
          f"{[round(1e3 * t, 2) for t in times[1:1 + n_settle]]} ms; warm "
          f"median {ms:.2f} ms/step (mean {1e3 * float(np.mean(warm)):.2f}, "
          f"each {[round(1e3 * t, 2) for t in warm]}), "
          f"{1e3 / ms:.3f} steps/s, {rays * 1e3 / ms:.1f} rays/s; peak memory "
          f"{peak / 2**30:.3f} GiB; launches {counts} in {steps} steps; last "
          f"metrics {json.dumps(metrics[-1])}", flush=True)
    pipe.profile = []
    for _ in range(3):
        pipe.train_step(cams, audio, images)
    marks, pipe.profile = pipe.profile, None
    per = [stage_ms(torch, marks[i:i + 7]) for i in range(0, len(marks), 7)]
    parts = {k: float(np.mean([d[k] for d in per])) for k in per[0]}
    print(f"{what} breakdown, mean of 3 steps (ms, CUDA events): " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts.items()) + f"; sum {sum(parts.values()):.3f}",
        flush=True)
    kernels, busy = profile_steps(torch, pipe, cams, audio, images, what)
    return {"ms_per_step": ms, "cold_ms": times[0] * 1e3, **counts,
            "peak_gib": peak / 2**30, "parts": parts, "kernels": kernels,
            "busy_ms_per_step": busy,
            "stem_ms": stem_timings(torch, pipe) if stem else None}


# the device kernels of the wrappers, by the name after "::": one PE+MLP
# forward call launches pe_mlp_bf16_kernel; one backward call the row-tile
# kernel, one dW kernel per layer and the reduction; the hash encoding one
# kernel each way
DEVICE_KERNELS = {"pe_mlp_bf16_kernel": "PE+MLP forward",
                  "pe_mlp_bwd_bf16_kernel": "PE+MLP backward row tiles",
                  "pe_mlp_dw_kernel": "PE+MLP backward dW",
                  "pe_mlp_reduce_kernel": "PE+MLP backward reduction",
                  "hash_encoding_fwd_kernel": "hash forward",
                  "hash_encoding_bwd_kernel": "hash backward",
                  "stem_split_kernel": "stem wgrad split copy",
                  "stem_wgrad_wgmma_kernel": "stem wgrad",
                  "stem_reduce_kernel": "stem wgrad reduction"}
# PyTorch's and cuDNN's own kernels a step, by a part of their names (not
# counted again for a wrapper's kernel)
LIBRARY_KERNELS = {"FillFunctor": "zero fills",
                   "FusedAdamMathFunctor": "fused Adam",
                   "wgrad": "cuDNN weight gradients",
                   "f32f32": "cuDNN kernels on f32 operands"}


def busy_ms(events) -> float:
    """Union of the device kernels' time intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type.name == "CUDA" and e.time_range.end > 0)
    total, end = 0.0, -1.0
    for a, b in spans:
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total / 1e3


def profile_steps(torch, pipe, cams, audio, images, what: str,
                  n: int = 3) -> dict:
    """torch.profiler over n joint steps: the device's busy time (union of
    its kernels' intervals) against the host clock, the kernels with the
    most device time, and the launches and device ms a step of each of the
    wrappers' device kernels and of the zero fills and fused Adam ->
    {kernel: {"launches": per step, "ms": per step}}."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            pipe.train_step(cams, audio, images)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    busy = busy_ms(events)
    found = {k: {"launches": 0, "ms": 0.0}
             for k in (*DEVICE_KERNELS, *LIBRARY_KERNELS)}
    for e in events:
        if e.device_type.name != "CUDA":
            continue
        keys = [k for k in DEVICE_KERNELS
                if f"::{k}<" in e.name or f"::{k}(" in e.name]
        keys = keys or [k for k in LIBRARY_KERNELS if k in e.name]
        for k in keys:
            found[k]["launches"] += 1
            found[k]["ms"] += (e.time_range.end - e.time_range.start) / 1e3
    found = {k: {"launches": v["launches"] / n, "ms": v["ms"] / n}
             for k, v in found.items()}
    f32_names = sorted({e.name for e in events if e.device_type.name == "CUDA"
                        and "f32f32" in e.name})
    print(f"{what} profile: cuDNN kernels on f32 operands (f32f32) a step: "
          f"{found['f32f32']['launches']:g} launches "
          f"{found['f32f32']['ms']:.3f} ms: {f32_names}", flush=True)
    labels = {**DEVICE_KERNELS, **LIBRARY_KERNELS}
    print(f"{what} profile, {n} steps under torch.profiler: host "
          f"{wall:.2f} ms, device busy {busy:.2f} ms ({busy / n:.2f} a step), "
          f"idle share {1 - busy / wall:.3f} (the profiler slows the host); "
          "device kernels a step: " + ", ".join(
              f"{labels[k]} ({k}) {v['launches']:g} launches {v['ms']:.3f} ms"
              for k, v in found.items() if v["launches"]), flush=True)
    print(prof.key_averages().table(sort_by="self_cuda_time_total",
                                    row_limit=15, max_name_column_width=70))
    return found, busy / n


def stem_timings(torch, pipe) -> dict:
    """The ResNet3D forward and forward + backward in train mode over the
    grid alone (through the stem kernel when the pipeline's gate is on;
    the stem on the packed 8-channel volume), CUDA events."""
    from neraf_tpu_torch.models.grid import grid_to_volume

    vol = grid_to_volume(pipe.grid, pipe.grid_res)
    pipe.resnet.set_update_stats(False)

    def resnet_step():
        with torch.autocast("cuda", dtype=torch.bfloat16):
            feat = pipe.resnet(vol)
        feat.sum().backward()

    def resnet_fwd():
        with torch.autocast("cuda", dtype=torch.bfloat16):
            pipe.resnet(vol)

    res = {}
    for k, f in (("forward", resnet_fwd), ("forward + backward", resnet_step)):
        cuda_ms(torch, f, 2)
        res[k] = cuda_ms(torch, f, 5)
    pipe.resnet.zero_grad(set_to_none=True)
    print(f"{pipe.resnet.backbone} train mode over {vol.shape[-1]} x "
          f"{pipe.grid_res}^3, bf16, stem kernel "
          f"{pipe.resnet.stem_wgrad_kernel} (ms, CUDA events): " + ", ".join(
              f"{k} {v:.3f}" for k, v in res.items()), flush=True)
    return {f"resnet {k}": v for k, v in res.items()}


def tiny_joint_card_vs_cpu(torch, what: str = "tiny joint", config=None):
    """Phases 11 and 15: three tiny f32 steps on the card and on the CPU
    from the same weights and draws, each step from the CPU pipeline's
    state, at the tiny configuration or `config`. The CPU reference
    computes the fields' MLPs (proposals and main field) in float64, so
    that the fourier encoding's angles, up to 2^8 turns, are exact as the
    card's kernels reduce them; a plain float32 CPU pipeline is run beside
    them and its distance to the card printed, ungated."""
    from neraf_tpu_torch.data.loader import audio_arrays
    from neraf_tpu_torch.data.vision_data import camera_arrays, synthetic_cameras
    from neraf_tpu_torch.engine.factory import build_joint_pipeline

    dev = {"cpu": "cpu", "cuda": "cuda", "cpu_f32": "cpu"}
    on = {d: build_joint_pipeline(grid_res=32, tiny=True, device=v, seed=0,
                                  mixed_precision=False, config=config)
          for d, v in dev.items()}
    vm = on["cpu"].vision_model
    for field in (vm.field, *vm.proposal_networks):
        field.dtype = torch.float64
    rng = np.random.default_rng(5)
    H, W, n_rec = 12, 10, 5
    cams = synthetic_cameras(8, H, W, seed=3)
    images = rng.uniform(0.0, 1.0, (8, H, W, 3)).astype(np.float32)
    split = {"mic_pose": rng.uniform(-2, 2, (n_rec, 3)),
             "source_pose": rng.uniform(-2, 2, (n_rec, 3)),
             "rot": rng.uniform(0, 1, (n_rec, 3)),
             "log_stft": rng.normal(-3, 0.5, (n_rec, 2, 257, 12))}
    data = {d: (camera_arrays(cams, d), audio_arrays(split, d),
                {"images": torch.as_tensor(images, device=d)})
            for d in ("cpu", "cuda")}
    cfg = on["cpu"].config
    R, B = cfg.vision_data.train_rays_per_batch, cfg.audio_data.batch_size
    worst = {"cpu": {}, "cpu_f32": {}}

    def grads(p):
        named = {**{f"field.{k}": t for k, t in
                    p.vision_model.field.named_parameters()},
                 **{f"proposal_networks.{k}": t for k, t in
                    p.vision_model.proposal_networks.named_parameters()},
                 "camera_opt": p.vision_model.camera_opt,
                 **{f"audio.{k}": t for k, t in p.audio_model.named_parameters()},
                 **{f"resnet.{k}": t for k, t in p.resnet.named_parameters()}}
        return {k: t.grad.cpu() for k, t in named.items()}

    for step in range(3):
        ref = on["cpu"]
        for d in ("cuda", "cpu_f32"):
            on[d].vision_model.load_state_dict(ref.vision_model.state_dict())
            on[d].resnet.load_state_dict(ref.resnet.state_dict())
            on[d].audio_model.load_state_dict(ref.audio_model.state_dict())
            on[d].grid = ref.grid.to(dev[d])
        draws = {"cam": rng.integers(0, 8, R), "py": rng.integers(0, H, R),
                 "px": rng.integers(0, W, R), "rec": rng.integers(0, n_rec, B),
                 "t": rng.integers(0, 12, B)}
        draws.update({k: rng.uniform(0, 1, (R, 1)).astype(np.float32)
                      for k in ("u_init", "u_pdf0", "u_pdf1")})
        m = {d: p.train_step(*data[dev[d]], draws=draws) for d, p in on.items()}
        for k, v in m["cpu"].items():
            atol = (TRAIN_LOSS_RTOL * m["cpu"]["total_loss"]
                    if k in ("interlevel_loss", "distortion_loss") else 0.0)
            if not abs(m["cuda"][k] - v) <= TRAIN_LOSS_RTOL * abs(v) + atol:
                fail(f"{what} step {step}: {k} card {m['cuda'][k]} vs "
                     f"cpu {v}")
        g = {d: grads(p) for d, p in on.items()}
        for d in worst:
            for k, r in g[d].items():
                err = float((g["cuda"][k] - r).abs().max()
                            / r.abs().max().clamp_min(1e-30))
                worst[d][k] = max(worst[d].get(k, 0.0), err)
        stats = {d: {k: v.cpu() for k, v in p.resnet.state_dict().items()
                     if "running" in k} for d, p in on.items()}
        state_err = max([float((on["cuda"].grid.cpu() - ref.grid).abs().max()
                               / ref.grid.abs().max())] + [
            float((stats["cuda"][k] - v).abs().max() / v.abs().max())
            for k, v in stats["cpu"].items()])
        if state_err > 1e-4:
            fail(f"{what} step {step}: grid or BN statistics {state_err}")
    top = {d: sorted(w.items(), key=lambda kv: -kv[1])[:3]
           for d, w in worst.items()}
    fmt = lambda kvs: ", ".join(f"{k} {v:.3e}" for k, v in kvs)
    print(f"{what} card vs cpu (fields in float64), 3 steps: losses "
          f"within {TRAIN_LOSS_RTOL}; gradients of each tensor's peak, "
          f"largest {fmt(top['cpu'])} (tol {TRAIN_GRAD_TOL}); grid and BN "
          f"statistics within 1e-4. Beside it, card vs a float32 CPU "
          f"pipeline: largest {fmt(top['cpu_f32'])}", flush=True)
    if top["cpu"][0][1] > TRAIN_GRAD_TOL:
        fail(f"{what} step gradients differ card vs CPU: " + fmt(top["cpu"]))
    return worst["cpu"]


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
    proposal 0, proposal 1, the main field (and its hash encoding, on the
    hash grid), and the rest of the chunk."""
    model = pipe.vision_model
    parts = {"proposal_0": model.proposal_networks[0],
             "proposal_1": model.proposal_networks[1],
             "main_field": model.field, "chunk": model}
    if hasattr(model.field, "hash"):
        parts["hash_encoding"] = model.field.hash
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


def hash_bound_ms(spec, n: int, distinct: int, backward: bool,
                  need_dx: bool = True) -> tuple:
    """The least time of the hash encoding on n rows: the bytes of x, of
    the output (forward) or of the cotangent, the whole dense table
    gradient and dx (backward), and of each distinct table row touched,
    once each, over 3.35 TB/s; against its float32 operations (per row and
    level: pos, floor and frac, then per corner the weight products and F
    FMAs; the backward's atomic adds, dot product and weight derivatives)
    over 67 TFLOP/s."""
    L, F = spec.num_levels, spec.features_per_level
    n_rows = distinct * 4 * F
    if backward:
        nbytes = (n * 12 + n * L * F * 4 + L * spec.table_size * F * 4
                  + (n_rows + n * 12 if need_dx else 0))
        flops = n * L * (9 + 8 * (2 + F + (2 * F + 8 if need_dx else 0)))
    else:
        nbytes = n * 12 + n * L * F * 4 + n_rows
        flops = n * L * (9 + 8 * (2 + 2 * F))
    t_ops, t_bytes = flops / H100_F32, nbytes / H100_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def hash_check(torch, dev, name, spec, n, seed, need_dx=True, x=None):
    """Phase 12 at one point set: the forward and backward kernels against
    the plain version and its autograd (index_add_ into the table) on the
    same inputs: a uniform(-1, 1) table, a normal cotangent, and the points
    x given (a point set of the main path) or, without them, n points in
    [-0.1, 1.1]^3 with 256 rows at exactly 0 and 256 at exactly 1. Forward
    to HASH_FWD_TOL of the peak; the table gradient (against the plain
    version's with the table in float64, so its sums in float64) and dx
    (on rows clear of the clip bounds) to HASH_BWD_TOL. Then each timed
    beside the plain version (plain, kernel, kernel, plain; the backward as
    the path runs it, without dx at the bake), with the atomics the
    backward makes and the L2 sector requests of the forward's gathers at
    these points (ops/hashgrid.py::bwd_atomics, fwd_sectors)."""
    from neraf_tpu_torch.ops.cuda import hash_encoding as hash_cuda
    from neraf_tpu_torch.ops.hashgrid import (
        bwd_atomics,
        clip_unit,
        fwd_sectors,
        hash_corners,
        hash_encoding_plain,
    )

    L, T, F = spec.num_levels, spec.table_size, spec.features_per_level
    gen = torch.Generator(device=dev).manual_seed(seed)
    table = torch.rand((L, T, F), generator=gen, device=dev) * 2.0 - 1.0
    if x is None:
        x = torch.rand((n, 3), generator=gen, device=dev) * 1.2 - 0.1
        x[:256], x[256:512] = 0.0, 1.0
    n = x.shape[0]
    g = torch.randn((n, spec.out_dim), generator=gen, device=dev)
    tp, xp = table.clone().requires_grad_(), x.clone().requires_grad_()
    ref = hash_encoding_plain(tp, xp, spec)
    ref_dt, ref_dx = torch.autograd.grad(ref, [tp, xp], g, retain_graph=True)
    t64 = table.double().requires_grad_()
    ref_dt64 = torch.autograd.grad(hash_encoding_plain(t64, x, spec), t64, g)[0]
    del t64
    out = hash_cuda._forward(table, x, spec)
    d_table, dx = hash_cuda.hash_encoding_bwd_cuda(table, x, g, spec)
    torch.cuda.synchronize()
    clear = ((x > 0.0) & (x < 1.0)).all(dim=1)
    err, rel = {}, {}

    def compare(key, got, want):
        err[key] = float((got - want).abs().max())
        rel[key] = err[key] / float(want.abs().max())

    compare("forward", out, ref.detach())
    compare("d_table", d_table.double(), ref_dt64)
    compare("dx", dx[clear], ref_dx[clear])
    # not gated: the kernel against the float32 plain gradient, that
    # gradient's own error, and dx on every row
    compare("d_table_vs_f32_plain", d_table, ref_dt)
    compare("f32_plain_d_table", ref_dt.double(), ref_dt64)
    compare("dx_all_rows", dx, ref_dx)
    finite = all(bool(torch.isfinite(t).all()) for t in (out, d_table, dx))
    ok = finite and rel["forward"] <= HASH_FWD_TOL and max(
        rel["d_table"], rel["dx"]) <= HASH_BWD_TOL
    rows, _ = hash_corners(clip_unit(x), spec)
    mark = torch.zeros(L * T, dtype=torch.bool, device=dev)
    mark[rows.reshape(-1)] = True
    distinct = int(mark.sum())
    atomics = bwd_atomics(x, spec)
    sectors = fwd_sectors(x, spec)
    del rows, mark, out, d_table, dx, ref_dt, ref_dt64, ref_dx
    reps = 5
    with torch.no_grad():
        p1, k1, k2, p2 = (cuda_ms(torch, f, reps) for f in (
            lambda: hash_encoding_plain(table, x, spec),
            lambda: hash_cuda._forward(table, x, spec),
            lambda: hash_cuda._forward(table, x, spec),
            lambda: hash_encoding_plain(table, x, spec)))
    ins = [tp, xp] if need_dx else [tp]
    run_p = lambda: torch.autograd.grad(ref, ins, g, retain_graph=True)
    run_k = lambda: hash_cuda.hash_encoding_bwd_cuda(table, x, g, spec,
                                                     need_dx=need_dx)
    run_k()
    q1, b1, b2, q2 = (cuda_ms(torch, f, reps) for f in (run_p, run_k, run_k,
                                                         run_p))
    fwd_bound, fwd_by = hash_bound_ms(spec, n, distinct, False)
    bwd_bound, bwd_by = hash_bound_ms(spec, n, distinct, True, need_dx)
    row = {"rows": n, "levels": L, "features": F, "distinct_table_rows": distinct,
           "max_abs_err": err, "rel_err": rel,
           "fwd_ms": (k1 + k2) / 2, "fwd_plain_ms": (p1 + p2) / 2,
           "fwd_bound_ms": fwd_bound, "fwd_bound_by": fwd_by,
           "fwd_sectors": sectors,
           "bwd_ms": (b1 + b2) / 2, "bwd_plain_ms": (q1 + q2) / 2,
           "bwd_bound_ms": bwd_bound, "bwd_bound_by": bwd_by,
           "bwd_need_dx": need_dx, "bwd_atomics": atomics}
    print(f"hash {name} L{L} x F{F}, {n} rows ({distinct} distinct table "
          f"rows): forward max_abs_err {err['forward']:.3e} rel "
          f"{rel['forward']:.3e} (tol {HASH_FWD_TOL}); d_table "
          f"{err['d_table']:.3e} rel {rel['d_table']:.3e}, dx on the "
          f"{int(clear.sum())} rows clear of the bounds {err['dx']:.3e} rel "
          f"{rel['dx']:.3e} (tol {HASH_BWD_TOL}; all rows rel "
          f"{rel['dx_all_rows']:.3e}; d_table against the float32 plain "
          f"{rel['d_table_vs_f32_plain']:.3e}, the float32 plain's own "
          f"{rel['f32_plain_d_table']:.3e}); "
          f"forward kernel {row['fwd_ms']:.3f} ms "
          f"[{k1:.3f}, {k2:.3f}] plain {row['fwd_plain_ms']:.3f} ms [{p1:.3f},"
          f" {p2:.3f}] bound {fwd_bound:.4f} ms ({fwd_by}); backward"
          f"{'' if need_dx else ' without dx'} kernel {row['bwd_ms']:.3f} ms "
          f"[{b1:.3f}, {b2:.3f}] plain {row['bwd_plain_ms']:.3f} ms "
          f"[{q1:.3f}, {q2:.3f}] bound {bwd_bound:.4f} ms ({bwd_by}); "
          f"table gradient atomics: {atomics['scalar']} scalar (8 L F a "
          f"row), {atomics['aggregated']} vector grouped by cell, "
          f"{atomics['distinct']} distinct (warp, level, row); forward L2 "
          f"sector requests {sum(sectors)} for {8 * L * n} gathers, by level "
          f"{sectors}", flush=True)
    if not ok:
        fail(f"hash kernels disagree with plain at {name} L{L} F{F}: {rel}")
    del ref, tp, xp, table, x, g
    torch.cuda.empty_cache()
    return row


def hash_path_points(torch, hvpipe, arrays, H, W) -> dict:
    """The points that reach the main field's hash encoding on the main
    path, taken by a forward hook on its HashTable: the first chunk of
    phase 13's render of view 0 (32,768 rays x 48 samples), and one
    full-width hash joint step as phase 14 takes it (the bench.py inputs,
    the audio branch live, a pipeline of its own from seed 0), whose main
    field (4096 rays x 48 samples, sample-innermost) and grid bake (18
    directions x 4096 cells, direction-major) each call it once ->
    {"render": x, "train_main": x, "bake": x}, each (N, 3) f32."""
    from neraf_tpu_torch.engine.factory import build_joint_pipeline

    def capture(module, run) -> list:
        seen = []
        hook = module.register_forward_hook(
            lambda _m, inputs, _o: seen.append(
                inputs[0].detach().reshape(-1, 3).clone()))
        try:
            run()
            torch.cuda.synchronize()
        finally:
            hook.remove()
        return seen

    with torch.no_grad():
        render = capture(hvpipe.vision_model.field.hash,
                         lambda: hvpipe.render_image(arrays, 0, H, W))
    jpipe = build_joint_pipeline(grid_res=128, tiny=False,
                                 device=hvpipe.device, seed=0, encoding="hash")
    jpipe.step = 3000
    cams, audio, images = bench_inputs(torch, jpipe.device)
    step = capture(jpipe.vision_model.field.hash,
                   lambda: jpipe.train_step(cams, audio, images))
    tcfg = jpipe.config
    want = (tcfg.vision_data.train_rays_per_batch
            * tcfg.vision_model.num_nerf_samples,
            tcfg.trainer.grid_bake_cells_per_step * len(jpipe.view_dirs))
    chunk = (hvpipe.vision_model.config.eval_num_rays_per_chunk
             * hvpipe.vision_model.config.num_nerf_samples)
    del jpipe
    torch.cuda.empty_cache()
    if tuple(x.shape[0] for x in step) != want or render[0].shape[0] != chunk:
        fail(f"hash path points: a step called the encoding on "
             f"{[x.shape[0] for x in step]} rows (expected {want}), a render "
             f"chunk on {render[0].shape[0]} (expected {chunk})")
    return {"render": render[0], "train_main": step[0], "bake": step[1]}


def hash_phase(torch, dev, hvpipe, arrays, H, W) -> dict:
    """Phase 12: the hash kernels against the plain version at the full
    grid, at uniform random points of the main path's three row counts and
    at tcnn's 16 x 2 layout (the L2's worst case), then at the main path's
    own points (hash_path_points) -> {name: hash_check's row}."""
    spec = hvpipe.vision_model.field.hash.spec
    points = hash_path_points(torch, hvpipe, arrays, H, W)
    n = {k: x.shape[0] for k, x in points.items()}
    rows = {
        "train_main": hash_check(torch, dev, "train_main", spec,
                                 n["train_main"], 8),
        "bake": hash_check(torch, dev, "bake", spec, n["bake"], 9,
                           need_dx=False),
        "render": hash_check(torch, dev, "render", spec, n["render"], 10),
        "train_main_tcnn_L16xF2": hash_check(
            torch, dev, "train_main", dataclasses.replace(
                spec, num_levels=16, features_per_level=2),
            n["train_main"], 11),
    }
    for seed, (name, x) in enumerate(points.items(), start=12):
        rows[f"{name}_path"] = hash_check(
            torch, dev, f"{name} (the path's points)", spec, None, seed,
            need_dx=name != "bake", x=x)
    return rows


def render_phase(torch, vpipe, arrays, H, W, what: str) -> dict:
    """Phases 7 and 13: view 0 through render_image three times (the first
    pays the cold start) and view 1 once, then evaluate_vision over both
    views against those renders plus noise, with every kernel's launch
    count set to 0 just before and read just after. Fails on shapes, rgb
    outside [0, 1], renders of one view that differ, or a PSNR below
    EVAL_MIN_PSNR."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    renders, img_times = [], []
    for cam in (0, 0, 0, 1):
        t0 = time.perf_counter()
        out = vpipe.render_image(arrays, cam, H, W)
        torch.cuda.synchronize()
        img_times.append(time.perf_counter() - t0)
        check_image(torch, out, H, W, f"{what} render_image view {cam}")
        renders.append(out)
    noise = np.random.default_rng(3).normal(0.0, EVAL_NOISE, (2, H, W, 3))
    gt = np.clip(np.stack([renders[0]["rgb"].cpu().numpy(),
                           renders[3]["rgb"].cpu().numpy()]) + noise,
                 0.0, 1.0).astype(np.float32)
    ev = vpipe.evaluate_vision(arrays, gt)
    launches = read_counts()
    launches["pe_mlp"] = launches.pop("pe_fwd")
    peak = torch.cuda.max_memory_allocated()
    for cam, dt in zip((0, 0, 0, 1), img_times):
        print(f"{what} render_image view {cam}: {dt * 1e3:.2f} ms, "
              f"{H * W / dt:.1f} rays/s")
    print(f"{what} evaluate_vision (2 views): {json.dumps(ev)}")
    print(f"{what}: launches {launches} for {len(renders) + 2} images, peak "
          f"memory {peak / 2**30:.3f} GiB", flush=True)
    if not (np.isfinite(ev["psnr"]) and ev["psnr"] >= EVAL_MIN_PSNR
            and 0.0 < ev["ssim"] <= 1.0 and ev["lpips"] is None):
        fail(f"{what} evaluate_vision against the renders plus noise: {ev}")
    repeat_err = max(float((a["rgb"] - renders[0]["rgb"]).abs().max())
                     for a in renders[1:3])
    print(f"{what}: view 0 rendered three times, rgb max_abs_err between "
          f"renders {repeat_err:.3e}")
    if not repeat_err <= 1e-6:
        fail(f"{what} render_image of one view differs between calls: "
             f"{repeat_err}")
    return {"launches": launches, "n_images": len(renders) + 2,
            "ms": img_times, "peak_gib": peak / 2**30, "eval": ev}


def stem_bound_ms(x, g) -> tuple:
    """The least time of the stem weight gradient: its products (2 cout cin
    125 per output voxel) at the peak rate of x's type, against the bytes
    of x, g and the f32 dW."""
    cin, cout = x.shape[-1], g.shape[1]
    flops = 2.0 * cout * cin * 125 * g[0, 0].numel()
    nbytes = (x.numel() + g.numel()) * x.element_size() + cout * cin * 125 * 4
    rate = H100_BF16 if x.element_size() == 2 else H100_F32
    t_ops, t_bytes = flops / rate, nbytes / H100_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def device_kernels(torch, fn) -> list:
    """The device kernels one call of fn runs, with their ms (profiler)."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name[:90], round((e.time_range.end - e.time_range.start) / 1e3,
                                4))
            for e in prof.events() if e.device_type.name == "CUDA"]


def stem_conv_channels(torch, dev, shape=(128, 128, 128)) -> dict:
    """Phase 16, the 8-channel volume: cuDNN's stem convolution in bf16 at
    the step's shape (x 1 x 128^3 NDHWC, passed as its channels_last_3d
    NCDHW view as ResNet3D passes it; g 64 x 64^3 in channels_last_3d), at
    7 input channels and at the 8 of the packed volume made from the same
    values (a zero 8th channel, zero weights): the forward, the input
    gradient and the weight gradient, each width held against the other to
    STEM_CONV_BF16_TOL of the peak and timed in turns (7, 8, 8, 7) beside
    the bound of its bf16 operations and bytes, with the device kernels
    cuDNN runs for it; each with cuDNN's heuristics (the port's setting)
    and again with torch.backends.cudnn.benchmark on (cuDNN times its
    algorithms and keeps the fastest). Then the pack itself (the f32
    7-channel grid to the bf16 8-channel volume) timed alone, and, as a
    yardstick, cuDNN's k3/s1 conv of the space-to-depth folded volume (64
    channels over 64^3, the JAX package's stem layout)."""
    import torch.nn.functional as F

    pack_volume = lambda x, dtype: F.pad(x.to(dtype), (0, 1))
    pad_weight = lambda w: F.pad(w, (0, 0, 0, 0, 0, 0, 0, 1))
    gen = torch.Generator(device=dev).manual_seed(160)
    out_shape = tuple((n - 1) // 2 + 1 for n in shape)
    grid = torch.rand((1, *shape, 7), generator=gen, device=dev)
    w7 = 0.05 * torch.randn((64, 7, 5, 5, 5), generator=gen, device=dev)
    gy = torch.randn((1, 64, *out_shape), generator=gen, device=dev).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last_3d)
    bf = torch.bfloat16
    inputs = {7: (grid.to(bf), w7.to(bf)),
              8: (pack_volume(grid, bf), pad_weight(w7).to(bf))}

    def ops(x, w):
        xc = x.permute(0, 4, 1, 2, 3)
        bwd = lambda mask: torch.ops.aten.convolution_backward(
            gy, xc, w, None, (2, 2, 2), (2, 2, 2), (1, 1, 1), False,
            (0, 0, 0), 1, mask)
        return {"forward": lambda: F.conv3d(xc, w, None, 2, 2),
                "input gradient": lambda: bwd((True, False, False))[0],
                "weight gradient": lambda: bwd((False, True, False))[1]}

    runs = {c: ops(*inputs[c]) for c in (7, 8)}
    xf = torch.randn((1, 64, *out_shape), generator=gen, device=dev).to(
        bf).contiguous(memory_format=torch.channels_last_3d)
    wf = (0.05 * torch.randn((64, 64, 3, 3, 3), generator=gen,
                             device=dev)).to(bf)
    folded = lambda: F.conv3d(xf, wf, None, 1, 1)
    row = {}
    for bench in (False, True):
        torch.backends.cudnn.benchmark = bench
        tag = "benchmark" if bench else "heuristics"
        for k in runs[7]:
            a, b = runs[7][k](), runs[8][k]()
            if k != "forward":
                b = b[:, :7]  # the zero channel's gradient, dropped as the pad does
            torch.cuda.synchronize()
            rel = float((a.float() - b.float()).abs().max()
                        / a.float().abs().max())
            t7a, t8a, t8b, t7b = (cuda_ms(torch, runs[c][k], 10)
                                  for c in (7, 8, 8, 7))
            bounds = {}
            for c in (7, 8):
                x, w = inputs[c]
                flops = 2.0 * 64 * c * 125 * gy[0, 0].numel()
                nbytes = (x.numel() + w.numel() + gy.numel()) * 2
                t_ops, t_bytes = flops / H100_BF16, nbytes / H100_BYTES
                bounds[c] = (max(t_ops, t_bytes) * 1e3,
                             "operations" if t_ops > t_bytes else "bytes")
            kern = {c: device_kernels(torch, runs[c][k]) for c in (7, 8)}
            row[f"{k}, {tag}"] = {
                "ms_7": (t7a + t7b) / 2, "ms_8": (t8a + t8b) / 2,
                "turns": [t7a, t8a, t8b, t7b], "rel_err_8_vs_7": rel,
                "bound_ms_7": bounds[7][0], "bound_ms_8": bounds[8][0],
                "bound_by": bounds[8][1], "kernels_7": kern[7],
                "kernels_8": kern[8]}
            print(f"cuDNN stem conv {k}, bf16, {tag}, 7 vs 8 input channels "
                  f"on the same inputs: {(t7a + t7b) / 2:.4f} vs "
                  f"{(t8a + t8b) / 2:.4f} ms (turns 7, 8, 8, 7: {t7a:.4f}, "
                  f"{t8a:.4f}, {t8b:.4f}, {t7b:.4f}); bound {bounds[7][0]:.4f}"
                  f" / {bounds[8][0]:.4f} ms ({bounds[8][1]}); 8 vs 7 rel "
                  f"{rel:.3e} (tol {STEM_CONV_BF16_TOL}); device kernels at 7:"
                  f" {kern[7]}; at 8: {kern[8]}", flush=True)
            if not rel <= STEM_CONV_BF16_TOL:
                fail(f"cuDNN stem conv {k}, {tag}: 8 channels differ from 7 "
                     f"by {rel}")
            del a, b
        folded()
        ms_f = cuda_ms(torch, folded, 10)
        row[f"folded k3/s1 forward, {tag}"] = {
            "ms": ms_f, "kernels": device_kernels(torch, folded)}
        print(f"cuDNN k3/s1 conv of the space-to-depth folded volume (64 "
              f"channels over {tuple(out_shape)}), bf16, {tag}: {ms_f:.4f} ms; "
              f"device kernels {row[f'folded k3/s1 forward, {tag}']['kernels']}",
              flush=True)
    torch.backends.cudnn.benchmark = False
    pack = cuda_ms(torch, lambda: pack_volume(grid, bf), 10)
    print(f"stem volume pack (f32 7 channels -> bf16 8), alone: {pack:.4f} "
          "ms", flush=True)
    row["pack_ms"] = pack
    return row


def stem_check(torch, dev, name, shape, cin, seed) -> dict:
    """Phase 16 at one shape: the stem weight-gradient kernel against the
    plain version in float64 on the same inputs (x (1, D, H, W, cin): 7
    channels as the stem gives them, or 8 with a zero 8th; g (1, 64, Do,
    Ho, Wo) in channels_last_3d, as the conv's output cotangent arrives),
    bf16 and f32, to STEM_REL_TOL of the peak, and a second call bitwise
    equal to the first; then the kernel, the plain version (float32 sums)
    and cuDNN's weight gradient of the same conv on the same inputs timed
    (plain, kernel, kernel, plain, cuDNN)."""
    import torch.nn.functional as F

    from neraf_tpu_torch.ops.cuda.stem_wgrad import stem_wgrad_cuda
    from neraf_tpu_torch.ops.stem_wgrad import stem_wgrad_plain

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(seed)
    out_shape = tuple((n - 1) // 2 + 1 for n in shape)
    x0 = torch.randn((1, *shape, 7), generator=gen, device=dev)
    g0 = torch.randn((1, 64, *out_shape), generator=gen, device=dev)
    row = {"shape": list(shape), "cin": cin}
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        x = F.pad(x0.to(dtype), (0, cin - 7))
        g = g0.to(dtype).contiguous(memory_format=torch.channels_last_3d)
        got = stem_wgrad_cuda(x, g)
        again = stem_wgrad_cuda(x, g)
        ref = stem_wgrad_plain(x.double(), g.double())
        torch.cuda.synchronize()
        if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
            fail(f"stem wgrad {name} {tag}: shape {tuple(got.shape)} or not "
                 "finite")
        if not torch.equal(got, again):
            fail(f"stem wgrad {name} {tag}: two calls differ")
        err = float((got.double() - ref).abs().max())
        rel = err / float(ref.abs().max())
        w = torch.zeros((64, cin, 5, 5, 5), dtype=dtype, device=dev)
        xc = x.permute(0, 4, 1, 2, 3)
        cudnn = lambda: torch.ops.aten.convolution_backward(
            g, xc, w, None, (2, 2, 2), (2, 2, 2), (1, 1, 1), False, (0, 0, 0),
            1, (False, True, False))
        reps = 10
        run_k = lambda: stem_wgrad_cuda(x, g)
        run_p = lambda: stem_wgrad_plain(x, g)
        for f in (run_k, run_p, cudnn):
            f()
        p1, k1, k2, p2, c1 = (cuda_ms(torch, f, reps) for f in (
            run_p, run_k, run_k, run_p, cudnn))
        bound, by = stem_bound_ms(x, g)
        ms_k, ms_p = (k1 + k2) / 2, (p1 + p2) / 2
        print(f"stem wgrad {name} x {tuple(x.shape)} g {tuple(g.shape)} {tag}: "
              f"max_abs_err {err:.3e}, rel {rel:.3e} vs float64 (tol "
              f"{STEM_REL_TOL}), two calls bitwise equal; kernel "
              f"{ms_k:.4f} ms [{k1:.4f}, {k2:.4f}] plain {ms_p:.3f} ms "
              f"[{p1:.3f}, {p2:.3f}] cuDNN wgrad {c1:.4f} ms; bound "
              f"{bound:.4f} ms ({by})", flush=True)
        if not rel <= STEM_REL_TOL:
            fail(f"stem wgrad kernel disagrees with float64 at {name} {tag}: "
                 f"rel {rel}")
        row[tag] = {"max_abs_err": err, "rel_err": rel, "ms": ms_k,
                    "plain_ms": ms_p, "library_ms": c1, "bound_ms": bound,
                    "bound_by": by}
        del got, again, ref, x, g, xc
        torch.cuda.empty_cache()
    return row


def concat_check(torch, dev) -> dict:
    """Phase 19: the shifted-slice concat kernel against torch.cat of the
    two slices (its plain version and its library call), bitwise, at the
    canary's shape, at hop 256 and at (1024, 79, 128) t 78, the launches
    counted; then at the last shape the kernel and torch.cat timed
    (cat, kernel, kernel, cat) beside the bound: x read and the output
    written once, over 3.35 TB/s."""
    from neraf_tpu_torch.ops.shifted_concat import (
        shifted_value_concat,
        shifted_value_concat_plain,
    )

    gen = torch.Generator(device=dev).manual_seed(19)
    shapes = ((8, 19, 128, 16), (8, 19, 256, 16), (1024, 79, 128, 78))
    reset_counts()
    xs = []
    for m, rows, hop, t in shapes:
        x = torch.randn((m, rows, hop), generator=gen, device=dev)
        if not torch.equal(shifted_value_concat(x, t),
                           shifted_value_concat_plain(x, t)):
            fail(f"shifted concat differs from torch.cat at {(m, rows, hop)} "
                 f"t {t}")
        xs.append(x)
    launches = read_counts()["concat"]
    if launches != len(shapes):
        fail(f"shifted concat: {launches} launches for {len(shapes)} calls")
    x, t = xs[-1], shapes[-1][3]
    reps = 20
    p1, k1, k2, p2 = (cuda_ms(torch, f, reps) for f in (
        lambda: shifted_value_concat_plain(x, t),
        lambda: shifted_value_concat(x, t),
        lambda: shifted_value_concat(x, t),
        lambda: shifted_value_concat_plain(x, t)))
    nbytes = (x.numel() + x.shape[0] * t * 2 * x.shape[2]) * 4
    bound = nbytes / H100_BYTES * 1e3
    ms_k, ms_p = (k1 + k2) / 2, (p1 + p2) / 2
    print(f"shifted concat: bitwise equal to torch.cat at {shapes}; at "
          f"{tuple(x.shape)} t {t}: kernel {ms_k:.4f} ms [{k1:.4f}, {k2:.4f}] "
          f"torch.cat {ms_p:.4f} ms [{p1:.4f}, {p2:.4f}] bound {bound:.4f} ms "
          f"(bytes, {nbytes / 1e6:.1f} MB)", flush=True)
    return {"launches": launches, "ms": ms_k, "plain_ms": ms_p,
            "bound_ms": bound}


def step_turns(torch, off, on, rounds: int = 8) -> dict:
    """Phase 17's comparison of the joint step with the stem kernel off and
    on, in turns (off, on, on, off) on the bench.py inputs with the audio
    branch live, after one step each: ms per step on the host clock up to
    torch.cuda.synchronize()."""
    cams, audio, images = bench_inputs(torch, off.device)
    times = {"off": [], "on": []}
    for pipe in (off, on):
        pipe.step = 3000
        pipe.train_step(cams, audio, images)
    for _ in range(rounds):
        for name in ("off", "on", "on", "off"):
            pipe = on if name == "on" else off
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe.train_step(cams, audio, images)
            torch.cuda.synchronize()
            times[name].append(1e3 * (time.perf_counter() - t0))
    wins = sum(b < a for a, b in zip(times["off"], times["on"]))
    q = {k: np.percentile(v, [25, 50, 75]) for k, v in times.items()}
    print(f"joint step, stem kernel off and on in turns ({rounds} rounds of "
          f"off, on, on, off; host clock): median (quartiles) off "
          f"{q['off'][1]:.2f} ({q['off'][0]:.2f}-{q['off'][2]:.2f}) ms, on "
          f"{q['on'][1]:.2f} ({q['on'][0]:.2f}-{q['on'][2]:.2f}) ms; on "
          f"faster in {wins} of {len(times['on'])} pairs", flush=True)
    return {"off_ms": float(q["off"][1]), "on_ms": float(q["on"][1]),
            "on_wins": wins, "pairs": len(times["on"]), "ms": times}


def table_costs(torch, table) -> dict:
    """What the hash table costs a step outside the kernels, timed alone
    (CUDA events): allocating and zeroing its dense gradient, and one fused
    Adam update of it (each of the two groups that hold it updates all of
    it)."""
    zero = cuda_ms(torch, lambda: torch.zeros_like(table), 10)
    p = table.detach().clone().requires_grad_()
    p.grad = torch.randn_like(p)
    opt = torch.optim.Adam([p], lr=1e-3, eps=1e-15, fused=True)
    opt.step()
    adam = cuda_ms(torch, opt.step, 10)
    print(f"hash table {tuple(table.shape)} ({table.numel() * 4 / 2**20:.0f} "
          f"MiB), alone (ms, CUDA events): zeroed gradient {zero:.3f}, one "
          f"fused Adam update {adam:.3f} (two a step)", flush=True)
    return {"zero_grad_ms": zero, "adam_ms": adam}


# Phase 20: the eval paths. The batched estimators against the host ones
# on the GT waveforms (decaying RIRs): both integrate the energy in
# float64, so a crossing sits at the same sample and T60, EDT and C50 agree
# to float rounding; EVAL_RTOL leaves room for that and fails a wrong
# search (a sample's shift is 1e-3 of an EDT of 0.05 s at 22,050 Hz only
# for EDT under ~0.3 s, so any shift there fails). Card against CPU, the
# estimators' index arithmetic is exact: T60 and EDT equal, C50 within one
# float32 ulp (float64 sums in another order, rounded to the input's
# float32: 6e-8 relative on an H100).
EVAL_RTOL, EVAL_C50_DEVICE_RTOL = 1e-3, 2.0 ** -23
EVAL_RIRS, EVAL_CHUNK = 1024, 512
EVAL_KEYS = ("audio_T60_mean_error", "audio_total_invalids_T60", "audio_EDT",
             "audio_C50")
HOST_EVAL_KEYS = {f"{k}{s}" for k in EVAL_KEYS for s in ("", "_std")} | {
    "fps_audio", "num_rays_per_sec_audio"}
DEVICE_EVAL_KEYS = {*EVAL_KEYS, "audio_mag", "fps_audio",
                    "num_rays_per_sec_audio"}
LOSS_KEYS = {"rgb_loss", "interlevel_loss", "distortion_loss", "audio_sc_loss",
             "audio_mag_loss"}


def train_state(torch, pipe) -> dict:
    """Copies of everything a train step reads and writes: weights,
    BatchNorm statistics, Adam state, grid, cursor, step, generator."""
    state = {f"{name}.{k}": v.detach().clone() for name, m in (
        ("vision", pipe.vision_model), ("audio", pipe.audio_model),
        ("resnet", pipe.resnet)) for k, v in m.state_dict().items()}
    for g, opt in pipe.optimizers.items():
        for i, st in enumerate(opt.opt.state.values()):
            state.update({f"adam.{g}.{i}.{k}": v.clone() for k, v in st.items()
                          if torch.is_tensor(v)})
    state["grid"] = pipe.grid.clone()
    state["generator"] = pipe.generator.get_state()
    state["cursor"] = torch.tensor(pipe.cursor)
    state["step"] = torch.tensor(pipe.step)
    return state


def host_estimates(wavs: np.ndarray, fs: float) -> dict:
    """Per RIR and channel: the host T60 (30 dB, -1 where it raises), EDT
    and C50 of (M, C, L) waveforms."""
    from neraf_tpu_torch.metrics import room_acoustics as ra

    def t60(h):
        try:
            return ra.measure_rt60(h, fs, decay_db=30)
        except (IndexError, ValueError, FloatingPointError):
            return -1.0

    flat = wavs.reshape(-1, wavs.shape[-1])
    out = {"t60": [t60(h) for h in flat],
           "edt": [ra.measure_edt(h, fs) for h in flat],
           "c50": [ra.measure_clarity(h, fs=fs) for h in flat]}
    return {k: np.asarray(v).reshape(wavs.shape[:-1]) for k, v in out.items()}


def device_estimates(torch, wavs, fs: float) -> dict:
    from neraf_tpu_torch.metrics import room_acoustics as ra

    return {"t60": ra.batched_rt60(wavs, fs, decay_db=30.0).cpu().numpy(),
            "edt": ra.batched_edt(wavs, fs).cpu().numpy(),
            "c50": ra.batched_clarity(wavs, fs).cpu().numpy()}


def estimate_gaps(dev: dict, host: dict) -> dict:
    """Invalid-T60 flags that differ, and the largest relative gaps where
    both sides are valid (T60) or finite (EDT, C50)."""
    flips = int(((dev["t60"] < 0) != (host["t60"] < 0)).sum())
    both = (dev["t60"] >= 0) & (host["t60"] >= 0)
    rel = lambda a, b, m: float((np.abs(a - b)[m] / np.abs(b)[m]).max()
                                if m.any() else 0.0)
    fin = lambda k: np.isfinite(dev[k]) & np.isfinite(host[k])
    return {"t60_flag_flips": flips, "t60_valid": int(both.sum()),
            "t60_rel": rel(dev["t60"], host["t60"], both),
            "edt_rel": rel(dev["edt"], host["edt"], fin("edt")),
            "edt_nan_flips": int((np.isnan(dev["edt"])
                                  != np.isnan(host["edt"])).sum()),
            "c50_rel": rel(dev["c50"], host["c50"], fin("c50"))}


def check_eval_dict(out: dict, keys: set, what: str) -> None:
    """The reference's keys; every value finite except EDT, which the
    reference's own test lets be NaN on degenerate predictions
    (tests/test_eval_paths.py:90)."""
    if set(out) != keys:
        fail(f"{what}: keys {sorted(out)}, expected {sorted(keys)}")
    bad = {k: v for k, v in out.items()
           if not np.isfinite(v) and not k.startswith("audio_EDT")}
    if bad:
        fail(f"{what}: not finite {bad}")


def counted(torch, what: str, fn, want: dict):
    """fn() with every launch count set to 0 just before and read just
    after; fails unless the counts are `want` (others 0) -> (result,
    counts, seconds by the host clock, the device synchronised)."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    expect = {k: want.get(k, 0) for k in counts}
    if counts != expect:
        fail(f"{what}: launches {counts}, expected {expect}")
    return out, counts, dt


def eval_phase(torch, dev) -> dict:
    """Phase 20: the eval paths of the full-width fourier JointPipeline
    (seed 0, bf16; two train steps first, so that the grid, BatchNorm
    statistics and Adam state are not their initial values) on a synthetic
    SoundSpaces eval split of EVAL_RIRS RIRs."""
    from neraf_tpu_torch.data.synthetic import synth_scene
    from neraf_tpu_torch.dsp.griffin_lim import random_angles
    from neraf_tpu_torch.engine.factory import build_joint_pipeline

    pipe = build_joint_pipeline(grid_res=128, tiny=False, device=dev, seed=0)
    cams, audio, images = bench_inputs(torch, dev)
    pipe.step = 3000  # the audio branch live: the statistics move
    for i in range(2):
        check_metrics(pipe.train_step(cams, audio, images), f"eval warm-up {i}")
    cfg = pipe.audio_model.config
    t0 = time.perf_counter()
    ds = synth_scene(EVAL_RIRS, fs=cfg.fs, max_len=cfg.max_len, seed=1)
    print(f"eval: split of {EVAL_RIRS} synthetic RIRs (binaural, "
          f"{cfg.n_freq_stft} bins, T {cfg.max_len}, waveforms "
          f"{ds.waveforms.shape[-1]} samples) built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    before = train_state(torch, pipe)
    n_chunks = -(-EVAL_RIRS // EVAL_CHUNK)
    res = {}

    # the audio sweeps, twice each (the first pays the cold start)
    for name, fn, keys, gl in (
            ("evaluate_audio", pipe.evaluate_audio, HOST_EVAL_KEYS, 2),
            ("evaluate_audio_device", pipe.evaluate_audio_device,
             DEVICE_EVAL_KEYS, 1)):
        for run in range(2):
            out, counts, wall = counted(
                torch, f"{name} {run}", lambda: fn(ds, chunk=EVAL_CHUNK),
                {"gl": gl * n_chunks})
            check_eval_dict(out, keys, f"{name} {run}")
            timed = EVAL_RIRS / out["fps_audio"]
            print(f"eval {name} run {run}: fps_audio {out['fps_audio']:.2f} "
                  f"({'render' if gl == 2 else 'whole sweep'} "
                  f"{timed * 1e3:.2f} ms, {timed * 1e3 / n_chunks:.2f} ms a "
                  f"chunk of {EVAL_CHUNK}); wall {wall:.3f} s, host metrics "
                  f"and transfers {wall - timed:.3f} s; launches {counts}; "
                  f"{json.dumps(out)}", flush=True)
            res[name] = {"fps_audio": out["fps_audio"], "wall_s": wall,
                         "ms_per_chunk": timed * 1e3 / n_chunks,
                         "gl_launches": counts["gl"], "metrics": out}

    # host against device estimators, per RIR: on the GT waveforms (fatal),
    # then on one chunk's predictions (printed)
    gt = torch.as_tensor(ds.waveforms, device=dev)
    t0 = time.perf_counter()
    host = host_estimates(ds.waveforms, cfg.fs)
    host_s = time.perf_counter() - t0
    gaps = estimate_gaps(device_estimates(torch, gt, cfg.fs), host)
    print(f"eval GT estimates, device vs host ({host_s:.2f} s host), "
          f"{EVAL_RIRS} x {cfg.mic_ch}: {gaps}", flush=True)
    if not (gaps["t60_flag_flips"] == 0 and gaps["edt_nan_flips"] == 0
            and max(gaps["t60_rel"], gaps["edt_rel"], gaps["c50_rel"])
            <= EVAL_RTOL and gaps["t60_valid"] > 0):
        fail(f"eval: device and host estimators differ on the GT: {gaps}")
    o = ds.outputs
    angles = random_angles((EVAL_CHUNK, *ds.log_stft.shape[1:]),
                           torch.Generator(device=dev).manual_seed(0), dev)
    sl = slice(0, EVAL_CHUNK)
    wav = pipe.render_rir_chunk(o.microphone_poses[sl], o.source_poses[sl],
                                o.rotations[sl], ds.log_stft[sl], angles)[3]
    wav = torch.nn.functional.pad(wav, (0, gt.shape[-1] - wav.shape[-1]))
    pred_gaps = estimate_gaps(device_estimates(torch, wav, cfg.fs),
                              host_estimates(wav.cpu().numpy(), cfg.fs))
    print(f"eval prediction estimates, device vs host, {EVAL_CHUNK} x "
          f"{cfg.mic_ch} (printed, not gated: degenerate untrained RIRs): "
          f"{pred_gaps}", flush=True)

    # eval_loss_dict at full width
    losses, counts, dt = counted(
        torch, "eval_loss_dict",
        lambda: pipe.eval_loss_dict(cams, audio, images), {"pe_fwd": 3})
    if set(losses) != LOSS_KEYS | {"audio_mag"} or not all(
            np.isfinite(v) for v in losses.values()):
        fail(f"eval_loss_dict: {losses}")
    print(f"eval_loss_dict ({pipe.config.vision_data.eval_rays_per_batch} "
          f"rays, {pipe.config.audio_data.batch_size} slices): {dt * 1e3:.2f}"
          f" ms, launches {counts}; {json.dumps(losses)}", flush=True)
    res["eval_loss_dict"] = {"pe_launches": counts["pe_fwd"], "ms": dt * 1e3}

    # eval_image: one 512 x 512 view and one RIR
    H, W = images["images"].shape[1:3]
    item = {"mic_pose": o.microphone_poses[0], "source_pose": o.source_poses[0],
            "rot": o.rotations[0], "data": ds.log_stft[0]}
    n_img_chunks = -(-H * W // pipe.config.vision_model.eval_num_rays_per_chunk)
    (metrics, imgs), counts, dt = counted(
        torch, "eval_image",
        lambda: pipe.eval_image(cams, 0, images["images"][0].cpu().numpy(),
                                eval_audio_item=item),
        {"pe_fwd": 3 * n_img_chunks})
    shapes = {k: v.shape for k, v in imgs.items()}
    want = {"img": (H, W, 3), "depth": (H, W), "accumulation": (H, W),
            "grid": (pipe.grid_res, pipe.grid_res, 3),
            "grid_density": (pipe.grid_res, pipe.grid_res, 3),
            **{f"comparison_ch_{c}": (cfg.n_freq_stft, 2 * cfg.max_len, 3)
               for c in range(cfg.mic_ch)}}
    if shapes != want or not all(np.isfinite(v).all() for v in imgs.values()):
        fail(f"eval_image: images {shapes}, expected {want}")
    if not all(np.isfinite(metrics[k]) for k in ("psnr", "ssim", "audio_mag")):
        fail(f"eval_image: metrics {metrics}")
    print(f"eval_image ({H} x {W}, {n_img_chunks} chunks, one RIR): "
          f"{dt * 1e3:.2f} ms, launches {counts}; psnr {metrics['psnr']:.4f} "
          f"ssim {metrics['ssim']:.4f} audio_mag {metrics['audio_mag']:.4f}; "
          f"images {shapes}", flush=True)
    res["eval_image"] = {"pe_launches": counts["pe_fwd"], "ms": dt * 1e3}

    # query_grid_full over every cell
    n_cells, batch = pipe.cells.shape[0], 4096
    grid, counts, dt = counted(
        torch, "query_grid_full", lambda: pipe.query_grid_full(batch),
        {"pe_fwd": n_cells // batch})
    if not (bool(torch.isfinite(grid).all()) and bool((grid[:, :3] > 0).all())
            and bool(((grid[:, 3] >= 0) & (grid[:, 3] <= 1)).all())
            and torch.equal(grid[:, 4:], pipe.grid[:, 4:])):
        fail("query_grid_full: a cell not written, or the coordinates moved")
    print(f"query_grid_full: {n_cells} cells in {n_cells // batch} batches of "
          f"{batch}: {dt:.3f} s, launches {counts}", flush=True)
    res["query_grid_full"] = {"pe_launches": counts["pe_fwd"], "s": dt}

    after = train_state(torch, pipe)
    moved = [k for k in before if not torch.equal(before[k], after[k])]
    if moved or set(after) != set(before):
        fail(f"eval phase changed the train state: {moved[:10]}")
    print(f"eval: the train state ({len(before)} tensors: weights, BatchNorm "
          "statistics, Adam state, grid, cursor, step, generator) is bitwise "
          "unchanged", flush=True)
    return res


def eval_card_vs_cpu(torch) -> dict:
    """Phase 20's tiny f32 check: eval_loss_dict on the card against the
    CPU from the same weights, state and draws (the CPU's fields in
    float64, as phase 11), and the batched estimators' GT estimates on
    both devices."""
    from neraf_tpu_torch.data.loader import audio_arrays
    from neraf_tpu_torch.data.synthetic import synth_scene
    from neraf_tpu_torch.data.vision_data import camera_arrays, synthetic_cameras
    from neraf_tpu_torch.engine.factory import build_joint_pipeline

    on = {d: build_joint_pipeline(grid_res=32, tiny=True, device=d, seed=0,
                                  mixed_precision=False)
          for d in ("cpu", "cuda")}
    vm = on["cpu"].vision_model
    for field in (vm.field, *vm.proposal_networks):
        field.dtype = torch.float64
    rng = np.random.default_rng(9)
    H, W, n_rec = 12, 10, 5
    cams = synthetic_cameras(8, H, W, seed=3)
    images = rng.uniform(0.0, 1.0, (8, H, W, 3)).astype(np.float32)
    split = {"mic_pose": rng.uniform(-2, 2, (n_rec, 3)),
             "source_pose": rng.uniform(-2, 2, (n_rec, 3)),
             "rot": rng.uniform(0, 1, (n_rec, 3)),
             "log_stft": rng.normal(-3, 0.5, (n_rec, 2, 257, 12))}
    grid = on["cpu"].grid.clone()
    grid[:, :4] = torch.as_tensor(rng.uniform(0, 1, (grid.shape[0], 4)))
    cfg = on["cpu"].config
    R, B = cfg.vision_data.eval_rays_per_batch, cfg.audio_data.batch_size
    draws = {"cam": rng.integers(0, 8, R), "py": rng.integers(0, H, R),
             "px": rng.integers(0, W, R), "rec": rng.integers(0, n_rec, B),
             "t": rng.integers(0, 12, B)}
    m = {}
    for d, p in on.items():
        p.grid = grid.to(d)
        m[d] = p.eval_loss_dict(camera_arrays(cams, d), audio_arrays(split, d),
                                {"images": torch.as_tensor(images, device=d)},
                                draws)
    ref = m["cpu"]
    total = ref["rgb_loss"] + ref["audio_mag_loss"]
    for k, v in ref.items():
        atol = (TRAIN_LOSS_RTOL * total
                if k in ("interlevel_loss", "distortion_loss") else 0.0)
        if not abs(m["cuda"][k] - v) <= TRAIN_LOSS_RTOL * abs(v) + atol:
            fail(f"tiny eval_loss_dict: {k} card {m['cuda'][k]} vs cpu {v}")
    ds = synth_scene(16, max_len=60, seed=2)
    est = {d: device_estimates(torch, torch.as_tensor(ds.waveforms, device=d),
                               ds.fs) for d in ("cpu", "cuda")}
    c50_rel = float(np.abs(est["cuda"]["c50"].astype(np.float64)
                           / est["cpu"]["c50"] - 1).max())
    same = {k: int((est["cuda"][k] != est["cpu"][k]).sum()) for k in ("t60", "edt")}
    if any(same.values()) or not c50_rel <= EVAL_C50_DEVICE_RTOL:
        fail(f"batched GT estimates differ card vs CPU: T60 and EDT at "
             f"{same} of {est['cpu']['t60'].size}, C50 {c50_rel:.3e} relative")
    err = {k: abs(m["cuda"][k] - v) / max(abs(v), 1e-30) for k, v in ref.items()}
    print(f"tiny eval card vs cpu: eval_loss_dict within {TRAIN_LOSS_RTOL} "
          f"(relative gaps {json.dumps(err)}); GT T60 and EDT equal "
          f"({int((est['cpu']['t60'] >= 0).sum())} of "
          f"{est['cpu']['t60'].size} T60 valid), C50 within {c50_rel:.2e} "
          f"(tol {EVAL_C50_DEVICE_RTOL:.2e})",
          flush=True)
    return err


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    from neraf_tpu_torch.dsp.griffin_lim import griffin_lim, random_angles
    from neraf_tpu_torch.data.vision_data import camera_arrays, synthetic_cameras
    from neraf_tpu_torch.dsp.stft import log_to_magnitude
    from neraf_tpu_torch.engine.factory import (
        build_joint_pipeline,
        build_render_pipeline,
        build_vision_pipeline,
        joint_config,
    )
    from neraf_tpu_torch.engine.pipeline import gl_waveforms
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
    gl_rows = {(geo, M): gl_check(torch, dev, n_fft, hop, win, T, M)
               for geo, n_fft, hop, win, T, M in GL_SHAPES}
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
            "griffin_lim": lambda: gl_waveforms(cfg, mag, ang),
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
    vis = render_phase(torch, vpipe, arrays, H, W, "vision")
    vis_launches = vis["launches"]["pe_mlp"]
    if vis_launches != 3 * n_chunks * vis["n_images"] or any(
            v for k, v in vis["launches"].items() if k != "pe_mlp"):
        fail(f"vision path: launches {vis['launches']}, expected pe_mlp "
             f"{3 * n_chunks * vis['n_images']} and no other")
    parts, n_timed = chunk_breakdown(torch, vpipe, arrays, H, W)
    print(f"vision breakdown, mean of {n_timed} chunks (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts.items()), flush=True)
    print(f"nvidia-smi clocks.sm,power.draw,power.limit,temp: "
          f"{smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    del vpipe, vmodel
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

    del tiny
    torch.cuda.empty_cache()

    # phase 9: the PE+MLP backward kernel against the plain backward, at the
    # shapes one joint step gives it, with the training model's weights
    jpipe = build_joint_pipeline(grid_res=128, tiny=False, device=dev, seed=0)
    jv = jpipe.vision_model
    tcfg = jpipe.config
    R = tcfg.vision_data.train_rays_per_batch
    bake = tcfg.trainer.grid_bake_cells_per_step
    props = [[(l.weight, l.bias) for l in jv.proposal(i).mlp] for i in (0, 1)]
    p0, p1 = tcfg.vision_model.num_proposal_samples
    bwd_rows = {
        "proposal_0": pe_bwd_check(torch, dev, "proposal_0", props[0], 6,
                                   R * p0, 4, True),
        "proposal_1": pe_bwd_check(torch, dev, "proposal_1", props[1], 6,
                                   R * p1, 5, True),
        "main_field": pe_bwd_check(torch, dev, "main_field",
                                   jv.field.base_layers(), 10,
                                   R * tcfg.vision_model.num_nerf_samples, 6,
                                   True),
        "grid_bake": pe_bwd_check(torch, dev, "grid_bake",
                                  jv.field.base_layers(), 10,
                                  bake * len(jpipe.view_dirs), 7, False),
    }
    print(f"nvidia-smi clocks.sm,power.draw,power.limit,temp: "
          f"{smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    # phase 10: the full-width joint train step
    print(f"joint: full-width pipeline ({jpipe.resnet.backbone}, grid 128^3, "
          f"w_field {jpipe.audio_model.config.w_field}, {R} rays, "
          f"{tcfg.audio_data.batch_size} STFT slices, {bake} cells a step, "
          f"mixed precision {jpipe.mixed})", flush=True)
    joint = joint_step_phase(torch, jpipe, {"pe_fwd": 4, "pe_bwd": 4})
    print(f"nvidia-smi clocks.sm,power.draw,power.limit,temp: "
          f"{smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    del jpipe, jv, props
    torch.cuda.empty_cache()

    # phase 11: the tiny joint step, f32, card against CPU
    tiny_joint_card_vs_cpu(torch)

    # phase 12: the hash-encoding kernels against the plain version, at the
    # full-width grid and the shapes the main path gives them
    hvpipe = build_vision_pipeline(tiny=False, device=dev, seed=0,
                                   encoding="hash")
    hmodel = hvpipe.vision_model
    hcfg = hmodel.config
    spec = hmodel.field.hash.spec
    hash_rows = hash_phase(torch, dev, hvpipe, arrays, H, W)
    print(f"nvidia-smi clocks.sm,power.draw,power.limit,temp: "
          f"{smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    # phase 13: the full-width hash render through render_image and
    # evaluate_vision
    print(f"hash vision: full-width model (hash L{spec.num_levels} x "
          f"F{spec.features_per_level}, 2^{spec.log2_hashmap_size} rows a "
          f"level, resolutions {spec.resolutions().tolist()}, base MLP 2 x "
          f"{hcfg.hidden_dim}, proposals fourier, samples "
          f"{hcfg.num_proposal_samples} -> {hcfg.num_nerf_samples}, "
          f"{hmodel.field.dtype}), {H} x {W} view, {n_chunks} chunks of "
          f"{chunk} rays", flush=True)
    hvis = render_phase(torch, hvpipe, arrays, H, W, "hash vision")
    n_img = hvis["n_images"]
    want = {k: 0 for k in hvis["launches"]}
    want.update({"pe_mlp": 2 * n_chunks * n_img, "hash_fwd": n_chunks * n_img})
    if hvis["launches"] != want:
        fail(f"hash vision path: launches {hvis['launches']}, expected {want}")
    parts, n_timed = chunk_breakdown(torch, hvpipe, arrays, H, W)
    print(f"hash vision breakdown, mean of {n_timed} chunks (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts.items()), flush=True)
    del hvpipe, hmodel
    torch.cuda.empty_cache()

    # phase 14: the full-width hash joint step
    hjpipe = build_joint_pipeline(grid_res=128, tiny=False, device=dev,
                                  seed=0, encoding="hash")
    table = hjpipe.vision_model.field.hash.table
    table0 = table.detach().clone()
    print(f"hash joint: full-width pipeline (main field on the hash grid, "
          f"table {tuple(table.shape)}; {R} rays, {bake} cells a step)",
          flush=True)
    hjoint = joint_step_phase(
        torch, hjpipe, {"pe_fwd": 2, "pe_bwd": 2, "hash_fwd": 2, "hash_bwd": 2},
        what="hash joint step", stem=False)
    moved = int((table.detach() != table0).any(dim=-1).sum())
    print(f"hash joint: {moved} of {table.shape[0] * table.shape[1]} table "
          f"rows changed over the run", flush=True)
    if moved == 0:
        fail("hash joint step: the table did not change")
    costs = table_costs(torch, table)
    print(f"nvidia-smi clocks.sm,power.draw,power.limit,temp: "
          f"{smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    del hjpipe, table, table0
    torch.cuda.empty_cache()

    # phase 15: the tiny hash joint step, f32, card against CPU, F 2 and 4
    tiny_hash = joint_config(tiny=True, encoding="hash")
    for F in (2, 4):
        tiny_hash.vision_model = dataclasses.replace(
            tiny_hash.vision_model, features_per_level=F)
        worst = tiny_joint_card_vs_cpu(torch, f"tiny hash joint F{F}",
                                       config=tiny_hash)
        print(f"tiny hash joint F{F}: table gradient "
              f"{worst['field.hash.table']:.3e} of its peak", flush=True)

    # phase 16: cuDNN's stem conv at 7 and 8 input channels, then the stem
    # weight-gradient kernel against the plain version
    stem_conv_rows = stem_conv_channels(torch, dev)
    stem_rows = {name: stem_check(torch, dev, name, shape, cin, seed)
                 for name, shape, cin, seed in (
                     ("step", (128, 128, 128), 7, 16),
                     ("cube", (16, 16, 16), 7, 17),
                     ("asymmetric", (10, 34, 18), 8, 18),
                     ("asymmetric_w", (10, 18, 34), 7, 19))}
    print(f"nvidia-smi clocks.sm,power.draw,power.limit,temp: "
          f"{smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    # phase 17: the full-width joint step with the stem kernel, against
    # phase 10's run with the gate off
    with stem_gate():
        sjpipe = build_joint_pipeline(grid_res=128, tiny=False, device=dev,
                                      seed=0)
    if not sjpipe.resnet.stem_wgrad_kernel:
        fail(f"{GATE}=1 did not put the joint step's stem on the kernel")
    sjoint = joint_step_phase(torch, sjpipe, {"pe_fwd": 4, "pe_bwd": 4,
                                              "stem": 1},
                              what="joint step, stem kernel")
    kern_on = sjoint["kernels"]
    stem_kernels = ("stem_split_kernel", "stem_wgrad_wgmma_kernel",
                    "stem_reduce_kernel")
    stem_dev = sum(kern_on[k]["ms"] for k in stem_kernels)
    wg_on, wg_off = kern_on["wgrad"], joint["kernels"]["wgrad"]
    print(f"joint step, stem kernel against the gate off (phase 10): "
          f"median {sjoint['ms_per_step']:.2f} vs {joint['ms_per_step']:.2f} "
          f"ms/step, device busy {sjoint['busy_ms_per_step']:.3f} vs "
          f"{joint['busy_ms_per_step']:.3f} ms a step; the stem kernel's "
          f"three device kernels {stem_dev:.4f} ms a step; cuDNN weight "
          f"gradients {wg_on['ms']:.3f} ms a step in {wg_on['launches']:g} "
          f"kernels vs {wg_off['ms']:.3f} in {wg_off['launches']:g}",
          flush=True)
    opipe = build_joint_pipeline(grid_res=128, tiny=False, device=dev, seed=0)
    turns = step_turns(torch, opipe, sjpipe)
    print(f"nvidia-smi clocks.sm,power.draw,power.limit,temp: "
          f"{smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    del sjpipe, opipe
    torch.cuda.empty_cache()

    # phase 18: the tiny f32 joint step with the gate on, card against CPU
    reset_counts()
    with stem_gate():
        tiny_joint_card_vs_cpu(torch, "tiny joint, stem kernel")
    tiny_stem = read_counts()["stem"]
    if tiny_stem != 3:
        fail(f"tiny joint, stem kernel: {tiny_stem} launches in 3 steps")

    # phase 19: the shifted-slice concat against torch.cat
    concat = concat_check(torch, dev)

    # phase 20: the eval paths of the joint pipeline, then the tiny f32
    # card-vs-CPU check
    t0 = time.perf_counter()
    evals = eval_phase(torch, dev)
    eval_card_vs_cpu(torch)
    print(f"phase 20: {time.perf_counter() - t0:.2f} s; the run so far "
          f"{time.perf_counter() - t_start:.2f} s", flush=True)
    print(f"nvidia-smi clocks.sm,power.draw,power.limit,temp: "
          f"{smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    gl_row = gl_rows[("soundspaces", 1024)]
    gl_bound, gl_by = gl_bound_ms(1024, 512, 78)
    main_bf16 = pe_rows["main_field"]["bf16"]
    fwd_bound, fwd_by = pe_fwd_bound_ms(
        (63, 256, 4, 16), 10, pe_rows["main_field"]["rows"])
    bwd_main = bwd_rows["main_field"]["bf16"]
    # the hash kernels' rows at the main path's points (a render chunk's,
    # a step's main field), every point set beside them
    h_r, h_t = hash_rows["render_path"], hash_rows["train_main_path"]
    h_sets = {"path_points": {k: r for k, r in hash_rows.items()
                              if k.endswith("_path")},
              "random_points": {k: r for k, r in hash_rows.items()
                                if not k.endswith("_path")}}
    kern = joint["kernels"]
    print(json.dumps({"kernels": [{
        "name": "griffin_lim", "route": "cuda",
        "source": "neraf_tpu_torch/csrc/griffin_lim.cu",
        "replaces": "neraf_tpu/ops/pallas/griffin_lim_kernel.py:148",
        "launches": launches, "max_abs_err": gl_row["err"],
        "ms": gl_row["ms"], "plain_ms": gl_row["plain_ms"],
        "bound_ms": gl_bound, "bound_by": gl_by, "library_ms": None,
        "max_abs_err_32_iter": gl_row["err32"], "plan": gl_row["plan"],
        "eval_sweep_launches": {
            k: evals[k]["gl_launches"]
            for k in ("evaluate_audio", "evaluate_audio_device")}}, {
        "name": "pe_mlp_fwd", "route": "cuda",
        "source": "neraf_tpu_torch/csrc/pe_mlp.cu",
        "replaces": "neraf_tpu/ops/pallas/fused_pe_mlp.py:373",
        "launches": vis_launches, "max_abs_err": main_bf16["max_abs_err"],
        "ms": main_bf16["ms"], "plain_ms": main_bf16["plain_ms"],
        "bound_ms": fwd_bound, "bound_by": fwd_by, "library_ms": None,
        "train_step_launches": joint["pe_fwd"], "shapes": pe_rows,
        "hash_render_launches": hvis["launches"]["pe_mlp"],
        "hash_train_step_launches": hjoint["pe_fwd"],
        "eval_launches": {k: evals[k]["pe_launches"] for k in (
            "eval_loss_dict", "eval_image", "query_grid_full")},
        "train_step_device_kernels": {"pe_mlp_bf16_kernel":
                                      kern["pe_mlp_bf16_kernel"]}}, {
        "name": "pe_mlp_bwd", "route": "cuda",
        "source": "neraf_tpu_torch/csrc/pe_mlp_bwd.cu",
        "replaces": "neraf_tpu/ops/pallas/fused_pe_mlp.py:298",
        "launches": joint["pe_bwd"], "max_abs_err": bwd_main["max_abs_err"],
        "rel_l2_vs_plain": bwd_rows["main_field"]["rel_l2_vs_plain"],
        "ms": bwd_main["ms"], "plain_ms": bwd_main["plain_ms"],
        "bound_ms": bwd_main["bound_ms"], "bound_by": bwd_main["bound_by"],
        "library_ms": None, "shapes": bwd_rows,
        "hash_train_step_launches": hjoint["pe_bwd"],
        # "launches" counts wrapper calls; each launches the row-tile kernel,
        # one dW kernel per layer and the reduction, a step's counts here
        "train_step_device_kernels": {
            k: kern[k] for k in ("pe_mlp_bwd_bf16_kernel", "pe_mlp_dw_kernel",
                                 "pe_mlp_reduce_kernel")}}, {
        "name": "hash_encoding_fwd", "route": "cuda",
        "source": "neraf_tpu_torch/csrc/hash_encoding.cu",
        "replaces": "neraf_tpu/ops/pallas/hash_gather_attempt.py:41",
        "launches": hvis["launches"]["hash_fwd"],
        "max_abs_err": h_r["max_abs_err"]["forward"], "ms": h_r["fwd_ms"],
        "plain_ms": h_r["fwd_plain_ms"], "bound_ms": h_r["fwd_bound_ms"],
        "bound_by": h_r["fwd_bound_by"], "library_ms": None,
        "train_step_launches": hjoint["hash_fwd"], **h_sets,
        "train_step_device_kernels": {
            "hash_encoding_fwd_kernel":
                hjoint["kernels"]["hash_encoding_fwd_kernel"]}}, {
        "name": "hash_encoding_bwd", "route": "cuda",
        "source": "neraf_tpu_torch/csrc/hash_encoding.cu",
        "replaces": "neraf_tpu/ops/pallas/hash_gather_attempt.py:41",
        "launches": hjoint["hash_bwd"],
        "max_abs_err": h_t["max_abs_err"]["d_table"],
        "max_abs_err_dx": h_t["max_abs_err"]["dx"], "ms": h_t["bwd_ms"],
        "plain_ms": h_t["bwd_plain_ms"], "bound_ms": h_t["bwd_bound_ms"],
        "bound_by": h_t["bwd_bound_by"], "library_ms": None,
        **h_sets, "table_costs": costs,
        "train_step_device_kernels": {
            k: hjoint["kernels"][k] for k in (
                "hash_encoding_bwd_kernel", "FillFunctor",
                "FusedAdamMathFunctor")}}, {
        "name": "stem_wgrad", "route": "cuda",
        "source": "neraf_tpu_torch/csrc/stem_wgrad.cu",
        "replaces": "neraf_tpu/ops/pallas/stem_wgrad_kernel.py:62",
        "launches": sjoint["stem"],
        "max_abs_err": stem_rows["step"]["bf16"]["max_abs_err"],
        "ms": stem_rows["step"]["bf16"]["ms"],
        "plain_ms": stem_rows["step"]["bf16"]["plain_ms"],
        "bound_ms": stem_rows["step"]["bf16"]["bound_ms"],
        "bound_by": stem_rows["step"]["bf16"]["bound_by"],
        "library_ms": stem_rows["step"]["bf16"]["library_ms"],
        "shapes": stem_rows, "tiny_step_launches": tiny_stem,
        "train_step_device_kernels": {k: kern_on[k] for k in (*stem_kernels,
                                                              "wgrad")},
        "gate_off_train_step_device_kernels": {"wgrad": wg_off},
        "train_step_ms": {"gate_on": sjoint["ms_per_step"],
                          "gate_off": joint["ms_per_step"]},
        "train_step_busy_ms": {"gate_on": sjoint["busy_ms_per_step"],
                               "gate_off": joint["busy_ms_per_step"]},
        "train_step_turns": turns,
        "cudnn_stem_conv_7_vs_8_channels": stem_conv_rows,
        "gate_off_resnet_ms": joint["stem_ms"],
        "gate_on_resnet_ms": sjoint["stem_ms"]}, {
        "name": "shifted_value_concat", "route": "cuda",
        "source": "neraf_tpu_torch/csrc/shifted_concat.cu",
        "replaces": "neraf_tpu/ops/pallas/gl_crash_repro.py:48",
        # on no path: the launches are phase 19's own calls
        "launches": concat["launches"], "max_abs_err": 0.0,
        "ms": concat["ms"], "plain_ms": concat["plain_ms"],
        "bound_ms": concat["bound_ms"], "bound_by": "bytes",
        "library_ms": concat["plain_ms"]}]}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
