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
     kernel launch counter read around the run; then each request's stages
     timed (the grid feature, whose s2d stem folds the grid, beside its
     first device kernels and any on f32 operands);
  5. the tiny slice in float32 on the card against the same slice on the CPU;
  6. the fused PE+MLP kernel against pe_mlp_plain on the card, in bf16 and
     f32, at the proposal-0 shape (8,388,608 rows, 39 -> 128 -> 128 -> 1)
     and the main field's (1,572,864 rows, 63 -> 256 x 4 -> 16), timed in
     turns with the plain chain beside its bound and its share of it; then
     the colour-branch kernel (ops/cuda/field_head.py) on the main field's
     head (63 -> 64 x 3 -> 3) against field_head_plain in bf16, at a render
     chunk (32,768 rays x 48 samples) and a bake batch (73,728 rows, S 1),
     timed the same way;
  7. the full-width vision slice: a 512 x 512 synthetic SoundSpaces view
     (hfov 90 degrees, 8 chunks of 32,768 rays) through render_image three
     times (the first pays the cold start) and a second view once, then
     evaluate_vision over both views, with the launch counters read around
     the run (3 pe_mlp and 1 field_head launches a chunk); then a
     per-chunk breakdown of one more image;
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
     the pre-folded grid state equal to the fold of the flat grid, bitwise;
     then 3 steps under torch.profiler (device busy time, idle share, the
     PE+MLP wrappers' device kernels a step, and the stem's device kernels
     a step, read from its forward and backward ranges, none on f32
     operands) and the ResNet over the folded state timed alone;
 11. the tiny joint step in float32 on the card against the same step on
     the CPU with its fields in float64 and on a float32 CPU pipeline, from
     the same weights and draws, all on the pre-folded grid path; the
     ReLU kinks between the card and each reference printed, and the
     tensors upstream of one held by the other reference;
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
     phase 7: 1 hash forward, 2 pe_mlp and 1 field_head launches a chunk;
 14. the full-width hash joint step as phase 10: 2 hash forward + 2 hash
     backward and 2 + 2 pe_mlp launches a step, the table changed, the
     hash kernels' device time a step, and the table's zeroed gradient and
     its two Adam updates timed alone;
 15. the tiny hash joint step (4 levels, 2^10 rows, resolutions 4-32) card
     against CPU as phase 11, at 2 and at 4 features a level;
 16. the folded stem at the step's shape (a 7 x 128^3 grid, folded to 56 x
     64^3, bf16): the fold of the flat grid, cuDNN's folded conv forward,
     its weight gradient (the gate-off path) and its full-volume input
     gradient, and StemConvBaked's slab input gradient, each timed beside
     its bound with its device kernels named; the s2d stem's forward
     against the direct conv in float64 (f32 and bf16), and the slab input
     gradient against the full-volume input gradient restricted to the
     slab (f32 and bf16, a slab inside the volume and one at its corner);
     then the stem weight-gradient kernel on the folded volume against
     stem_wgrad_folded_plain in float64 on the same inputs, bf16 and f32,
     two calls bitwise equal, at the step's shape (xf 56 x 64^3, g 64 x
     64^3), a small cube and two D != H != W volumes (one with 8 input
     channels), timed at each beside the plain version and cuDNN's weight
     gradient of the folded conv, with its three device kernels' times;
 17. the full-width fourier joint step as phase 10 with
     NERAF_STEM_WGRAD_PALLAS=1: exactly one stem-kernel launch a step (and
     none in phases 10 and 14), its ms per step, device busy time and the
     stem kernel's three device kernels a step beside cuDNN's weight-gradient
     kernels and the stem's device kernels a step, against phase 10's run
     with the gate off in the same call (both profiles also list any cuDNN
     kernel on f32 operands, "f32f32"); then steps of a gate-off and the
     gate-on pipeline in turns;
 18. the tiny f32 joint step with the gate on, card against CPU, as phase
     11 (the card's stem weight gradient from the f32 kernel on the folded
     volume, the CPU's from the plain version);
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
     f32 eval_loss_dict and the GT estimates, card against CPU;
 21. the CLIs at full width (SoundSpaces office_4's default configuration)
     on a scene written to a temporary directory by data/synthetic.py (96
     + 8 synthetic RIR pairs, the sphere's 12 views of 64 x 64, 2 of them
     eval views): cli.train for 8 steps with every cadence firing (log 2,
     eval batch and image 4, eval all 8, save 4, audio from step 3), its
     run directory checked (config.yml, metrics.jsonl's records, finite,
     checkpoints at steps 4 and 8, eval_images/*.png), its steps', evals'
     and saves' times printed; step 4's checkpoint loaded into a fresh
     bundle and saved again, bitwise equal; two --load-dir resumes from
     step 4 to 8, each model's difference from the straight run beside the
     two resumes' own (printed, not gated); cli.evaluate on the run's config.yml with the
     JAX CLI's result keys, finite; then --audio-only (w_field 512,
     grid-free) for 8 steps and its evaluate. Each run's pe_mlp and GL
     launches are gated: 4 + 4 a step plus 3 an eval batch, eval image
     and eval view, 1 GL launch for the on-device eval sweep, 2 for each
     host sweep;
 22. the serving and tool entry points on phase 21's run directory, each
     run's launches gated: cli.render over the eval views (3 pe_mlp
     launches a 4,096-ray view), each PNG and depth map bitwise the
     pipeline's own render_image; a 2-step hash run (2 + 2 hash and 2 + 2
     pe_mlp launches a step) and cli.render on it (1 hash + 2 pe_mlp a
     view); cli.loudness at 48 x 48 (2,304 RIRs in one sweep, no GL and no
     pe_mlp launch), the map finite and its PNG 512 x 512, and the sweep
     timed alone; a 16-pose trajectory (its 32 channels through one GL
     launch, then a 3 s moving-listener track, card against CPU); the
     standalone viewer (cli.viewer, port 0), twice (cold, then warm): /,
     three /render at 128 x 128 and one at 512 x 512 (3 and 24 pe_mlp),
     three /rir (one with a source override) and a POST /auralize of a 5 s
     dry WAV at 44.1 kHz (1 GL each), /state, each status, content type,
     payload and wall time, then the requests' stages timed on the
     viewer's pipeline; kernel #1 at 2 and 32 channels against
     griffin_lim_plain under phase 3's gates, timed beside its bound;
     cli.train --viewer-port 0 for 8 steps with a client's /render, /rir
     and /state answered during the run, its step-8 checkpoint against
     phase 21's run without the viewer beside a second run without it
     (the card's run-to-run spread); process_scene on 96 seeded
     binaural wavs at 44.1 kHz on the card, timed, each spectrogram held
     to process_rir_wav on the CPU;
 23. the streaming audio path and LPIPS: the StreamingAudioSampler at
     apartment_1's train-split shapes (111,513 recordings x 2 x 257 x 101,
     a lazily backed time-major host store whose first 16 batches' columns
     are written, batches of 2,048 in bf16): every batch within 2^-8 of
     the store, the device memory the audio data commits under 32 MiB
     (the resident split: 21.6 GiB), the producer's gather and the copies'
     device ms; the full-width joint step at apartment_1's configuration
     (T 101) fed by the sampler beside the same step fed by the resident
     split (on the card) at the same draws, float32 transfer, the losses
     bitwise equal; both timed in turns (median of 10 warm steps, the
     streamed one in bf16) and profiled (device busy, idle share, the
     share of the sampler's copies that overlaps a kernel), 4 + 4 pe_mlp
     launches a step; cli.train --streaming on (joint, 8 steps with every
     cadence, and --audio-only) on phase 21's scene with phase 21's gates
     on records and launches, one sampler a run on the card and stopped;
     LPIPS (random alex and vgg weights through an .npz) on a 512 x 512
     pair, card against CPU, ms per pair; cli.evaluate on phase 21's run
     with NERAF_LPIPS_WEIGHTS set, lpips a number;
 24. the default dataset, RAF, through the native C++ ingest: the library
     built with g++ (neraf_tpu_torch/native); a RAF scene written by
     data/synthetic.py at docs/DATA.md's scale rounded up (2,048 + 256
     RIRs at 48 kHz of 0.2-1.5 s, the sphere's 12 views of 64 x 64); both
     splits loaded natively and through the Python path, timed, the arrays
     held to each other at the CPU tests' bounds, no file falling back;
     process_scene on 2,048 binaural 44.1 kHz wavs natively and through
     the Python path on the card, timed, held to each other; cli.train at
     default_config("RAF", "FurnishedRoom") uncut (resnet50 over 7 x
     128^3, 513 bins, T 60, mono, 4,096 rays) for 8 steps with phase 21's
     cadences, records and launch gates (the PE+MLP forward and backward
     in the step, GL at n_fft 1024 in the eval sweep), the median warm
     step, then 3 steps of its pipeline on its data under torch.profiler
     (device busy, idle share) and its peak memory; cli.evaluate on the
     run with the JAX RAF evaluator's keys, its launches gated;
 25. (inside phase 24) the stem's max pool, the port's joint 3^3 pool
     against the JAX package's default separable layout (three 1-D pools,
     a yardstick written here) at the stem's output of the folded 128^3
     state (1, 64, 64^3) in bf16, fwd + bwd timed in turns, values equal;
 26. the data mesh (parallel/sharding.py, parallel/depth_split.py): the
     stem kernel on ranks' slabs of the step's folded volume (2 ranks'
     both slabs, 3 ranks' middle one) against its plain version in float64
     and cuDNN's weight gradient on the same slab, the 2 slabs summed
     against the whole volume's, each timed; then two ranks on card 0 over
     gloo (this process and one spawned) against one rank, the full-width
     joint step in bf16 on the bench.py inputs with the audio branch live,
     each step from the one rank's state at the same global draws: the
     ResNet split by depth, 3 steps with the stem kernel's gate off and 3
     with it on (losses every step; the feature, the BatchNorm statistics
     and the step-0 gradients gated against the one rank's), then whole
     on every rank, 2 steps for its stage times (its gradients held to
     the one rank's by relative L2 alone), then one split step in
     float32 against the one rank's float32 step (the feature, the
     BatchNorm statistics and the ResNet gradients from one cotangent
     to a share of their peak, the rest end to end), and ResNet3D-50
     alone in float64 over a random volume, split against whole (the
     features, statistics and every gradient); the replicated state
     bitwise equal across ranks after every step, 4 + 4 PE+MLP launches a
     step on each rank (and 1 stem launch with the gate on), each rank's
     ms a step, the gradient all_reduce's ms and the resnet_forward and
     backward stages split against whole; then evaluate_audio_device on
     1,024 synthetic RIRs at chunks of 512, 2 ranks against the one rank
     from the ranks' eval feature at tests/test_parallel.py's bounds, the
     eval features held to each other, 2 GL launches on each rank; where
     the machine has more than one card, cli.train --num-devices 2 (and
     4) over NCCL on a scene as phase 21's, each save checking the ranks'
     state bitwise; with one card it prints that no multi-card run took
     place;
 27. the 2-D (data, model) mesh (parallel/sharding.py::make_mesh_2d, the
     acoustic field column-sharded over the model axis): first the pure
     model axis, (1, 2), two ranks on card 0 over gloo, the full-width
     field (in_dim 1187, 2,048 slices) forward and backward against one
     rank's whole field, float32 at tests/test_parallel.py's rtol 2e-4,
     atol 1e-5 (the gradients' atol of each tensor's peak; a tensor
     upstream of a leaky-ReLU kink printed, not gated) and bf16 by
     relative L2, with the sharded and whole field's ms, the all-gathers'
     ms and the per-rank field FLOPs printed; then (2, 2), four ranks on
     card 0 over gloo against one rank, the full-width joint step in bf16
     on the bench.py inputs with the audio branch live, the field sharded
     at min_dim 512 as the JAX dry run shards it and the ResNet split
     over the 2 data ranks, 3 steps each from the one rank's state: phase
     26's gates (losses every step, the step-0 gradients with the field's
     gathered, the feature and statistics, 4 + 4 PE+MLP launches a rank a
     step), the replicated state bitwise across the 4 ranks and each
     field shard across its data column after every step; then
     parallel/dryrun.py::dryrun_multichip(4) on card 0 over gloo, and over
     NCCL one card a rank where the machine has 4 cards (else it prints
     that it was skipped);
 28. (after phase 13) NeRAF's published radiance model,
     engine/factory.py::nerfacto_model_config (two hash proposal fields of
     5 x 2 with 2^17 rows, max_res 128 and 256; the 16 x 2 main grid; base
     32 -> 64 -> 16, head 63 -> 64 x 2 -> 3) at full width: the hash
     kernels against the plain version at its three grids and a render
     chunk's rows (8,388,608, 3,145,728 and 1,572,864) as phase 12 checks
     them; the colour kernel on its head (2 hidden layers) at a render
     chunk's rows and a bake batch's as phase 6 checks it; a 512 x 512 view through render_image as phase 13 (3 hash
     forward launches and 1 field_head launch a chunk, no PE+MLP) and its
     chunk breakdown; the full-width joint step on it as phase 14 (4 hash
     forward and 4 hash backward launches a step). Alone: a script that
     calls build.load() then chip_smoke.nerfacto_phase(torch, dev).

The last line of stdout is {"ok": true, "device": {...}}; the line before it
is the card's name and power limit, and the one before that lists the
kernels with their launch counts, errors and times.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

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
# The colour-branch kernel against field_head_plain on the same inputs
# (tests/test_torch_field_head.py's bounds): the kernel rounds where the
# plain chain's dense rounds, so they differ by the order of the f32 sums,
# which flips a bf16 rounding in a few rows: one bf16 step at the max, and
# no farther from the float32 chain than the bf16 chain beyond that step.
FH_BF16_STEP = 2.0 ** -8
# Tiny joint step, f32, card (f32 kernels) against the CPU (plain chains,
# the fields in float64), each step from the same state. Losses 1e-4
# relative, the interlevel and distortion terms also 1e-4 of the total
# (differences of f32 cumulative sums). Every gradient to TRAIN_GRAD_TOL of
# its tensor's peak (measured on an H100: 2.3e-4 at most), against the CPU
# with its fields in float64 and against a plain float32 CPU pipeline, but
# a tensor upstream of a kink between the card and one of them (a ReLU
# input that changes sign at the noise floor, relu_flips), which the other
# must hold. The CPU's fields run in float64 because positions enter the
# encoding at up to 2^8 turns, which the card's kernels reduce exactly and
# a float32 chain rounds by ~1e-4 rad. The grid and the BatchNorm
# statistics to 1e-4 of their peak.
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
# Phase 16's volumes for the stem kernel, folded (D, H, W) with the grid
# channels and a seed: the step's, a small cube, and two D != H != W (one
# with a zero 8th channel)
STEM_SHAPES = (("step", (64, 64, 64), 7, 16), ("cube", (8, 8, 8), 7, 17),
               ("asymmetric", (5, 17, 9), 8, 18),
               ("asymmetric_w", (5, 9, 17), 7, 19))
# The folded stem in bf16 against a reference on the same bf16 inputs,
# relative to the peak: the s2d stem's forward against the direct conv in
# float64, and the slab input gradient against cuDNN's full-volume input
# gradient (both round f32 sums of the same bf16 products to bf16 outputs,
# 2^-8 of a value at most, summed in another order); a wrong channel, tap
# or offset is O(1). In f32 (TF32 off) both are held to STEM_REL_TOL.
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


def field_head_check(torch, dev, field, rays, S, seed) -> dict:
    """Phase 6's colour-branch kernel (ops/cuda/field_head.py) on the
    field's head at `rays` directions of S samples each (average
    appearance, the render's) against field_head_plain on the card: within
    one bf16 step of the plain bf16 chain and no farther from the float32
    chain than it beyond that step (tests/test_torch_field_head.py's
    bounds); both timed in turns (plain, kernel, kernel, plain) beside the
    bound of the unpadded head's products and the bytes read and written."""
    from neraf_tpu_torch.ops.cuda.field_head import field_head_cuda
    from neraf_tpu_torch.utils.weight_cache import weights_fixed
    from neraf_tpu_torch.ops.field_head import field_head_plain

    gen = torch.Generator(device=dev).manual_seed(seed)
    G = field.config.geo_feat_dim
    d = torch.nn.functional.normalize(
        torch.randn((rays, 3), generator=gen, device=dev), dim=-1)
    base = torch.randn((rays, S, 1 + G), generator=gen, device=dev)
    d, cam = d[:, None].expand(rays, S, 3), torch.zeros(
        (rays, 1), dtype=torch.int64, device=dev).expand(rays, S)
    geo = base.to(torch.bfloat16)[..., 1:]  # the base output's view
    table, layers = field.appearance.weight.detach(), [
        (w.detach(), b.detach()) for w, b in field.head_layers()]
    plain = lambda dtype=torch.bfloat16: field_head_plain(
        d, geo, cam, table, layers, True, dtype)
    n = rays * S
    # the kernel as a render calls it: its weights packed once a scope
    with torch.inference_mode(), weights_fixed():
        kern = lambda: field_head_cuda(d, geo, cam, table, layers, True)
        got, p16, p32 = (f().double() for f in (
            kern, plain, lambda: plain(torch.float32)))
        err = float((got - p16).abs().max())
        errs = {"max_abs_err": err,
                "vs_f32": float((got - p32).abs().max()),
                "plain_bf16_vs_f32": float((p16 - p32).abs().max())}
        reps = 5
        p1, k1, k2, p2 = (cuda_ms(torch, f, reps)
                          for f in (plain, kern, kern, plain))
    ms_k, ms_p = (k1 + k2) / 2, (p1 + p2) / 2
    b_ms, b_by = field_head_bound_ms(layers, G, rays, S)
    print(f"field_head {n} rows (S {S}): {json.dumps(errs)}; kernel "
          f"{ms_k:.4f} ms [{k1:.4f}, {k2:.4f}] plain {ms_p:.4f} ms [{p1:.4f}, "
          f"{p2:.4f}]; bound {b_ms:.4f} ms ({b_by}), kernel at "
          f"{b_ms / ms_k:.1%} of it", flush=True)
    if not (err <= FH_BF16_STEP
            and errs["vs_f32"] <= errs["plain_bf16_vs_f32"] + FH_BF16_STEP):
        fail(f"field_head kernel disagrees with plain at {n} rows, S {S}: "
             f"{errs}")
    torch.cuda.empty_cache()
    return {"rows": n, "S": S, **errs, "ms": ms_k, "plain_ms": ms_p,
            "bound_ms": b_ms, "bound_by": b_by}


def field_head_bound_ms(layers, G: int, rays: int, S: int) -> tuple:
    """The colour branch's least time on rays x S rows, bf16: the unpadded
    head's products (2 in out a layer a row) at the bf16 peak, or the bytes
    at the memory rate, the larger: G geo features read and the rgb
    written a row, a direction (3 f32) read a ray."""
    n = rays * S
    flops = 2.0 * n * sum(w.shape[0] * w.shape[1] for w, _ in layers)
    nbytes = n * (G + layers[-1][0].shape[0]) * 2 + rays * 12
    return bound_ms(flops, nbytes)


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


def stage_ms() -> list:
    """The device ms of each stage of every train step in the span store
    (steps run inside profiling.recording(), which times each span with
    CUDA events) -> [{stage: ms}] a step, its stages the children of
    train.step without the "train." prefix."""
    from neraf_tpu_torch.utils import profiling

    records = profiling.spans()
    return [{c["name"].split(".", 1)[1]: c["device_ms"] for c in records
             if c["parent"] == step["id"]}
            for step in records if step["name"] == "train.step"]


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


# read_counts()'s keys: the kernel wrappers' launch counters
# (utils/profiling.py)
KERNEL_COUNTERS = {"pe_fwd": "kernel.pe_mlp_fwd", "pe_bwd": "kernel.pe_mlp_bwd",
                   "hash_fwd": "kernel.hash_fwd", "hash_bwd": "kernel.hash_bwd",
                   "stem": "kernel.stem_wgrad", "concat": "kernel.shifted_concat",
                   "gl": "kernel.griffin_lim", "fh": "kernel.field_head"}


def reset_counts() -> None:
    """Every counter, the kernel wrappers' launch counts among them, to 0."""
    from neraf_tpu_torch.utils import profiling

    profiling.reset_counters()


def read_counts() -> dict:
    """Every kernel wrapper's launch count."""
    from neraf_tpu_torch.utils import profiling

    c = profiling.counters()
    return {k: c.get(name, 0) for k, name in KERNEL_COUNTERS.items()}


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
    from neraf_tpu_torch.models.grid import fold_grid

    if pipe.grid_folded is None or not torch.equal(
            pipe.grid_folded, fold_grid(pipe.grid, pipe.grid_res,
                                        pipe.folded_dtype)):
        fail(f"{what}: the pre-folded grid is not the fold of the grid "
             f"after {steps} steps")
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
    from neraf_tpu_torch.utils import profiling

    profiling.clear()
    with profiling.recording():
        for _ in range(3):
            pipe.train_step(cams, audio, images)
    per = stage_ms()
    parts = {k: float(np.mean([d[k] for d in per])) for k in per[0]}
    print(f"{what} breakdown, mean of 3 steps (ms, CUDA events): " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts.items()) + f"; sum {sum(parts.values()):.3f}",
        flush=True)
    kernels, busy, stem_kernels, _ = profile_steps(torch, pipe, cams, audio,
                                                images, what)
    return {"ms_per_step": ms, "cold_ms": times[0] * 1e3, **counts,
            "peak_gib": peak / 2**30, "parts": parts, "kernels": kernels,
            "busy_ms_per_step": busy, "stem_kernels": stem_kernels,
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


def range_kernels(events, name: str, n: int) -> dict:
    """The device kernels launched inside the profiler ranges called `name`
    (by the CPU ops under them) -> {kernel name: [launches, ms]} a step of
    n steps."""
    out = {}

    def walk(e):
        for k in e.kernels:
            row = out.setdefault(k.name[:100], [0, 0.0])
            row[0] += 1 / n
            row[1] += k.duration / 1e3 / n
        for c in e.cpu_children:
            walk(c)

    for e in events:
        if e.name == name:
            walk(e)
    return out


def stem_profile(events, what: str, n: int) -> dict:
    """The stem's device kernels a step from StemConvBaked's forward and
    backward ranges, printed; fatal if one runs on f32 operands
    ("f32f32") -> {"forward": .., "backward": .., "ms": total a step}."""
    from neraf_tpu_torch.ops.baked_stem import PROFILE_BACKWARD, PROFILE_FORWARD
    from neraf_tpu_torch.utils.profiling import PREFIX

    rows = {"forward": range_kernels(events, PREFIX + PROFILE_FORWARD, n),
            "backward": range_kernels(events, PREFIX + PROFILE_BACKWARD, n)}
    rows["ms"] = sum(v[1] for k in ("forward", "backward")
                     for v in rows[k].values())
    fmt = lambda d: "; ".join(f"{k} x{v[0]:g} {v[1]:.4f} ms"
                              for k, v in d.items())
    print(f"{what} profile: the stem's device kernels a step ({rows['ms']:.4f}"
          f" ms): forward: {fmt(rows['forward'])} | backward: "
          f"{fmt(rows['backward'])}", flush=True)
    if not rows["forward"] or not rows["backward"]:
        fail(f"{what}: no device kernel under the stem's profiler ranges")
    f32 = [k for part in ("forward", "backward") for k in rows[part]
           if "f32f32" in k]
    if f32:
        fail(f"{what}: the stem runs kernels on f32 operands: {f32}")
    return rows


def profile_steps(torch, pipe, cams, audio, images, what: str,
                  n: int = 3) -> tuple:
    """torch.profiler over n joint steps: the device's busy time (union of
    its kernels' intervals) against the host clock, the kernels with the
    most device time, and the launches and device ms a step of each of the
    wrappers' device kernels and of the zero fills and fused Adam ->
    ({kernel: {"launches": per step, "ms": per step}}, busy ms a step,
    the stem's device kernels a step (stem_profile), host ms a step)."""
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
    return found, busy / n, stem_profile(events, what, n), wall / n


def stem_timings(torch, pipe) -> dict:
    """The ResNet3D forward and forward + backward (its weights' gradients
    and the slab's) in train mode over the pipeline's pre-folded grid
    alone, the stem baked with the slab of the next cursor batch as a step
    takes it (the state already holds its values), CUDA events."""
    from neraf_tpu_torch.models.grid import folded_slab

    vol = pipe.grid_folded
    bake = pipe.config.trainer.grid_bake_cells_per_step
    pipe.resnet.set_update_stats(False)

    def resnet_fwd():
        fresh = pipe.grid[pipe.cursor:pipe.cursor + bake, :4].detach()
        slab = folded_slab(fresh.requires_grad_(), pipe.cursor, pipe.cells,
                           pipe.grid_res, vol.dtype)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            return pipe.resnet(vol, bake_slab=(*slab, False))

    def resnet_step():
        resnet_fwd().sum().backward()

    res = {}
    for k, f in (("forward", resnet_fwd), ("forward + backward", resnet_step)):
        cuda_ms(torch, f, 2)
        res[k] = cuda_ms(torch, f, 5)
    pipe.resnet.zero_grad(set_to_none=True)
    print(f"{pipe.resnet.backbone} train mode over the folded state "
          f"{tuple(vol.shape)}, bf16 (ms, CUDA events): " + ", ".join(
              f"{k} {v:.3f}" for k, v in res.items()), flush=True)
    return {f"resnet {k}": v for k, v in res.items()}


@contextlib.contextmanager
def relu_inputs(torch, modules: dict):
    """Record the input of every ReLU and LeakyReLU that `modules` ({label:
    module}) call with gradients on -> a list of (label, input on the CPU,
    the input's grad_fn), in call order."""
    import torch.nn.functional as F
    from torch.overrides import TorchFunctionMode

    funcs, calls, where = {F.relu, torch.relu, F.leaky_relu}, [], [None]

    class Record(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if where[0] and func in funcs and torch.is_grad_enabled():
                calls.append((where[0], args[0].detach().cpu(),
                              args[0].grad_fn))
            return func(*args, **(kwargs or {}))

    hooks = []
    for label, mod in modules.items():
        hooks.append(mod.register_forward_pre_hook(
            lambda *_, label=label: where.__setitem__(0, label)))
        hooks.append(mod.register_forward_hook(
            lambda *_: where.__setitem__(0, None)))
    try:
        with Record():
            yield calls
    finally:
        for h in hooks:
            h.remove()


def leaf_names(fn, names: dict) -> set:
    """The names ({id(tensor): name}) of the leaf tensors that autograd
    node `fn` reaches: those whose gradient passes through its output."""
    out, seen, todo = set(), set(), [fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        var = getattr(node, "variable", None)
        if var is not None and id(var) in names:
            out.add(names[id(var)])
        todo.extend(n for n, _ in node.next_functions)
    return out


def relu_flips(torch, card, ref, names, what) -> tuple:
    """The kinks between the card's and a reference's run of one step
    (relu_inputs' records): the units of a ReLU or LeakyReLU whose input
    has a different sign on the two sides. A flipped unit passes its whole
    gradient on one side and none (or a tenth) on the other, so every
    tensor upstream of it may move by far more than the rounding that
    flipped it. A flip at an input further than TRAIN_LOSS_RTOL of the
    input's peak from 0 is no kink and fails -> (printable lines, the names
    of the tensors whose gradient passes through a flipped unit, from the
    reference's graph)."""
    if [(a, x.shape) for a, x, _ in card] != [(a, x.shape) for a, x, _ in ref]:
        fail(f"{what}: the card and the CPU called different ReLUs")
    lines, below = [], set()
    for i, ((label, xc, _), (_, xr, fn)) in enumerate(zip(card, ref)):
        flip = (xc > 0) != (xr > 0)
        n = int(flip.sum())
        if not n:
            continue
        near = float(torch.maximum(xc.double().abs(),
                                   xr.double().abs())[flip].max())
        peak = float(xr.abs().max())
        if near > TRAIN_LOSS_RTOL * peak:
            fail(f"{what}: {label} ReLU {i} {tuple(xr.shape)} flips {n} "
                 f"units at |input| up to {near:.3e} of a peak {peak:.3e}")
        up = leaf_names(fn, names)
        below |= up
        lines.append(f"{label} ReLU {i} {tuple(xr.shape)}: {n} units, "
                     f"|input| <= {near:.2e} (peak {peak:.2e}), its gradient "
                     f"reaching {len(up)} tensors")
    return lines, below


def tiny_joint_card_vs_cpu(torch, what: str = "tiny joint", config=None):
    """Phases 11, 15 and 18: three tiny f32 steps on the card and on two
    CPU references from the same weights and draws, each step from the
    first reference's state, at the tiny configuration or `config`. The
    first computes the fields' MLPs (proposals and main field) in float64,
    so that the fourier encoding's angles, up to 2^8 turns, are exact as
    the card's kernels reduce them; the second is a plain float32 CPU
    pipeline. Every gradient is held to TRAIN_GRAD_TOL of its peak against
    both, except a tensor upstream of a kink (relu_flips) between the card
    and that reference at that step; such a tensor must be held by the
    other reference, and each exemption is printed with its kinks."""
    from neraf_tpu_torch.data.loader import audio_arrays
    from neraf_tpu_torch.data.vision_data import camera_arrays, synthetic_cameras
    from neraf_tpu_torch.engine.factory import build_joint_pipeline
    from neraf_tpu_torch.models.grid import fold_grid

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
    refs = ("cpu", "cpu_f32")
    worst = {d: {} for d in refs}

    def params(p):
        return {**{f"field.{k}": t for k, t in
                   p.vision_model.field.named_parameters()},
                **{f"proposal_networks.{k}": t for k, t in
                   p.vision_model.proposal_networks.named_parameters()},
                "camera_opt": p.vision_model.camera_opt,
                **{f"audio.{k}": t for k, t in p.audio_model.named_parameters()},
                **{f"resnet.{k}": t for k, t in p.resnet.named_parameters()}}

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
        m, calls = {}, {}
        for d, p in on.items():
            with relu_inputs(torch, {"resnet": p.resnet,
                                     "audio": p.audio_model}) as calls[d]:
                m[d] = p.train_step(*data[dev[d]], draws=draws)
        for k, v in m["cpu"].items():
            atol = (TRAIN_LOSS_RTOL * m["cpu"]["total_loss"]
                    if k in ("interlevel_loss", "distortion_loss") else 0.0)
            if not abs(m["cuda"][k] - v) <= TRAIN_LOSS_RTOL * abs(v) + atol:
                fail(f"{what} step {step}: {k} card {m['cuda'][k]} vs "
                     f"cpu {v}")
        g = {d: {k: t.grad.cpu() for k, t in params(p).items()}
             for d, p in on.items()}
        err, over, kinked = {}, {}, {}
        for d in refs:
            names = {id(t): k for k, t in params(on[d]).items()}
            lines, kinked[d] = relu_flips(torch, calls["cuda"], calls[d],
                                          names, f"{what} step {step}")
            for line in lines:
                print(f"{what} step {step}, kink card vs {d}: {line}",
                      flush=True)
            err[d] = {k: float((g["cuda"][k] - r).abs().max()
                               / r.abs().max().clamp_min(1e-30))
                      for k, r in g[d].items()}
            over[d] = {k for k, e in err[d].items() if e > TRAIN_GRAD_TOL}
            for k, e in err[d].items():
                worst[d][k] = max(worst[d].get(k, 0.0), e)
        fmt = lambda d, ks: ", ".join(f"{k} {err[d][k]:.3e}"
                                      for k in sorted(ks))
        for d, o in zip(refs, refs[::-1]):
            if over[d] - kinked[d]:
                fail(f"{what} step {step}: gradients differ card vs {d} "
                     f"(tol {TRAIN_GRAD_TOL}): {fmt(d, over[d] - kinked[d])}")
            if over[d] & over[o]:
                fail(f"{what} step {step}: gradients held by neither "
                     f"reference: {fmt(d, over[d] & over[o])}")
            if over[d]:
                print(f"{what} step {step}: beyond tol against {d} only "
                      f"upstream of its kinks: {fmt(d, over[d])}; against "
                      f"{o}: {fmt(o, over[d])}", flush=True)
        stats = {d: {k: v.cpu() for k, v in p.resnet.state_dict().items()
                     if "running" in k} for d, p in on.items()}
        for d, p in on.items():
            if p.grid_folded is None or not torch.equal(
                    p.grid_folded, fold_grid(p.grid, 32, p.folded_dtype)):
                fail(f"{what} step {step}: the {d} pipeline is not on the "
                     "pre-folded grid path")
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
          f"largest {fmt(top['cpu'])}; card vs a float32 CPU pipeline: "
          f"largest {fmt(top['cpu_f32'])} (tol {TRAIN_GRAD_TOL} against "
          f"both but upstream of a kink); grid and BN statistics within "
          f"1e-4", flush=True)
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


def nerfacto_phase(torch, dev) -> dict:
    """Phase 28: NeRAF's published radiance model at full width
    (factory.nerfacto_model_config: two hash proposal fields of 5 x 2, the
    16 x 2 main grid, the published depths). The hash kernels against the
    plain version at its three grids and a render chunk's rows (a proposal
    field's 32,768 x 256 and 32,768 x 96, the main field's 32,768 x 48);
    the colour kernel on its head (2 hidden layers) at a render chunk's
    rows and a bake batch's (S 1), as phase 6 checks it; a 512 x 512 view through render_phase, gated at 3 hash forward
    launches and one colour-kernel launch a chunk and no PE+MLP, with the
    chunk's breakdown; then the full-width joint step on it, gated at 4
    hash forward and 4 backward launches a step (both proposals, the main
    field, the bake)."""
    from neraf_tpu_torch.configs.config import ExperimentConfig
    from neraf_tpu_torch.data.vision_data import camera_arrays, synthetic_cameras
    from neraf_tpu_torch.engine import factory

    vcfg = factory.nerfacto_model_config()
    cfg = ExperimentConfig(dataset="SoundSpaces")
    cfg.vision_model = vcfg
    vpipe = factory.build_vision_pipeline(device=dev, seed=0, config=cfg)
    model = vpipe.vision_model
    rays = vcfg.eval_num_rays_per_chunk
    rows = {f"proposal_{k}": hash_check(torch, dev, f"nerfacto proposal {k}",
                                        prop.hash.spec, rays * n, 30 + k)
            for k, (prop, n) in enumerate(zip(model.proposal_networks,
                                              vcfg.num_proposal_samples))}
    rows["main"] = hash_check(torch, dev, "nerfacto main field",
                              model.field.hash.spec,
                              rays * vcfg.num_nerf_samples, 32)
    # the colour kernel on this head (2 hidden layers), at phase 6's bounds
    fh = {"render_chunk": field_head_check(torch, dev, model.field, rays,
                                           vcfg.num_nerf_samples, 33),
          "bake_batch": field_head_check(torch, dev, model.field, 4096 * 18,
                                         1, 34)}
    H = W = 512
    arrays = camera_arrays(synthetic_cameras(8, H, W, hfov_deg=90.0, seed=0), dev)
    n_chunks = -(-H * W // rays)
    print(f"nerfacto vision: full-width model (proposals "
          f"{[p.hash.spec.resolutions().tolist() for p in model.proposal_networks]}"
          f", main grid L{vcfg.num_levels} x F{vcfg.features_per_level}, base "
          f"{vcfg.hidden_layers} x {vcfg.hidden_dim}, head "
          f"{vcfg.hidden_layers_color} x {vcfg.hidden_dim_color}, "
          f"{model.field.dtype}), {H} x {W} view, {n_chunks} chunks of {rays} "
          f"rays", flush=True)
    vis = render_phase(torch, vpipe, arrays, H, W, "nerfacto vision")
    want = {k: 0 for k in vis["launches"]}
    want.update({"hash_fwd": 3 * n_chunks * vis["n_images"],
                 "fh": n_chunks * vis["n_images"]})
    if vis["launches"] != want:
        fail(f"nerfacto vision path: launches {vis['launches']}, expected {want}")
    parts, n_timed = chunk_breakdown(torch, vpipe, arrays, H, W)
    print(f"nerfacto vision breakdown, mean of {n_timed} chunks (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts.items()), flush=True)
    del vpipe, model
    torch.cuda.empty_cache()
    jcfg = factory.joint_config()
    jcfg.vision_model = vcfg
    jpipe = factory.build_joint_pipeline(grid_res=128, device=dev, seed=0,
                                         config=jcfg)
    joint = joint_step_phase(torch, jpipe, {"hash_fwd": 4, "hash_bwd": 4},
                             what="nerfacto joint step", stem=False)
    del jpipe
    torch.cuda.empty_cache()
    return {"hash": rows, "field_head": fh, "render": vis, "breakdown": parts,
            "joint": joint}


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


def stem_bound_ms(xf, g) -> tuple:
    """The least time of the stem weight gradient from the folded volume
    xf (1, D, H, W, 8 cin): the direct conv's products (2 cout cin 125 per
    output voxel; the folded conv's 91 zero taps a channel are no work of
    the function) at the peak rate of xf's type, against the bytes of xf,
    g and the f32 dW."""
    cin, cout = xf.shape[-1] // 8, g.shape[1]
    flops = 2.0 * cout * cin * 125 * g[0, 0].numel()
    nbytes = (xf.numel() + g.numel()) * xf.element_size() + cout * cin * 125 * 4
    rate = H100_BF16 if xf.element_size() == 2 else H100_F32
    t_ops, t_bytes = flops / rate, nbytes / H100_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def bound_ms(flops: float, nbytes: float) -> tuple:
    """max(bf16 operations at the peak, bytes at the memory rate), in ms,
    and which of the two it is."""
    t_ops, t_bytes = flops / H100_BF16, nbytes / H100_BYTES
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


def rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    return float((got.double() - want.double()).abs().max()
                 / max(float(want.double().abs().max()), 1e-30))


def stem_folded(torch, dev, R: int = 128, bake: int = 4096) -> dict:
    """Phase 16, the folded stem at the step's shape: a random f32 grid of
    R^3 cells, folded to (1, R/2, R/2, R/2, 56) bf16 as the pipeline folds
    it, the stem weight (64, 7, 5, 5, 5) and a cotangent of the conv's
    output in channels_last_3d. Timed (CUDA events, each beside its bound
    and with its device kernels): the fold of the flat grid; cuDNN's folded
    conv forward, its weight gradient (the gate-off path) and its
    full-volume input gradient; StemConvBaked's slab input gradient at the
    step's slab (B = bake cells: (1, 1, B/2R, R/2, 28)). Checked: the s2d
    stem (ResNet3D.stem) against the direct conv in float64, f32 (TF32 off)
    to STEM_REL_TOL and bf16 to STEM_CONV_BF16_TOL of the peak; the slab
    input gradient against the full-volume input gradient restricted to the
    slab, at a slab inside the volume and at its corner, f32 to
    STEM_REL_TOL and bf16 to STEM_CONV_BF16_TOL (both round f32 sums of
    the same bf16 products to bf16)."""
    import torch.nn.functional as F

    from neraf_tpu_torch.models.grid import cell_centers, fold_grid, folded_slab
    from neraf_tpu_torch.models.resnet3d import ResNet3D
    from neraf_tpu_torch.ops.baked_stem import slab_input_grad
    from neraf_tpu_torch.ops.stem_wgrad import fold_weight

    torch.backends.cudnn.allow_tf32 = False
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(160)
    grid = torch.rand((R ** 3, 7), generator=gen, device=dev)
    w = 0.05 * torch.randn((64, 7, 5, 5, 5), generator=gen, device=dev)
    h = R // 2
    gy32 = torch.randn((1, 64, h, h, h), generator=gen, device=dev).contiguous(
        memory_format=torch.channels_last_3d)
    row = {}

    # the s2d stem against the direct conv, float64
    net = ResNet3D(backbone="resnet18").to(dev)
    with torch.no_grad():
        net.conv1.weight.copy_(w)
        vol = grid.reshape(1, R, R, R, 7)
        ref = F.conv3d(vol.permute(0, 4, 1, 2, 3).double(), w.double(), None,
                       2, 2)
        s32 = net.stem(vol)
        with torch.autocast("cuda", dtype=bf):
            s16 = net.stem(vol)
    e32 = rel_err(s32, ref)
    # the bf16 reference: the direct conv of the bf16-rounded inputs
    with torch.no_grad():
        ref16 = F.conv3d(vol.to(bf).permute(0, 4, 1, 2, 3).double(),
                         w.to(bf).double(), None, 2, 2)
    e16 = rel_err(s16, ref16)
    print(f"s2d stem forward against the direct conv in float64 at "
          f"{tuple(vol.shape)}: f32 rel {e32:.3e} (tol {STEM_REL_TOL}), bf16 "
          f"rel {e16:.3e} (tol {STEM_CONV_BF16_TOL}); output {s16.dtype} "
          f"{tuple(s16.shape)}", flush=True)
    if not (e32 <= STEM_REL_TOL and e16 <= STEM_CONV_BF16_TOL):
        fail(f"s2d stem forward differs from the direct conv: f32 {e32}, "
             f"bf16 {e16}")
    row["s2d_vs_direct_rel"] = {"f32": e32, "bf16": e16}
    del net, ref, ref16, s32, s16

    xf = fold_grid(grid, R, bf)
    wp = fold_weight(w.to(bf))
    gy = gy32.to(bf)
    xcl = xf.permute(0, 4, 1, 2, 3)
    conv_bwd = lambda g, x, mask: torch.ops.aten.convolution_backward(
        g, x, wp if x.dtype == bf else wp.float(), None, (1,) * 3, (1,) * 3,
        (1,) * 3, False, (0,) * 3, 1, mask)
    nb = 2  # bytes of bf16
    vox = h ** 3
    flops = 2.0 * 64 * 56 * 27 * vox  # the folded conv's products
    ny = bake // R
    slab_shape = (1, 1, ny // 2, h, 28)
    cells = torch.as_tensor(cell_centers(R), device=dev)
    cursor = (R // 2 + 1) * R * R + (R // 2) * R  # an odd plane, mid rows
    _, d0, h0, ch = folded_slab(torch.zeros((bake, 4), device=dev), cursor,
                                cells, R, bf)
    slab_flops = 2.0 * 28 * 64 * 27 * (ny // 2) * h
    slab_bytes = (64 * 3 * (ny // 2 + 2) * h + 28 * 64 * 27
                  + 28 * (ny // 2) * h) * nb
    runs = {
        "fold of the flat grid": (
            lambda: fold_grid(grid, R, bf),
            bound_ms(0.0, grid.numel() * 4 + xf.numel() * nb)),
        "folded conv forward": (
            lambda: F.conv3d(xcl, wp, None, 1, 1),
            bound_ms(flops, (xf.numel() + wp.numel() + gy.numel()) * nb)),
        "folded conv weight gradient (gate off)": (
            lambda: conv_bwd(gy, xcl, (False, True, False))[1],
            bound_ms(flops, (xf.numel() + gy.numel() + wp.numel()) * nb)),
        "folded conv full-volume input gradient": (
            lambda: conv_bwd(gy, xcl, (True, False, False))[0],
            bound_ms(flops, (xf.numel() + gy.numel() + wp.numel()) * nb)),
        "slab input gradient": (
            lambda: slab_input_grad(gy, wp, slab_shape, d0, h0, ch),
            bound_ms(slab_flops, slab_bytes)),
    }
    for k, (fn, (bound, by)) in runs.items():
        fn()
        t1, t2 = cuda_ms(torch, fn, 10), cuda_ms(torch, fn, 10)
        kern = device_kernels(torch, fn)
        row[k] = {"ms": (t1 + t2) / 2, "runs": [t1, t2], "bound_ms": bound,
                  "bound_by": by, "kernels": kern}
        print(f"stem, {k}, bf16, step's shape: {(t1 + t2) / 2:.4f} ms [{t1:.4f}"
              f", {t2:.4f}]; bound {bound:.4f} ms ({by}); device kernels "
              f"{kern}", flush=True)
        f32 = [n for n, _ in kern if "f32f32" in n]
        if f32 and k != "fold of the flat grid":
            fail(f"stem, {k}: cuDNN ran kernels on f32 operands: {f32}")

    # yardsticks off the path: the folded conv forward with 8 zero channels
    # (64 in all) and under cudnn.benchmark
    x64 = F.pad(xf, (0, 8)).permute(0, 4, 1, 2, 3)
    w64 = F.pad(wp, (0, 0, 0, 0, 0, 0, 0, 8))
    yard = {"64 channels": lambda: F.conv3d(x64, w64, None, 1, 1),
            "56 channels, cudnn.benchmark": runs["folded conv forward"][0]}
    for k, fn in yard.items():
        torch.backends.cudnn.benchmark = "benchmark" in k
        fn()
        t1, t2 = cuda_ms(torch, fn, 10), cuda_ms(torch, fn, 10)
        kern = device_kernels(torch, fn)
        row[f"yardstick: folded conv forward, {k}"] = {
            "ms": (t1 + t2) / 2, "runs": [t1, t2], "kernels": kern}
        print(f"stem yardstick (off the path): folded conv forward, {k}: "
              f"{(t1 + t2) / 2:.4f} ms [{t1:.4f}, {t2:.4f}]; device kernels "
              f"{kern}", flush=True)
    torch.backends.cudnn.benchmark = False
    del x64, w64

    # the slab gradient against the full-volume one restricted to the slab
    corner = folded_slab(torch.zeros((bake, 4), device=dev), 0, cells, R,
                         bf)[1:]
    for where, (sd0, sh0, sch) in (("inside", (d0, h0, ch)),
                                   ("corner", corner)):
        for dtype, tol in ((torch.float32, STEM_REL_TOL),
                           (bf, STEM_CONV_BF16_TOL)):
            g_t = gy32.to(dtype)
            full = conv_bwd(g_t, xcl.to(dtype), (True, False, False))[0]
            want = full[:, sch:sch + 28, sd0, sh0:sh0 + ny // 2].permute(
                0, 2, 3, 1).reshape(slab_shape)
            got = slab_input_grad(g_t, wp.to(dtype), slab_shape, sd0, sh0,
                                  sch)
            err = rel_err(got, want)
            tag = f"{where} {str(dtype)[6:]}"
            row[f"slab_vs_full_rel {tag}"] = err
            print(f"stem slab input gradient {tuple(got.shape)} at {where} "
                  f"(d0 {sd0}, h0 {sh0}, channels {sch}), {dtype}: rel "
                  f"{err:.3e} of the full-volume gradient's peak on the slab "
                  f"(tol {tol})", flush=True)
            if not err <= tol:
                fail(f"stem slab input gradient {tag} differs from the "
                     f"full-volume gradient: {err}")
    return row


def stem_check(torch, dev, name, shape, cin, seed) -> dict:
    """Phase 16 at one shape: the stem weight-gradient kernel on the folded
    volume (xf (1, D, H, W, 8 cin) the fold of a random grid volume of 7
    channels, or 8 with a zero 8th; g (1, 64, D, H, W) in channels_last_3d,
    as the folded conv's output cotangent arrives) against
    stem_wgrad_folded_plain in float64 on the same inputs, unfolded, bf16
    and f32, to STEM_REL_TOL of the peak, and a second call bitwise equal to
    the first; then the kernel, the plain version (float32 sums, unfolded)
    and cuDNN's weight gradient of the folded conv on the same inputs timed
    (plain, kernel, kernel, plain, cuDNN), and the kernel's three device
    kernels of one call."""
    import torch.nn.functional as F

    from neraf_tpu_torch.models.grid import fold_volume
    from neraf_tpu_torch.ops.cuda.stem_wgrad import stem_wgrad_cuda
    from neraf_tpu_torch.ops.stem_wgrad import (
        fold_weight,
        stem_wgrad_folded_plain,
        stem_wgrad_unfold,
    )

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(seed)
    x0 = torch.randn((1, *(2 * n for n in shape), 7), generator=gen,
                     device=dev)
    g0 = torch.randn((1, 64, *shape), generator=gen, device=dev)
    row = {"shape": list(shape), "cin": cin}
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        xf = fold_volume(F.pad(x0, (0, cin - 7)), dtype)
        g = g0.to(dtype).contiguous(memory_format=torch.channels_last_3d)
        got = stem_wgrad_cuda(xf, g)
        again = stem_wgrad_cuda(xf, g)
        ref = stem_wgrad_unfold(stem_wgrad_folded_plain(xf.double(),
                                                        g.double()))
        torch.cuda.synchronize()
        if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
            fail(f"stem wgrad {name} {tag}: shape {tuple(got.shape)} or not "
                 "finite")
        if not torch.equal(got, again):
            fail(f"stem wgrad {name} {tag}: two calls differ")
        err = float((got.double() - ref).abs().max())
        rel = err / float(ref.abs().max())
        wp = fold_weight(torch.zeros((64, cin, 5, 5, 5), dtype=dtype,
                                     device=dev))
        xc = xf.permute(0, 4, 1, 2, 3)
        cudnn = lambda: torch.ops.aten.convolution_backward(
            g, xc, wp, None, (1,) * 3, (1,) * 3, (1,) * 3, False, (0,) * 3,
            1, (False, True, False))
        reps = 10
        run_k = lambda: stem_wgrad_cuda(xf, g)
        run_p = lambda: stem_wgrad_unfold(stem_wgrad_folded_plain(xf, g))
        for f in (run_k, run_p, cudnn):
            f()
        p1, k1, k2, p2, c1 = (cuda_ms(torch, f, reps) for f in (
            run_p, run_k, run_k, run_p, cudnn))
        kern = device_kernels(torch, run_k)
        bound, by = stem_bound_ms(xf, g)
        ms_k, ms_p = (k1 + k2) / 2, (p1 + p2) / 2
        print(f"stem wgrad {name} xf {tuple(xf.shape)} g {tuple(g.shape)} "
              f"{tag}: max_abs_err {err:.3e}, rel {rel:.3e} vs float64 (tol "
              f"{STEM_REL_TOL}), two calls bitwise equal; kernel "
              f"{ms_k:.4f} ms [{k1:.4f}, {k2:.4f}] plain {ms_p:.3f} ms "
              f"[{p1:.3f}, {p2:.3f}] cuDNN wgrad of the folded conv "
              f"{c1:.4f} ms; bound {bound:.4f} ms ({by}); device kernels "
              f"{kern}", flush=True)
        if not rel <= STEM_REL_TOL:
            fail(f"stem wgrad kernel disagrees with float64 at {name} {tag}: "
                 f"rel {rel}")
        row[tag] = {"max_abs_err": err, "rel_err": rel, "ms": ms_k,
                    "plain_ms": ms_p, "library_ms": c1, "bound_ms": bound,
                    "bound_by": by, "kernels": kern}
        del got, again, ref, xf, g, xc
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
    state["grid_folded"] = pipe.grid_folded.clone()
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
        lambda: pipe.eval_loss_dict(cams, audio, images),
        {"pe_fwd": 3, "fh": 1})
    if set(losses) != LOSS_KEYS | {"audio_mag"} or not all(
            np.isfinite(v) for v in losses.values()):
        fail(f"eval_loss_dict: {losses}")
    print(f"eval_loss_dict ({pipe.config.vision_data.eval_rays_per_batch} "
          f"rays, {pipe.config.audio_data.batch_size} slices): {dt * 1e3:.2f}"
          f" ms, launches {counts}; {json.dumps(losses)}", flush=True)
    res["eval_loss_dict"] = {"pe_launches": counts["pe_fwd"],
                             "fh_launches": counts["fh"], "ms": dt * 1e3}

    # eval_image: one 512 x 512 view and one RIR
    H, W = images["images"].shape[1:3]
    item = {"mic_pose": o.microphone_poses[0], "source_pose": o.source_poses[0],
            "rot": o.rotations[0], "data": ds.log_stft[0]}
    n_img_chunks = -(-H * W // pipe.config.vision_model.eval_num_rays_per_chunk)
    (metrics, imgs), counts, dt = counted(
        torch, "eval_image",
        lambda: pipe.eval_image(cams, 0, images["images"][0].cpu().numpy(),
                                eval_audio_item=item),
        {"pe_fwd": 3 * n_img_chunks, "fh": n_img_chunks})
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
    res["eval_image"] = {"pe_launches": counts["pe_fwd"],
                         "fh_launches": counts["fh"], "ms": dt * 1e3}

    # query_grid_full over every cell
    n_cells, batch = pipe.cells.shape[0], 4096
    grid, counts, dt = counted(
        torch, "query_grid_full", lambda: pipe.query_grid_full(batch),
        {"pe_fwd": n_cells // batch, "fh": n_cells // batch})
    if not (bool(torch.isfinite(grid).all()) and bool((grid[:, :3] > 0).all())
            and bool(((grid[:, 3] >= 0) & (grid[:, 3] <= 1)).all())
            and torch.equal(grid[:, 4:], pipe.grid[:, 4:])):
        fail("query_grid_full: a cell not written, or the coordinates moved")
    print(f"query_grid_full: {n_cells} cells in {n_cells // batch} batches of "
          f"{batch}: {dt:.3f} s, launches {counts}", flush=True)
    res["query_grid_full"] = {"pe_launches": counts["pe_fwd"],
                              "fh_launches": counts["fh"], "s": dt}

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


# Phase 21: the CLIs at full width on a scene read from disk. Every cadence
# fires within 8 steps; the audio branch is live from step 3.
CLI_STEPS = 8
CLI_SET = ("trainer.start_step_audio=2", "trainer.steps_per_log=2",
           "trainer.steps_per_eval_batch=4", "trainer.steps_per_eval_image=4",
           "trainer.steps_per_eval_all_images=8", "trainer.steps_per_save=4")
CLI_RECORDS = {(2, "train"), (4, "train"), (6, "train"), (8, "train"),
               (4, "eval_batch"), (8, "eval_batch"), (4, "eval_image"),
               (8, "eval_image"), (8, "eval_vision"), (8, "eval_audio")}
VISION_EVAL_KEYS = {"psnr", "ssim", "psnr_std", "num_rays_per_sec", "fps",
                    "lpips", "lpips_skipped"}
ENGINE_EVAL_KEYS = HOST_EVAL_KEYS | {"quick_audio_mag"}


def finite_record(rec: dict) -> bool:
    """Every number of a metrics record finite (EDT may be NaN on a
    degenerate prediction, as check_eval_dict allows)."""
    return all(np.isfinite(v) for k, v in rec.items()
               if isinstance(v, float) and not k.startswith("audio_EDT"))


def same_tree(torch, a, b, path="") -> list:
    """The paths at which two loaded checkpoints differ (tensors bitwise:
    dtype, shape and bytes; everything else by ==)."""
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return [f"{path}: keys {sorted(set(a) ^ set(b), key=str)}"]
        return [d for k in a for d in same_tree(torch, a[k], b[k], f"{path}/{k}")]
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return [f"{path}: lengths {len(a)} != {len(b)}"]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in same_tree(torch, x, y, f"{path}/{i}")]
    if torch.is_tensor(a) and torch.is_tensor(b):
        if a.dtype != b.dtype or a.shape != b.shape:
            return [f"{path}: {a.dtype}{tuple(a.shape)} != {b.dtype}{tuple(b.shape)}"]
        ab = a.contiguous().reshape(-1).view(torch.uint8)
        bb = b.contiguous().reshape(-1).view(torch.uint8)
        return [] if torch.equal(ab, bb) else [f"{path}: bytes differ"]
    return [] if type(a) is type(b) and a == b else [f"{path}: {a!r} != {b!r}"]


def group_gaps(torch, a: dict, b: dict) -> dict:
    """Per model of two checkpoints (and the grid): the largest difference
    of any of its tensors relative to that tensor's peak in b (`max_rel`),
    and ||a - b|| / ||b|| over all its tensors (`rel_l2`)."""
    def gaps(pairs):
        pairs = [(x.double(), y.double()) for x, y in pairs]
        return {"max_rel": max(float((x - y).abs().max()
                                     / y.abs().max().clamp_min(1e-30))
                               for x, y in pairs),
                "rel_l2": float(sum(((x - y) ** 2).sum() for x, y in pairs).sqrt()
                                / sum((y ** 2).sum() for _, y in pairs).sqrt())}

    out = {name: gaps([(t, b["models"][name][k]) for k, t in sd.items()
                       if t.is_floating_point()])
           for name, sd in a["models"].items()}
    out["grid"] = gaps([(a["grid"], b["grid"])])
    return out


def cli_phase(torch, dev, tmp) -> dict:
    """Phase 21: a SoundSpaces scene (96 + 8 synthetic RIR pairs, the
    sphere's 12 views of 64 x 64) written under `tmp`, then cli.train
    (joint, full width, 8 steps with every cadence, in tmp/run1), a
    checkpoint round trip, two --load-dir resumes from step 4, cli.evaluate,
    and the audio-only train and evaluate; the launch counts of each run
    gated."""
    from neraf_tpu_torch.cli import evaluate as cli_evaluate
    from neraf_tpu_torch.cli import train as cli_train
    from neraf_tpu_torch.configs.config import load_config
    from neraf_tpu_torch.data.synthetic import (
        write_soundspaces_scene,
        write_vision_scene,
    )
    from neraf_tpu_torch.engine.checkpoints import (
        restore_checkpoint,
        save_checkpoint,
    )
    from neraf_tpu_torch.engine.factory import build_pipeline

    t0 = time.perf_counter()
    scene = write_soundspaces_scene(tmp / "scenes", 96, 8, scene="office_4")
    n_views, n_eval = 12, 2
    write_vision_scene(scene, n_views=n_views, size=64)
    print(f"cli: scene written in {time.perf_counter() - t0:.2f} s "
          f"({scene}: 96 + 8 RIR pairs, {n_views} views of 64 x 64)",
          flush=True)
    base = ["--dataset", "SoundSpaces", "--scene", "office_4",
            "--data-root", str(tmp / "scenes"), "--max-iters",
            str(CLI_STEPS)]
    for item in CLI_SET:
        base += ["--set", item]
    res, counts = {}, {}

    # the joint run: 4 + 4 pe_mlp launches a step; eval_batch and
    # eval_image 3 each (4,096 rays, one chunk) at steps 4 and 8,
    # evaluate_vision 3 a view and evaluate_audio_device one GL launch
    # (8 RIRs, one chunk) at step 8
    run1 = tmp / "run1"
    want = {"pe_fwd": 4 * CLI_STEPS + 2 * 3 + 2 * 3 + 3 * n_eval,
            "pe_bwd": 4 * CLI_STEPS, "gl": 1, "fh": 2 + 2 + n_eval}
    trainer, counts["train"], wall = counted(
        torch, "cli train", lambda: cli_train.main(
            base + ["--run-dir", str(run1)]), want)
    ckpts = sorted(p.name for p in (run1 / "neraf_models").iterdir())
    pngs = sorted(p.name for p in (run1 / "eval_images").glob("*.png"))
    records = [json.loads(line) for line in
               (run1 / "metrics.jsonl").read_text().splitlines()]
    if not (run1 / "config.yml").is_file():
        fail("cli train: no config.yml")
    if ckpts != ["step-000000004.pt", "step-000000008.pt"]:
        fail(f"cli train: checkpoints {ckpts}")
    if not any(p.startswith("step_0000004_img") for p in pngs) or not any(
            p.startswith("step_0000008_comparison_ch_0") for p in pngs):
        fail(f"cli train: eval images {pngs}")
    got = {(r["step"], r["prefix"]) for r in records}
    if got != CLI_RECORDS or len(records) != len(CLI_RECORDS):
        fail(f"cli train: metrics records {sorted(got)}")
    bad = [r for r in records if not finite_record(r)]
    if bad:
        fail(f"cli train: metrics not finite {bad}")
    times = {}
    for step, what, dt in trainer.timings:
        times.setdefault(what, []).append(dt * 1e3)
    steps_ms = times.pop("step")
    res["train"] = {
        "wall_s": wall, "cold_step_ms": steps_ms[0],
        "warm_step_ms_median": float(np.median(steps_ms[1:])),
        "warm_step_ms": steps_ms[1:],
        "eval_ms": {k: v for k, v in times.items() if k != "save"},
        "save_ms": times["save"],
        "checkpoint_mb": (run1 / "neraf_models" / ckpts[0]).stat().st_size / 2**20,
        "launches": counts["train"]}
    print(f"cli train: {json.dumps(res['train'])}", flush=True)
    print(f"cli train metrics: {json.dumps(records)}", flush=True)
    del trainer
    torch.cuda.empty_cache()

    # the checkpoint round trip: step 4 into a fresh bundle, saved again
    cfg = load_config(run1 / "config.yml")
    pipe = build_pipeline(cfg, device=dev).pipeline
    step4 = run1 / "neraf_models" / "step-000000004.pt"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restore_checkpoint(step4, pipe)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = save_checkpoint(tmp / "again", 4, pipe)
    save_s = time.perf_counter() - t0
    load = lambda p: torch.load(p, map_location="cpu", weights_only=True)
    diffs = same_tree(torch, load(step4), load(again))
    print(f"cli checkpoint round trip: load {load_s * 1e3:.1f} ms, save "
          f"{save_s * 1e3:.1f} ms, {len(diffs)} differences", flush=True)
    if diffs:
        fail(f"cli checkpoint round trip: {diffs[:10]}")
    res["round_trip"] = {"load_ms": load_s * 1e3, "save_ms": save_s * 1e3}
    del pipe
    torch.cuda.empty_cache()

    # resume from step 4 into a new run directory, to step 8, twice:
    # the second resume is the yardstick of the card's run-to-run
    # differences (cuDNN's and the atomics' summation order)
    (tmp / "from4").mkdir()
    shutil.copy(step4, tmp / "from4" / step4.name)
    want = {"pe_fwd": 4 * 4 + 3 + 3 + 3 * n_eval, "pe_bwd": 4 * 4, "gl": 1,
            "fh": 1 + 1 + n_eval}
    name8, walls = "step-000000008.pt", []
    for run in ("run2", "run2b"):
        _, counts["resume"], wall = counted(
            torch, "cli resume", lambda: cli_train.main(
                base + ["--run-dir", str(tmp / run), "--load-dir",
                        str(tmp / "from4")]), want)
        walls.append(wall)
    resumed = load(tmp / "run2" / "neraf_models" / name8)
    gaps = {"resumed_vs_straight": group_gaps(
                torch, resumed, load(run1 / "neraf_models" / name8)),
            "resumed_vs_resumed": group_gaps(
                torch, resumed, load(tmp / "run2b" / "neraf_models" / name8))}
    print(f"cli resume from step 4 to 8: {walls[0]:.2f} s, {walls[1]:.2f} "
          f"s; step 8 against the straight run and against a second "
          f"resume, by model (not gated; the card's backward need not "
          f"be deterministic): {json.dumps(gaps)}", flush=True)
    res["resume"] = {"wall_s": walls, "gaps": gaps}

    # the eval CLI on the straight run's config.yml (its latest
    # checkpoint, step 8): 3 pe_mlp launches a view, 2 GL a chunk
    out_json = tmp / "results.json"
    results, counts["evaluate"], wall = counted(
        torch, "cli evaluate", lambda: cli_evaluate.main(
            ["--load-config", str(run1 / "config.yml"),
             "--output-path", str(out_json)]),
        {"pe_fwd": 3 * n_eval, "gl": 2, "fh": n_eval})
    saved = json.loads(out_json.read_text())
    if set(saved) != {"experiment_name", "method_name", "results"} or \
            set(saved["results"]) != HOST_EVAL_KEYS | VISION_EVAL_KEYS or \
            not finite_record(saved["results"]):
        fail(f"cli evaluate: results file {saved}")
    print(f"cli evaluate: {wall:.2f} s; {json.dumps(saved)}", flush=True)
    res["evaluate"] = {"wall_s": wall, "results": saved["results"]}

    # the audio-only run at full width (w_field 512, grid-free)
    run3 = tmp / "run3"
    trainer, counts["audio_only_train"], wall = counted(
        torch, "cli audio-only train", lambda: cli_train.main(
            base + ["--audio-only", "--run-dir", str(run3)]), {"gl": 2})
    records = [json.loads(line) for line in
               (run3 / "metrics.jsonl").read_text().splitlines()]
    # the Trainer's steps/s over each 2-step log window; the window
    # ending at step 6 also holds step 4's checkpoint save
    rates = {r["step"]: r["steps_per_sec"] for r in records
             if r["prefix"] == "train" and r["step"] > 2}
    if {(r["step"], r["prefix"]) for r in records} != {
            (2, "train"), (4, "train"), (6, "train"), (8, "train"),
            (8, "eval_audio")} or not all(map(finite_record, records)):
        fail(f"cli audio-only train: metrics {records}")
    evaluate_out, counts["audio_only_evaluate"], ewall = counted(
        torch, "cli audio-only evaluate", lambda: cli_evaluate.main(
            ["--load-config", str(run3 / "config.yml")]), {"gl": 2})
    check_eval_dict(evaluate_out, ENGINE_EVAL_KEYS, "cli audio-only evaluate")
    w = trainer.pipeline.model.config.w_field
    res["audio_only"] = {"wall_s": wall, "steps_per_s": rates,
                         "evaluate_s": ewall, "w_field": w}
    print(f"cli audio-only (w_field {w}, batch "
          f"{trainer.config.audio_data.batch_size}): train {wall:.2f} s, "
          f"steps/s by log step {json.dumps(rates)}; evaluate "
          f"{ewall:.2f} s: {json.dumps(evaluate_out)}", flush=True)
    res["launches"] = counts
    res["argv"], res["n_eval"] = base, n_eval
    return res


# Phase 22. The moving listener's track on the card against the same call
# on the CPU, relative to its peak: float32 FFTs of two libraries (cuFFT,
# pocketfft) summed over 16 overlapping hops; a wrong hop or channel is
# O(1). The preprocessed spectrograms, card against CPU, relative to each
# one's peak: the resampler's float32 conv (TF32 off) and the STFT summed in
# another order; a wrong tap or frame is O(1).
MLA_REL_TOL, PRE_REL_TOL = 1e-5, 1e-4
PRE_WAVS, SERVE_DRY_S, TRAJ_DRY_S, TRAJ_POSES = 96, 5.0, 3.0, 16


def http(url: str, data: bytes | None = None):
    """(status, content type, body) of one request (an error status too)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=data,
                                 method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def decode_body(tmp, ctype: str, body: bytes):
    """A response's payload: PNG -> (H, W, 3) uint8, WAV -> (fs, (L, C)
    float32), JSON -> dict, HTML -> str."""
    import io

    from scipy.io import wavfile

    from neraf_tpu_torch.utils.png import read_png

    if ctype == "image/png":
        (tmp / "response.png").write_bytes(body)
        return read_png(tmp / "response.png")
    if ctype == "audio/wav":
        return wavfile.read(io.BytesIO(body))
    if ctype == "application/json":
        return json.loads(body)
    return body.decode()


def dry_wav(seconds: float, fs: int, seed: int) -> np.ndarray:
    """Seeded dry audio: a decaying chirp under noise, in [-0.5, 0.5]."""
    t = np.arange(int(seconds * fs)) / fs
    rng = np.random.default_rng(seed)
    x = 0.4 * np.sin(2 * np.pi * (200 + 400 * t) * t) + 0.1 * rng.standard_normal(
        t.shape)
    return np.clip(x, -0.5, 0.5).astype(np.float32)


def render_cli_check(torch, dev, tmp, run, what: str, want: dict) -> dict:
    """cli.render on the run's eval views with its launches gated, then
    each PNG and depth map against the pipeline's own render_image of the
    view (restored from the same checkpoint), bitwise."""
    from neraf_tpu_torch.cli import render as cli_render
    from neraf_tpu_torch.configs.config import load_config
    from neraf_tpu_torch.data.vision_data import camera_arrays
    from neraf_tpu_torch.engine.checkpoints import latest_checkpoint, restore_checkpoint
    from neraf_tpu_torch.engine.factory import build_pipeline
    from neraf_tpu_torch.utils.png import quantize_rgb, read_png

    out_dir = tmp / f"render_{run.name}"
    _, counts, wall = counted(torch, what, lambda: cli_render.main(
        ["--load-config", str(run / "config.yml"), "--output-dir",
         str(out_dir)]), want)
    bundle = build_pipeline(load_config(run / "config.yml"), device=dev)
    restore_checkpoint(latest_checkpoint(run / "neraf_models"), bundle.pipeline)
    cams, ds = camera_arrays(bundle.vision_eval.cameras, dev), bundle.vision_eval
    H, W = ds.cameras.height, ds.cameras.width
    for i in range(len(ds.cameras)):
        ref = bundle.pipeline.render_image(cams, i, H, W)
        img = read_png(out_dir / f"render_{i:04d}.png")
        depth = np.load(out_dir / f"depth_{i:04d}.npy")
        if not (img.shape == (H, W, 3) and depth.dtype == np.float32
                and np.array_equal(img, quantize_rgb(ref["rgb"]))
                and np.array_equal(depth, ref["depth"].float().cpu().numpy())):
            fail(f"{what}: view {i} is not the pipeline's render_image")
    print(f"{what}: {len(ds.cameras)} views of {H} x {W} in {wall:.2f} s (the "
          f"pipeline's build and restore included), each bitwise the "
          f"pipeline's render_image; launches {counts}", flush=True)
    return {"wall_s": wall, "launches": counts, "views": len(ds.cameras)}


def viewer_requests(torch, tmp, run) -> dict:
    """The standalone viewer (cli.viewer on port 0) on the run: each
    request's status, content type, payload and launches gated, its wall
    time printed (the first render pays the cold start)."""
    import io

    from scipy.io import wavfile

    from neraf_tpu_torch.cli import viewer as cli_viewer
    from neraf_tpu_torch.configs.config import load_config

    acfg = load_config(run / "config.yml").audio_model
    n_rir = acfg.hop_len * (acfg.max_len - 1)
    server = cli_viewer.main(["--load-config", str(run / "config.yml"),
                              "--port", "0"], blocking=False)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        lo, hi = (np.asarray(v) for v in json.loads(http(f"{base}/state")[2])[
            "audio_aabb"])
        at = lambda f: "x={:.4f}&y={:.4f}&z={:.4f}".format(*(lo + (hi - lo) * f))
        src = "sx={:.4f}&sy={:.4f}&sz={:.4f}".format(*(lo + (hi - lo) * 0.7))
        fs_in = 44100
        buf = io.BytesIO()
        wavfile.write(buf, fs_in, dry_wav(SERVE_DRY_S, fs_in, 1))
        reqs = [("index", "/", None, "text/html", {}),
                *((f"render_128_{k}", f"/render?theta={0.8 * k:.1f}&phi=0.3"
                   "&radius=2&w=128&h=128", None, "image/png",
                   {"pe_fwd": 3, "fh": 1})
                  for k in range(3)),
                ("render_512", "/render?theta=0.4&phi=0.2&radius=2&w=512&h=512",
                 None, "image/png", {"pe_fwd": 24, "fh": 8}),
                ("rir_0", f"/rir?{at(0.3)}", None, "audio/wav", {"gl": 1}),
                ("rir_1", f"/rir?{at(0.6)}", None, "audio/wav", {"gl": 1}),
                ("rir_source", f"/rir?{at(0.3)}&{src}", None, "audio/wav",
                 {"gl": 1}),
                ("auralize", f"/auralize?{at(0.4)}", buf.getvalue(),
                 "audio/wav", {"gl": 1}),
                ("state", "/state", None, "application/json", {})]
        # two rounds of the same requests: the first pays each request
        # kind's first use on this pipeline, the second is warm
        out, payloads = {}, {}
        for rnd in ("cold", "warm"):
            for name, path, body, ctype, want in reqs:
                (status, got, payload), counts, wall = counted(
                    torch, f"viewer {name}", lambda: http(base + path, body),
                    want)
                if status != 200 or got != ctype:
                    fail(f"viewer {name}: {status} {got} {payload[:200]!r}")
                payloads[name] = decode_body(tmp, ctype, payload)
                out.setdefault(name, {"launches": counts, "bytes": len(payload)})
                out[name][f"{rnd}_ms"] = wall * 1e3
                print(f"viewer {name} ({rnd}): {status} {got}, "
                      f"{wall * 1e3:.2f} ms, {len(payload)} B, launches "
                      f"{counts}", flush=True)
        stages = viewer_stages(torch, server.backend, lo + (hi - lo) * 0.3,
                               dry_wav(SERVE_DRY_S, fs_in, 1), fs_in)
    finally:
        server.shutdown()
        server.server_close()
    for k in range(3):
        if payloads[f"render_128_{k}"].shape != (128, 128, 3):
            fail(f"viewer render_128_{k}: {payloads[f'render_128_{k}'].shape}")
    if payloads["render_512"].shape != (512, 512, 3):
        fail(f"viewer render_512: {payloads['render_512'].shape}")
    rirs = [payloads[k] for k in ("rir_0", "rir_1", "rir_source")]
    if not all(fs == acfg.fs and w.shape == (n_rir, acfg.mic_ch)
               and np.isfinite(w).all() and 0 < np.abs(w).max() <= 1
               for fs, w in rirs):
        fail(f"viewer rir: {[(fs, w.shape) for fs, w in rirs]}")
    if np.array_equal(rirs[0][1], rirs[2][1]):
        fail("viewer rir: the source override did not change the RIR")
    fs, wet = payloads["auralize"]
    n_wet = -(-int(SERVE_DRY_S * fs_in) * acfg.fs // fs_in) + n_rir - 1
    if fs != acfg.fs or wet.shape != (n_wet, acfg.mic_ch) or not np.isfinite(
            wet).all():
        fail(f"viewer auralize: {fs} Hz {wet.shape}, expected {n_wet} samples")
    state = payloads["state"]
    if set(state) != {"audio_aabb", "grid_res", "step"} or state[
            "step"] != CLI_STEPS:
        fail(f"viewer state: {state}")
    return {"requests": out, "stages_ms": stages}


def host_ms(torch, fn, reps: int = 3) -> float:
    """The median host ms of fn() to a synchronised device."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def viewer_stages(torch, backend, mic, dry, fs_in) -> dict:
    """The viewer's requests stage by stage on its own pipeline, warm, host
    ms to a synchronised device: /rir (the grid feature, render_rirs of one
    RIR, also on a new thread a call and on the backend's device thread,
    Griffin-Lim at 2 channels, the WAV), /render at 512 x 512
    (render_image, the PNG) and /auralize's own stages (the resample, the
    FFT convolutions, the WAV)."""
    import threading
    from neraf_tpu_torch.dsp.resample import resample_poly
    from neraf_tpu_torch.utils.png import encode_png, quantize_rgb
    from neraf_tpu_torch.viz.auralization import auralize, rir_from_log_stft
    from neraf_tpu_torch.viz.viewer import _orbit_camera

    pipe = backend.pipeline
    cfg = pipe.audio_model.config
    src = pipe.audio_aabb.mean(dim=0)[None]
    rot = np.array([[1.0, 0.5, 0.5]], np.float32)
    log = pipe.render_rirs(mic[None], src, rot)[0]
    gl = lambda: rir_from_log_stft(log, n_fft=cfg.n_fft, hop_len=cfg.hop_len,
                                   win_len=cfg.win_len,
                                   generator=torch.Generator().manual_seed(0))
    rir = gl()
    row = lambda v: torch.tensor([v], dtype=torch.float32, device=pipe.device)
    c2w = torch.as_tensor(_orbit_camera(0.4, 0.2, 2.0), device=pipe.device)
    cams = {"c2w": c2w[None], "fx": row(614.4), "fy": row(614.4),
            "cx": row(256.0), "cy": row(256.0)}
    rgb = pipe.render_image(cams, 0, 512, 512)["rgb"]
    d = torch.as_tensor(dry, device=pipe.device)
    d_res = resample_poly(d, cfg.fs, fs_in)
    wet = auralize(d_res, rir, cfg.fs).cpu().numpy()

    def grid_feature():
        with pipe._eval_mode():
            return pipe._grid_feature_eval()

    def fresh_thread(fn):
        # as a handler thread of the server runs it: a new thread a call
        box = {}
        worker = threading.Thread(target=lambda: box.update(out=fn()))
        worker.start()
        worker.join()
        return box["out"]

    rirs = lambda: pipe.render_rirs(mic[None], src, rot)

    stages = {
        "rir_grid_feature": grid_feature,
        "rir_render_rirs": rirs,
        "rir_render_rirs_fresh_thread": lambda: fresh_thread(rirs),
        "rir_render_rirs_device_thread": lambda: backend._dispatch(rirs),
        "rir_griffin_lim": gl,
        "rir_wav": lambda: backend._wav_bytes(rir.cpu().numpy()),
        "render_512_render_image": lambda: pipe.render_image(cams, 0, 512, 512),
        "render_512_png": lambda: encode_png(quantize_rgb(rgb)),
        "auralize_resample": lambda: resample_poly(d, cfg.fs, fs_in),
        "auralize_convolve": lambda: auralize(d_res, rir, cfg.fs),
        "auralize_wav": lambda: backend._wav_bytes(wet),
    }
    out = {k: host_ms(torch, f) for k, f in stages.items()}
    print("viewer stages, warm (host ms, median of 3): " + ", ".join(
        f"{k} {v:.3f}" for k, v in out.items()), flush=True)
    return out


def live_viewer_run(torch, tmp, argv, n_eval, run1, spread) -> dict:
    """cli.train --viewer-port 0 for 8 steps with a client thread sending
    /render, /rir and /state during the run: every request answered, the
    launches gated (the run's own plus 3 pe_mlp and 1 GL), and step 8's
    checkpoint against the run without the viewer, beside the card's
    run-to-run spread (a second run without the viewer, and phase 21's two
    resumes)."""
    import threading

    from neraf_tpu_torch.cli import train as cli_train

    servers, answers = [], {}
    real_serve = cli_train.serve

    def capture(*args, **kwargs):
        servers.append(real_serve(*args, **kwargs))
        return servers[-1]

    def client():
        try:
            for _ in range(60000):
                if servers:
                    break
                time.sleep(0.01)
            base = f"http://127.0.0.1:{servers[0].server_address[1]}"
            for path in ("/render?theta=0.3&phi=0.3&radius=2&w=128&h=128",
                         "/rir?x=0&y=1&z=0", "/state"):
                t0 = time.perf_counter()
                status, ctype, body = http(base + path)
                answers[path] = (status, ctype, time.perf_counter() - t0,
                                 body if ctype == "application/json" else b"")
        except Exception as err:  # reported by the gate below
            answers["error"] = repr(err)

    run4 = tmp / "run4"
    want = {"pe_fwd": 4 * CLI_STEPS + 2 * 3 + 2 * 3 + 3 * n_eval + 3,
            "pe_bwd": 4 * CLI_STEPS, "gl": 1 + 1, "fh": 2 + 2 + n_eval + 1}
    thread = threading.Thread(target=client, daemon=True)
    cli_train.serve = capture
    try:
        thread.start()
        _, counts, wall = counted(torch, "cli train --viewer-port", lambda: (
            cli_train.main(argv + ["--run-dir", str(run4), "--viewer-port", "0"]),
            thread.join(600)), want)
    finally:
        cli_train.serve = real_serve
    got = [(p, a[:2]) for p, a in answers.items()]
    if [a for _, a in got] != [(200, "image/png"), (200, "audio/wav"),
                               (200, "application/json")]:
        fail(f"cli train --viewer-port: answers {got}")
    step_seen = json.loads(answers["/state"][3])["step"]
    # the yardstick: a second 8-step run without the viewer, against run1
    run5 = tmp / "run5"
    counted(torch, "cli train", lambda: cli_train.main(
        argv + ["--run-dir", str(run5)]), {**want, "pe_fwd": want["pe_fwd"] - 3,
                                          "gl": 1, "fh": want["fh"] - 1})
    load = lambda p: torch.load(p, map_location="cpu", weights_only=True)
    name8 = "step-000000008.pt"
    ref8 = load(run1 / "neraf_models" / name8)
    gaps = group_gaps(torch, load(run4 / "neraf_models" / name8), ref8)
    again = group_gaps(torch, load(run5 / "neraf_models" / name8), ref8)
    print(f"cli train --viewer-port: {wall:.2f} s, launches {counts}; "
          f"answers {[(p, a[0], round(a[2] * 1e3, 2)) for p, a in answers.items()]}"
          f" (ms), /state's step {step_seen}; step 8 against the run without "
          f"the viewer, by model (not gated): {json.dumps(gaps)}; a second "
          f"run without the viewer against the same run: {json.dumps(again)}; "
          f"phase 21's two resumes from step 4: {json.dumps(spread)}",
          flush=True)
    return {"wall_s": wall, "launches": counts, "state_step": step_seen,
            "request_ms": {p: a[2] * 1e3 for p, a in answers.items()},
            "gaps_vs_no_viewer": gaps, "gaps_no_viewer_twice": again}


def preprocess_check(torch, dev, tmp) -> dict:
    """process_scene's Python path (NERAF_NATIVE=0) on PRE_WAVS seeded
    binaural wavs at 44.1 kHz (0.5 s each) on the card, timed, each .npy
    held to process_rir_wav on the CPU."""
    from scipy.io import wavfile

    from neraf_tpu_torch.data.preprocess import process_rir_wav, process_scene

    scene = tmp / "pre_scene"
    rng = np.random.default_rng(0)
    t = np.arange(int(0.5 * 44100)) / 44100
    for i in range(PRE_WAVS):
        path = scene / "binaural_rirs" / str(90 * (i % 4)) / f"{i}_{i + 1}.wav"
        path.parent.mkdir(parents=True, exist_ok=True)
        rir = 0.3 * rng.standard_normal((t.shape[0], 2)) * np.exp(-8 * t)[:, None]
        wavfile.write(path, 44100, rir.astype(np.float32))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with native_ingest(False):  # the Python path, on the card
        n = process_scene(scene, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    worst = 0.0
    for wav in sorted((scene / "binaural_rirs").rglob("*.wav")):
        rel = wav.relative_to(scene / "binaural_rirs").with_suffix(".npy")
        got = np.load(scene / "binaural_magnitudes_sr22050" / rel)
        ref = process_rir_wav(wav, device="cpu")
        if got.shape != ref.shape or got.dtype != np.float32:
            fail(f"process_scene {rel}: {got.shape} {got.dtype} vs {ref.shape}")
        worst = max(worst, float(np.abs(got - ref).max() / np.abs(ref).max()))
    cpu_s = time.perf_counter() - t0
    print(f"process_scene: {n} wavs (0.5 s, 2 channels, 44.1 kHz) on the card "
          f"in {wall:.3f} s ({wall / n * 1e3:.2f} ms a wav; the CPU's "
          f"process_rir_wav {cpu_s:.3f} s for all); max err {worst:.3e} of "
          f"each spectrogram's peak (tol {PRE_REL_TOL})", flush=True)
    if n != PRE_WAVS or not worst <= PRE_REL_TOL:
        fail(f"process_scene: {n} files, max err {worst}")
    return {"wall_s": wall, "cpu_s": cpu_s, "max_rel_err": worst, "n": n}


def serving_phase(torch, dev, tmp, argv, n_eval, spread) -> dict:
    """Phase 22: the serving and tool entry points on phase 21's run
    directory (module docstring)."""
    from neraf_tpu_torch.cli import loudness as cli_loudness
    from neraf_tpu_torch.cli import train as cli_train
    from neraf_tpu_torch.configs.config import load_config
    from neraf_tpu_torch.engine.checkpoints import latest_checkpoint, restore_checkpoint
    from neraf_tpu_torch.engine.factory import build_pipeline
    from neraf_tpu_torch.utils.png import read_png
    from neraf_tpu_torch.viz.auralization import rir_from_log_stft
    from neraf_tpu_torch.viz.loudness import loudness_map, render_loudness_grid
    from neraf_tpu_torch.viz.trajectory import (
        make_trajectory_poses,
        moving_listener_audio,
    )

    run1, res = tmp / "run1", {}
    # cli.render, fourier: 3 pe_mlp launches a 4,096-ray view (one chunk)
    res["render"] = render_cli_check(torch, dev, tmp, run1, "cli render",
                                     {"pe_fwd": 3 * n_eval, "fh": n_eval})
    # a 2-step hash run, then cli.render on it: 1 hash + 2 pe_mlp a chunk
    hrun = tmp / "hash_run"
    _, counts, wall = counted(torch, "cli train, hash", lambda: cli_train.main(
        argv + ["--max-iters", "2", "--run-dir", str(hrun), "--set",
                "vision_model.encoding=hash"]),
        {"pe_fwd": 4, "pe_bwd": 4, "hash_fwd": 4, "hash_bwd": 4})
    print(f"cli train, hash: 2 steps in {wall:.2f} s, launches {counts}",
          flush=True)
    res["train_hash"] = {"wall_s": wall, "launches": counts}
    res["render_hash"] = render_cli_check(
        torch, dev, tmp, hrun, "cli render, hash",
        {"pe_fwd": 2 * n_eval, "hash_fwd": n_eval, "fh": n_eval})

    # cli.loudness at 48 x 48: 2,304 RIRs in one sweep, no GL, no pe_mlp
    out_dir = tmp / "loudness"
    lm, counts, wall = counted(torch, "cli loudness", lambda: cli_loudness.main(
        ["--load-config", str(run1 / "config.yml"), "--output-dir",
         str(out_dir), "--resolution", "48"]), {})
    img = read_png(out_dir / "loudness_map.png")
    if lm.shape != (48, 48) or not np.isfinite(lm).all() or img.shape != (
            512, 512, 3) or not np.array_equal(
                np.load(out_dir / "loudness_db.npy"), lm):
        fail(f"cli loudness: map {lm.shape} finite {np.isfinite(lm).all()}, "
             f"png {img.shape}")
    res["loudness"] = {"wall_s": wall, "launches": counts,
                       "db_range": [float(lm.min()), float(lm.max())]}

    # the loudness sweep alone, and a 16-pose trajectory, on run1's pipeline
    bundle = build_pipeline(load_config(run1 / "config.yml"), device=dev)
    pipe = bundle.pipeline
    restore_checkpoint(latest_checkpoint(run1 / "neraf_models"), pipe)
    cfg, o = pipe.audio_model.config, bundle.audio_train.outputs
    aabb = pipe.audio_aabb.cpu().numpy()
    height = float(np.mean(o.microphone_poses[:, 1]))
    src = np.mean(o.source_poses, axis=0)
    sweep_ms = cuda_ms(torch, lambda: loudness_map(render_loudness_grid(
        pipe.render_rirs, src, o.rotations[0], aabb, height, 48)["log_stfts"],
        (48, 48)), 3)
    res["loudness"]["sweep_ms"] = sweep_ms
    print(f"cli loudness: 48 x 48 = 2,304 RIRs x {cfg.max_len} frames "
          f"({2304 * cfg.max_len} queries) in one sweep; the CLI {wall:.2f} s "
          f"(build and restore included), the sweep alone {sweep_ms:.2f} ms; "
          f"launches {counts}; map {lm.min():.2f} to {lm.max():.2f} dB",
          flush=True)

    waypoints = aabb[0] + (aabb[1] - aabb[0]) * np.array(
        [[0.2, 0.5, 0.2], [0.8, 0.5, 0.3], [0.7, 0.5, 0.8], [0.3, 0.5, 0.7]])
    poses = make_trajectory_poses(waypoints, TRAJ_POSES, src)
    dry = dry_wav(TRAJ_DRY_S, cfg.fs, 2)
    tile = lambda v: np.tile(v, (TRAJ_POSES, 1))

    def trajectory():
        log = pipe.render_rirs(poses["mic_poses"], tile(poses["source_poses"]),
                               tile(poses["rots"]))
        rirs = rir_from_log_stft(log, n_fft=cfg.n_fft, hop_len=cfg.hop_len,
                                 win_len=cfg.win_len,
                                 generator=torch.Generator().manual_seed(0))
        return rirs, moving_listener_audio(dry, rirs, cfg.fs)

    walls = []
    for _ in range(2):  # the first call pays cuFFT's plans for new sizes
        (rirs, wet), counts, wall = counted(torch, "trajectory", trajectory,
                                            {"gl": 1})
        walls.append(wall)
    mla_ms = cuda_ms(torch, lambda: moving_listener_audio(dry, rirs, cfg.fs), 3)
    ref = moving_listener_audio(dry, rirs.cpu(), cfg.fs)
    err = float((wet.cpu() - ref).abs().max() / ref.abs().max())
    hop = cfg.fs // 10
    n_out = (TRAJ_POSES - 1) * hop + 2 * hop + rirs.shape[-1] - 1
    print(f"trajectory: {TRAJ_POSES} poses -> RIRs {tuple(rirs.shape)} (one GL "
          f"launch, {TRAJ_POSES * cfg.mic_ch} channels) and a "
          f"{TRAJ_DRY_S:g} s moving-listener track {tuple(wet.shape)} in "
          f"{walls[0] * 1e3:.2f} ms, again {walls[1] * 1e3:.2f} ms; "
          f"moving_listener_audio alone {mla_ms:.3f} ms; "
          f"card vs CPU {err:.3e} of the peak (tol {MLA_REL_TOL}); launches "
          f"{counts}", flush=True)
    if wet.shape != (cfg.mic_ch, n_out) or not bool(torch.isfinite(wet).all()) \
            or not err <= MLA_REL_TOL:
        fail(f"trajectory: wet {tuple(wet.shape)}, err {err}")
    res["trajectory"] = {"ms": [w * 1e3 for w in walls], "mla_ms": mla_ms,
                         "max_rel_err": err, "launches": counts}
    del bundle, pipe, rirs, wet
    torch.cuda.empty_cache()

    res["viewer"] = viewer_requests(torch, tmp, run1)
    # kernel #1 at the viewer's 2 channels and the trajectory's 32
    res["gl"] = {M: gl_check(torch, dev, 512, 128, 512, 78, M) for M in (2, 32)}
    for M, row in res["gl"].items():
        row["bound_ms"], row["bound_by"] = gl_bound_ms(M, 512, 78)
    res["live_viewer"] = live_viewer_run(torch, tmp, argv, n_eval, run1, spread)
    res["preprocess"] = preprocess_check(torch, dev, tmp)
    return res


# Phase 23. The streamed batches against the host store, relative: bf16
# keeps 8 significand bits (2^-8 of a value at most); a wrong column or
# recording is O(1). The device memory the streamed audio data may
# commit: the pose tables (3.83 MiB at apartment_1's 111,513 recordings)
# and a few 2.0 MiB bf16 batches in flight, against the 21.6 GiB the
# resident split takes. LPIPS on the card (cuDNN, float32, TF32 off)
# against the CPU on the same weights and images, relative: float32
# convolutions of two libraries summed in other orders, then averaged over
# the image (the port against the JAX package on the CPU: 1e-5,
# tests/test_torch_lpips.py); TF32 would move it by ~1e-3, a wrong tap or
# scaling by O(1).
STREAM_BF16_REL, STREAM_MEM_MIB, LPIPS_CARD_REL = 2.0 ** -8, 32, 2e-4
APT1 = (111_513, 2, 257, 101)  # apartment_1's train split: N, C, F, T
STREAM_SEED, STREAM_MARKED = 23, 16  # batches whose columns are written


def apartment_split(batch: int):
    """apartment_1's train-split shapes: a lazily backed time-major host
    store (np.zeros commits a page only when written), whose columns that
    the first STREAM_MARKED batches of a sampler seeded STREAM_SEED draw
    are written with seeded log-magnitudes (the rest read as zeros), and
    seeded pose tables -> (a dataset for StreamingAudioSampler, the marked
    (rec, t) pairs)."""
    from types import SimpleNamespace

    N, C, F, T = APT1
    store = np.zeros((N, T, C, F), np.float32)
    draws = np.random.default_rng(STREAM_SEED).integers(
        0, N * T, (STREAM_MARKED, batch)).reshape(-1)
    rec, t = draws // T, draws % T
    rng = np.random.default_rng(STREAM_SEED + 1)
    store[rec, t] = rng.normal(-3.0, 0.5, (rec.size, C, F)).astype(np.float32)
    outputs = SimpleNamespace(
        microphone_poses=rng.uniform(-2, 2, (N, 3)).astype(np.float32),
        source_poses=rng.uniform(-2, 2, (N, 3)).astype(np.float32),
        rotations=rng.uniform(0, 1, (N, 3)).astype(np.float32),
        audio_filenames=[], aabb=np.array([[-3.0] * 3, [3.0] * 3], np.float32))
    return SimpleNamespace(log_stft=store, outputs=outputs, max_len=T), (rec, t)


def copy_overlap(events) -> dict:
    """The sampler's host-to-device copies (pinned memory) in a profile:
    their device ms and the share of it during which a kernel ran."""
    copies = [(e.time_range.start, e.time_range.end) for e in events
              if e.device_type.name == "CUDA" and e.time_range.end > 0
              and e.name.startswith("Memcpy HtoD (Pinned")]
    kernels = sorted((e.time_range.start, e.time_range.end) for e in events
                     if e.device_type.name == "CUDA" and e.time_range.end > 0
                     and not e.name.startswith(("Memcpy", "Memset")))
    total = sum(b - a for a, b in copies)
    covered = 0.0
    longest = max((b - a for a, b in copies), default=0.0)
    for a, b in copies:
        end = a
        for ka, kb in kernels:
            if kb <= end or ka >= b:
                continue
            covered += min(kb, b) - max(ka, end)
            end = min(kb, b)
    return {"copies": len(copies), "copy_ms": total / 1e3,
            "longest_copy_ms": longest / 1e3,
            "overlapped_share": covered / total if total else 0.0}


def stream_sampler_check(torch, dev, ds, marked) -> dict:
    """The sampler at apartment_1's shapes, bf16: batches against the store,
    the device memory it commits, the producer's gather and the copies'
    device time."""
    from neraf_tpu_torch.data.streaming import StreamingAudioSampler

    N, C, F, T = APT1
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    sampler = StreamingAudioSampler(ds, 2048, seed=STREAM_SEED,
                                    transfer_dtype="bfloat16", layout="tcf",
                                    device=dev)
    init_s = time.perf_counter() - t0
    try:
        held, worst, hit = [], 0.0, 0
        for _ in range(STREAM_MARKED):
            b = sampler.next()
            held = (held + [b])[-3:]  # the step's batch and two before it
            torch.cuda.synchronize()
            rec, t = b["audio_idx"].cpu().numpy(), b["time_query"].cpu().numpy()
            want = ds.log_stft[rec, t]
            got = b["data"].float().cpu().numpy()
            if b["data"].dtype != torch.bfloat16 or got.shape != (2048, C, F):
                fail(f"stream sampler: batch {b['data'].dtype} {got.shape}")
            worst = max(worst, float((np.abs(got - want) / np.abs(want).clip(
                1e-30)).max()))
            hit += int((want != 0).all(axis=(1, 2)).sum())
        mem = torch.cuda.memory_allocated() - mem0
        gather, copy = list(sampler.gather_ms), sampler.copy_ms()
    finally:
        sampler.stop()
    batch_mib = 2048 * C * F * 2 / 2**20
    row = {"init_s": init_s, "max_rel_err": worst, "marked_columns_read": hit,
           "device_mib": mem / 2**20, "batch_mib": batch_mib,
           "pose_tables_mib": 3 * N * 3 * 4 / 2**20,
           "resident_gib": N * C * F * T * 4 / 2**30,
           "gather_ms_median": float(np.median(gather)),
           "gather_ms": [round(v, 3) for v in gather[:8]],
           "copy_ms_median": float(np.median(copy)),
           "copy_gb_per_s": batch_mib * 2**20 / (float(np.median(copy)) * 1e6)}
    print(f"stream sampler (apartment_1 train split {N} x {C} x {F} x {T}, "
          f"time-major host store, batch 2048, bf16): {json.dumps(row)}",
          flush=True)
    if not worst <= STREAM_BF16_REL or hit != STREAM_MARKED * 2048:
        fail(f"stream sampler: batches off the store by {worst} (tol "
             f"{STREAM_BF16_REL}), {hit} marked columns read")
    if not row["device_mib"] < STREAM_MEM_MIB:
        fail(f"stream sampler: the audio data commits {row['device_mib']:.2f}"
             f" MiB of device memory (limit {STREAM_MEM_MIB})")
    return row


def stream_step_check(torch, dev, ds, marked) -> dict:
    """The full-width joint step at apartment_1's configuration fed by the
    sampler, beside the same step fed by the resident split of the same
    shape (21.6 GiB on the card, the marked columns written): one step
    each at the same draws with float32 transfer, losses bitwise equal;
    then each timed (median of 10 warm steps, the streamed one in bf16)
    and profiled (3 steps: device busy, idle share, and the share of the
    sampler's copies that overlap a kernel); 4 + 4 pe_mlp launches a step."""
    from neraf_tpu_torch.configs.config import default_config
    from neraf_tpu_torch.data.streaming import StreamingAudioSampler
    from neraf_tpu_torch.engine.factory import build_joint_pipeline

    N, C, F, T = APT1
    cfg = default_config("SoundSpaces", "apartment_1")
    if cfg.audio_model.max_len != T:
        fail(f"apartment_1's max_len {cfg.audio_model.max_len}, not {T}")
    pipes = {k: build_joint_pipeline(grid_res=128, tiny=False, device=dev,
                                     seed=0, config=cfg)
             for k in ("resident", "streamed")}
    for p in pipes.values():
        p.step = 3000  # past start_step_audio: the audio branch is live
    cams, _, images = bench_inputs(torch, dev)
    rec, t = (torch.as_tensor(v, device=dev) for v in marked)
    o = ds.outputs
    resident = {k: torch.as_tensor(v, device=dev) for k, v in (
        ("mic_pose", o.microphone_poses), ("source_pose", o.source_poses),
        ("rot", o.rotations))}
    resident["log_stft"] = torch.zeros((N, C, F, T), device=dev)
    resident["log_stft"][rec, :, :, t] = torch.as_tensor(
        ds.log_stft[marked[0], marked[1]], device=dev)
    n_img, H, W = images["images"].shape[:3]
    out = {"resident_split_gib": resident["log_stft"].numel() * 4 / 2**30}

    # the same draws, float32 transfer: the losses bitwise equal
    with StreamingAudioSampler(ds, 2048, seed=STREAM_SEED, layout="tcf",
                               device=dev) as s:
        batch = s.next()
        draws = {k: pipes[k].draw(n_img, H, W, N) for k in pipes}
        draws["resident"].update(rec=batch["audio_idx"], t=batch["time_query"])
        m = {"resident": pipes["resident"].train_step(
                cams, resident, images, draws=draws["resident"]),
             "streamed": pipes["streamed"].train_step(
                 cams, batch, images, draws=draws["streamed"])}
    print(f"stream step, same draws, float32 transfer: resident "
          f"{json.dumps(m['resident'])}; streamed {json.dumps(m['streamed'])}",
          flush=True)
    check_metrics(m["streamed"], "stream step")
    if m["resident"] != m["streamed"] or not m["streamed"]["audio_mag_loss"] > 0:
        fail("stream step: the streamed step's losses are not the resident "
             "step's at the same draws")
    out["same_draws_metrics"] = m["streamed"]

    # timed and profiled, the streamed step in bf16 (the default)
    sampler = StreamingAudioSampler(ds, 2048, seed=STREAM_SEED,
                                    transfer_dtype="bfloat16", layout="tcf",
                                    device=dev)
    feeds = {"resident": lambda: resident, "streamed": sampler.next}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    try:
        for k in ("resident", "streamed", "streamed", "resident"):
            pipe, feed = pipes[k], feeds[k]
            reset_counts()
            times = []
            for _ in range(2 + 10):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pipe.train_step(cams, feed(), images)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            counts = read_counts()
            if counts != {**{c: 0 for c in counts}, "pe_fwd": 48, "pe_bwd": 48}:
                fail(f"stream step {k}: launches {counts} in 12 steps")
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                for _ in range(3):
                    pipe.train_step(cams, feed(), images)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            events = prof.events()
            busy = busy_ms(events)
            row = out.setdefault(k, {"ms_per_step": [], "busy_ms_per_step": [],
                                     "idle_share": []})
            row["ms_per_step"].append(1e3 * float(np.median(times[2:])))
            row["busy_ms_per_step"].append(busy / 3)
            row["idle_share"].append(1 - busy / wall)
            row["launches"] = counts
            if k == "streamed":
                row.setdefault("copies", []).append(copy_overlap(events))
        out["streamed"]["gather_ms_median"] = float(np.median(sampler.gather_ms))
        out["streamed"]["copy_ms_median"] = float(np.median(sampler.copy_ms()))
    finally:
        sampler.stop()
    print(f"stream step, full width at apartment_1 (T {T}, 2048 STFT slices, "
          f"4096 rays, 4096 cells, bf16), resident vs streamed in turns "
          f"(median of 10 warm steps; busy and idle share over 3 profiled "
          f"steps, the profiler slowing the host): {json.dumps(out)}",
          flush=True)
    if not all(c["overlapped_share"] > 0 for c in out["streamed"]["copies"]):
        print("stream step: no sampler copy overlapped a kernel", flush=True)
    return out


def stream_cli_check(torch, tmp, argv, n_eval) -> dict:
    """cli.train --streaming on, joint (8 steps, every cadence) and
    --audio-only, on phase 21's scene: the records, checkpoints and launch
    counts phase 21 gates, and one sampler (on the card, bf16) created and
    stopped a run."""
    from neraf_tpu_torch.cli import train as cli_train

    samplers = []
    base_cls = cli_train.StreamingAudioSampler

    class Recorded(base_cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            samplers.append(self)

    cli_train.StreamingAudioSampler = Recorded
    res, counts = {}, {}
    try:
        run = tmp / "run_stream"
        want = {"pe_fwd": 4 * CLI_STEPS + 2 * 3 + 2 * 3 + 3 * n_eval,
                "pe_bwd": 4 * CLI_STEPS, "gl": 1, "fh": 2 + 2 + n_eval}
        trainer, counts["stream_train"], wall = counted(
            torch, "cli train --streaming on", lambda: cli_train.main(
                argv + ["--streaming", "on", "--run-dir", str(run)]), want)
        records = [json.loads(line) for line in
                   (run / "metrics.jsonl").read_text().splitlines()]
        ckpts = sorted(p.name for p in (run / "neraf_models").iterdir())
        if {(r["step"], r["prefix"]) for r in records} != CLI_RECORDS or \
                len(records) != len(CLI_RECORDS) or not all(
                    map(finite_record, records)) or ckpts != [
                    "step-000000004.pt", "step-000000008.pt"]:
            fail(f"cli train --streaming on: records {records}, checkpoints "
                 f"{ckpts}")
        steps_ms = [dt * 1e3 for _, what, dt in trainer.timings if what == "step"]
        res["train"] = {"wall_s": wall, "cold_step_ms": steps_ms[0],
                        "warm_step_ms_median": float(np.median(steps_ms[1:]))}
        del trainer
        run = tmp / "run_stream_audio"
        _, counts["stream_audio_only_train"], wall = counted(
            torch, "cli audio-only train --streaming on",
            lambda: cli_train.main(argv + ["--audio-only", "--streaming", "on",
                                           "--run-dir", str(run)]), {"gl": 2})
        records = [json.loads(line) for line in
                   (run / "metrics.jsonl").read_text().splitlines()]
        if {(r["step"], r["prefix"]) for r in records} != {
                (2, "train"), (4, "train"), (6, "train"), (8, "train"),
                (8, "eval_audio")} or not all(map(finite_record, records)):
            fail(f"cli audio-only train --streaming on: metrics {records}")
        res["audio_only"] = {"wall_s": wall}
    finally:
        cli_train.StreamingAudioSampler = base_cls
    if len(samplers) != 2 or not all(
            s._stopped.is_set() and not s._thread.is_alive()
            and s.device.type == "cuda" and s._dtype == torch.bfloat16
            for s in samplers):
        fail(f"cli --streaming on: {len(samplers)} samplers, not one a run, "
             "on the card in bf16 and stopped")
    res["launches"] = counts
    print(f"cli --streaming on: {json.dumps(res)}", flush=True)
    return res


def lpips_check(torch, dev, tmp, run1, n_eval) -> dict:
    """LPIPS with random weights written to an .npz, alex and vgg, on a
    512 x 512 pair: the card against the CPU, ms per pair, and each tap's
    largest difference from the CPU's relative to its peak, with TF32 off
    (the metric's) and on (printed, with the distance it gives); then
    cli.evaluate on phase 21's run with NERAF_LPIPS_WEIGHTS set: lpips a
    number, the launches phase 21 gates."""
    from neraf_tpu_torch.cli import evaluate as cli_evaluate
    from neraf_tpu_torch.metrics import lpips_impl

    rng = np.random.default_rng(25)
    x = rng.uniform(0, 1, (512, 512, 3)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.05, x.shape), 0, 1).astype(np.float32)
    xd, yd = (torch.as_tensor(v, device=dev) for v in (x, y))
    rows, paths = {}, {}
    for i, net in enumerate(("alex", "vgg")):
        paths[net] = tmp / f"lpips_{net}.npz"
        lpips_impl.save_params_npz(paths[net], lpips_impl.init_params(net, i),
                                   net=net)
        params, _ = lpips_impl.load_params(str(paths[net]))
        t0 = time.perf_counter()
        cpu = float(lpips_impl.lpips_distance(params, torch.from_numpy(x),
                                              torch.from_numpy(y), net=net))
        cpu_s = time.perf_counter() - t0
        dparams, _ = lpips_impl.load_device_params(str(paths[net]), str(dev))
        run = lambda: lpips_impl.lpips_distance(dparams, xd, yd, net=net)
        card = float(run())
        rel = abs(card - cpu) / abs(cpu)
        run()
        pair = lambda d: torch.stack([torch.as_tensor(v, device=d)
                                      for v in (x, y)])
        with torch.no_grad():
            ref = lpips_impl._taps(lpips_impl._as_tensors(params, "cpu"),
                                   lpips_impl._scaled(pair("cpu"), True), net)
            taps = {tf32: lpips_impl._taps(
                dparams, lpips_impl._scaled(pair(dev), True), net, tf32)
                for tf32 in (False, True)}
            tf32_lpips = float(lpips_impl._distance(
                [t[:1] for t in taps[True]], [t[1:] for t in taps[True]],
                dparams)[0])
        tap_err = {tf32: max(float((a.cpu() - b).abs().max() / b.abs().max())
                             for a, b in zip(taps[tf32], ref))
                   for tf32 in (False, True)}
        rows[net] = {"card": card, "cpu": cpu, "rel_err": rel,
                     "tap_rel_err": tap_err[False],
                     "tf32_tap_rel_err": tap_err[True],
                     "tf32_rel_err": abs(tf32_lpips - cpu) / abs(cpu),
                     "ms_per_pair": cuda_ms(torch, run, 10), "cpu_s": cpu_s}
        print(f"lpips {net} 512 x 512: {json.dumps(rows[net])} (tol "
              f"{LPIPS_CARD_REL})", flush=True)
        if not (np.isfinite(card) and card > 0 and rel <= LPIPS_CARD_REL
                and tap_err[False] <= LPIPS_CARD_REL):
            fail(f"lpips {net}: card {card} vs cpu {cpu}")
    old = os.environ.get("NERAF_LPIPS_WEIGHTS")
    os.environ["NERAF_LPIPS_WEIGHTS"] = str(paths["alex"])
    try:
        results, counts, wall = counted(
            torch, "cli evaluate with lpips", lambda: cli_evaluate.main(
                ["--load-config", str(run1 / "config.yml")]),
            {"pe_fwd": 3 * n_eval, "gl": 2, "fh": n_eval})
    finally:
        if old is None:
            os.environ.pop("NERAF_LPIPS_WEIGHTS")
        else:
            os.environ["NERAF_LPIPS_WEIGHTS"] = old
    lp = results.get("lpips")
    print(f"cli evaluate with NERAF_LPIPS_WEIGHTS (alex): {wall:.2f} s, "
          f"lpips {lp}, lpips_std {results.get('lpips_std')}", flush=True)
    if not (isinstance(lp, float) and np.isfinite(lp) and lp > 0
            and "lpips_skipped" not in results):
        fail(f"cli evaluate with LPIPS weights: {results}")
    rows["cli_evaluate"] = {"wall_s": wall, "lpips": lp, "launches": counts}
    return rows


def streaming_phase(torch, dev, tmp, cli) -> dict:
    """Phase 23 (module docstring)."""
    ds, marked = apartment_split(2048)
    out = {"sampler": stream_sampler_check(torch, dev, ds, marked)}
    out["step"] = stream_step_check(torch, dev, ds, marked)
    del ds
    torch.cuda.empty_cache()
    out["cli"] = stream_cli_check(torch, tmp, cli["argv"], cli["n_eval"])
    out["lpips"] = lpips_check(torch, dev, tmp, tmp / "run1", cli["n_eval"])
    return out


# Phase 24: the default dataset, RAF, through the native C++ ingest. The
# scene is docs/DATA.md's RAF scale rounded up; the loads are held to each
# other at the CPU tests' bounds (tests/test_torch_native_ingest.py: log
# STFTs 2e-5 + 1e-5 relative, waveforms 1e-6), the preprocessed
# spectrograms at phase 22's (1e-4 of each one's peak: float32 on the card,
# float64 sums natively).
RAF_TRAIN, RAF_TEST, RAF_SECONDS, RAF_PRE_WAVS = 2048, 256, (0.2, 1.5), 2048
RAF_LOG_ATOL, RAF_LOG_RTOL, RAF_WAV_ATOL = 2e-5, 1e-5, 1e-6
RAF_EVAL_KEYS = {f"audio_{k}{s}" for k in (
    "T60", "total_invalids_T60", "stft_error", "EDT", "C50")
    for s in ("", "_std")} | {"fps_audio", "num_rays_per_sec_audio"}


@contextlib.contextmanager
def native_ingest(on: bool):
    """NERAF_NATIVE for the block (0: the Python path), then as it was."""
    old = os.environ.get("NERAF_NATIVE")
    os.environ["NERAF_NATIVE"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("NERAF_NATIVE")
        else:
            os.environ["NERAF_NATIVE"] = old


def timed(fn):
    """fn() -> (its result, seconds by the host clock)."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def raf_loads(scene) -> tuple:
    """Both RAF splits through the native ingest and the Python path, timed,
    held to each other; no file falls back -> (the timings and errors, the
    native train split)."""
    from neraf_tpu_torch import native
    from neraf_tpu_torch.data.datasets import load_raf_dataset

    native.reset_fallbacks()
    out, secs = {}, {}
    for path, on in (("native", True), ("python", False)):
        with native_ingest(on):
            for split in ("train", "test"):
                out[path, split], secs[path, split] = timed(
                    lambda: load_raf_dataset(scene, split))
    errs = {}
    for split in ("train", "test"):
        a, b = out["native", split], out["python", split]
        if a.log_stft.shape != b.log_stft.shape or not np.allclose(
                a.log_stft, b.log_stft, rtol=RAF_LOG_RTOL, atol=RAF_LOG_ATOL):
            fail(f"raf load {split}: native and Python log STFTs differ, max "
                 f"{np.abs(a.log_stft - b.log_stft).max()}")
        errs[split] = float(np.abs(a.log_stft - b.log_stft).max())
        if split == "test":
            wav_err = float(np.abs(a.waveforms - b.waveforms).max())
            if a.waveforms.shape != b.waveforms.shape or not wav_err <= RAF_WAV_ATOL:
                fail(f"raf load test: waveforms differ by {wav_err}")
    if native.fallbacks():
        fail(f"raf load: {native.fallbacks()} files fell back to Python")
    res = {"seconds": {f"{p}_{s}": v for (p, s), v in secs.items()},
           "max_abs_log_err": errs, "max_abs_wav_err": wav_err,
           "fallbacks": native.fallbacks(),
           "shapes": {s: list(out["native", s].log_stft.shape)
                      for s in ("train", "test")}}
    print(f"raf load: {json.dumps(res)}", flush=True)
    return res, out["native", "train"]


def raf_preprocess(torch, dev, tmp) -> dict:
    """process_scene on RAF_PRE_WAVS seeded binaural 44.1 kHz wavs (0.5 s),
    natively and through the Python path on the card, timed, each
    spectrogram held to the other's."""
    from scipy.io import wavfile

    from neraf_tpu_torch.data.preprocess import process_scene

    scene = tmp / "raf_pre_scene"
    rng = np.random.default_rng(1)
    t = np.arange(int(0.5 * 44100)) / 44100
    for i in range(RAF_PRE_WAVS):
        path = scene / "binaural_rirs" / str(90 * (i % 4)) / f"{i}_{i + 1}.wav"
        path.parent.mkdir(parents=True, exist_ok=True)
        rir = 0.3 * rng.standard_normal((t.shape[0], 2)) * np.exp(-8 * t)[:, None]
        wavfile.write(path, 44100, rir.astype(np.float32))
    secs = {}
    for path, on, out in (("native", True, "mags_native"),
                          ("card", False, "mags_card")):
        with native_ingest(on):
            torch.cuda.synchronize()
            n, secs[path] = timed(lambda: process_scene(
                scene, out_dir=out, device=dev))
            torch.cuda.synchronize()
        if n != RAF_PRE_WAVS:
            fail(f"raf process_scene {path}: {n} files")
    worst = 0.0
    for got in sorted((scene / "mags_native").rglob("*.npy")):
        a = np.load(got)
        b = np.load(scene / "mags_card" / got.relative_to(scene / "mags_native"))
        if a.shape != b.shape:
            fail(f"raf process_scene {got.name}: {a.shape} vs {b.shape}")
        worst = max(worst, float(np.abs(a - b).max() / np.abs(b).max()))
    res = {"seconds": secs, "n": RAF_PRE_WAVS, "max_rel_err": worst}
    print(f"raf process_scene: {RAF_PRE_WAVS} wavs (0.5 s, 2 channels, 44.1 "
          f"kHz): native {secs['native']:.3f} s, Python path on the card "
          f"{secs['card']:.3f} s; max err {worst:.3e} of each spectrogram's "
          f"peak (tol {PRE_REL_TOL})", flush=True)
    if not worst <= PRE_REL_TOL:
        fail(f"raf process_scene: native vs card {worst}")
    return res


def raf_phase(torch, dev, tmp) -> dict:
    """Phase 24 (module docstring)."""
    from neraf_tpu_torch import native
    from neraf_tpu_torch.cli import evaluate as cli_evaluate
    from neraf_tpu_torch.cli import train as cli_train
    from neraf_tpu_torch.configs.config import default_config
    from neraf_tpu_torch.data.synthetic import write_raf_scene, write_vision_scene
    from neraf_tpu_torch.data.vision_data import camera_arrays, load_transforms

    res = {}
    _, res["build_s"] = timed(native.load)
    if not native.available():
        fail("native ingest: not available")
    print(f"native ingest: {native.library_path()} built/loaded in "
          f"{res['build_s']:.2f} s", flush=True)
    root = tmp / "raf"
    scene, res["scene_s"] = timed(lambda: write_raf_scene(
        root, RAF_TRAIN, RAF_TEST, scene="FurnishedRoom", seconds=RAF_SECONDS))
    write_vision_scene(scene, n_views=12, size=64)
    mb = sum(p.stat().st_size for p in scene.rglob("*.wav")) / 2**20
    print(f"raf: scene written in {res['scene_s']:.2f} s ({RAF_TRAIN} + "
          f"{RAF_TEST} RIRs of {RAF_SECONDS} s at 48 kHz, {mb:.1f} MiB of "
          f"wavs; 12 views of 64 x 64)", flush=True)
    res["load"], train_split = raf_loads(scene)
    res["preprocess"] = raf_preprocess(torch, dev, tmp)

    cfg = default_config("RAF", "FurnishedRoom")
    vcfg = cfg.vision_data
    vtrain, veval = (load_transforms(scene, s, eval_mode=vcfg.eval_mode,
                                     train_split_fraction=vcfg.train_split_fraction)
                     for s in ("train", "eval"))
    n_eval = len(veval.cameras)
    argv = ["--dataset", "RAF", "--scene", "FurnishedRoom", "--data-root",
            str(root), "--max-iters", str(CLI_STEPS)]
    for item in CLI_SET:
        argv += ["--set", item]
    run = tmp / "raf_run"
    gl_sweep = -(-RAF_TEST // 512)
    want = {"pe_fwd": 4 * CLI_STEPS + 2 * 3 + 2 * 3 + 3 * n_eval,
            "pe_bwd": 4 * CLI_STEPS, "gl": gl_sweep, "fh": 2 + 2 + n_eval}
    torch.cuda.reset_peak_memory_stats()
    trainer, counts_train, wall = counted(
        torch, "raf cli train", lambda: cli_train.main(
            argv + ["--run-dir", str(run)]), want)
    peak = torch.cuda.max_memory_allocated()
    records = [json.loads(line) for line in
               (run / "metrics.jsonl").read_text().splitlines()]
    ckpts = sorted(p.name for p in (run / "neraf_models").iterdir())
    if {(r["step"], r["prefix"]) for r in records} != CLI_RECORDS or \
            len(records) != len(CLI_RECORDS) or not all(
                map(finite_record, records)) or ckpts != [
                "step-000000004.pt", "step-000000008.pt"]:
        fail(f"raf cli train: records {records}, checkpoints {ckpts}")
    pipe = trainer.pipeline
    acfg = pipe.config.audio_model
    if (acfg.n_freq_stft, acfg.max_len, acfg.mic_ch, pipe.resnet.backbone,
            pipe.grid_res, pipe.config.vision_data.train_rays_per_batch) != (
            513, 60, 1, "resnet50", 128, 4096):
        fail(f"raf cli train: not the default RAF configuration: {acfg}")
    steps_ms = [dt * 1e3 for _, what, dt in trainer.timings if what == "step"]
    cams = camera_arrays(vtrain.cameras, dev)
    audio = train_split.slice_arrays(dev)
    images = {"images": torch.from_numpy(vtrain.images).to(dev)}
    # 3 more steps under the profiler on the run's pipeline and data
    _, busy, _, prof_ms = profile_steps(torch, pipe, cams, audio, images,
                                        "raf joint step")
    res["train"] = {
        "wall_s": wall, "cold_step_ms": steps_ms[0],
        "warm_step_ms_median": float(np.median(steps_ms[1:])),
        "warm_step_ms": steps_ms[1:], "busy_ms_per_step": busy,
        "profiled_ms_per_step": prof_ms, "idle_share": 1 - busy / prof_ms,
        "peak_gib": peak / 2**30, "launches": counts_train,
        "eval_ms": {w: [dt * 1e3 for _, k, dt in trainer.timings if k == w]
                    for w in {k for _, k, _ in trainer.timings} - {"step"}},
        "n_eval_views": n_eval}
    print(f"raf cli train (default RAF config: {pipe.resnet.backbone} over "
          f"7 x 128^3, 513 bins, T 60, mono, 4096 rays): "
          f"{json.dumps(res['train'])}", flush=True)
    res["pools"] = pool_layouts(torch, dev)
    del trainer, pipe, cams, audio, images
    torch.cuda.empty_cache()

    out_json = tmp / "raf_results.json"
    _, counts_eval, ewall = counted(
        torch, "raf cli evaluate", lambda: cli_evaluate.main(
            ["--load-config", str(run / "config.yml"),
             "--output-path", str(out_json)]),
        {"pe_fwd": 3 * n_eval, "gl": 2 * gl_sweep, "fh": n_eval})
    saved = json.loads(out_json.read_text())
    if set(saved["results"]) != RAF_EVAL_KEYS | VISION_EVAL_KEYS or \
            not finite_record(saved["results"]):
        fail(f"raf cli evaluate: results {saved}")
    res["evaluate"] = {"wall_s": ewall, "results": saved["results"],
                       "launches": counts_eval}
    print(f"raf cli evaluate: {ewall:.2f} s; {json.dumps(saved)}", flush=True)
    res["launches"] = {"raf_train": counts_train, "raf_evaluate": counts_eval}
    return res


# The stem's max pool: the port's joint 3^3 pool against the JAX package's
# default layout, three 1-D pools (pool_impl="separable", written here as a
# yardstick: the port has the joint pool only), at the stem's output of the
# folded 128^3 state. The values are equal (a max over a box factorises).
POOL_SHAPE = (1, 64, 64, 64, 64)


def separable_max_pool(torch, x):
    """The JAX ResNet3D's pool_impl="separable" (its resnet3d.py:265-279)."""
    F = torch.nn.functional
    x = F.max_pool3d(x, (3, 1, 1), (2, 1, 1), (1, 0, 0))
    x = F.max_pool3d(x, (1, 3, 1), (1, 2, 1), (0, 1, 0))
    return F.max_pool3d(x, (1, 1, 3), (1, 1, 2), (0, 0, 1))


def pool_layouts(torch, dev, rounds: int = 7) -> dict:
    """Phase 25: the two max pools, fwd + bwd in bf16, 20 calls a timing,
    in turns (the first 2 rounds warm-up); the values held equal."""
    F = torch.nn.functional
    x = torch.randn(POOL_SHAPE, device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    g = torch.randn((1, 64, 32, 32, 32), device=dev, dtype=torch.bfloat16)
    pools = {"joint": lambda: F.max_pool3d(x, 3, 2, 1),
             "separable": lambda: separable_max_pool(torch, x)}
    if not torch.equal(pools["joint"](), pools["separable"]()):
        fail("pool layouts: the joint and separable pools differ in value")
    times = {k: [] for k in pools}
    for _ in range(rounds):
        for k, pool in pools.items():
            times[k].append(cuda_ms(torch, lambda: pool().backward(g), 20))
    med = {k: float(np.median(v[2:])) for k, v in times.items()}
    res = {"ms_fwd_bwd_median": med,
           "ms_fwd_bwd": {k: v[2:] for k, v in times.items()},
           "faster": min(med, key=med.get)}
    print(f"pool layouts ({POOL_SHAPE} bf16, fwd + bwd, ms in turns): "
          f"{json.dumps(res)}", flush=True)
    return res


# Phase 26: the data mesh (parallel/sharding.py). Two ranks share card 0
# over gloo (NCCL refuses two ranks on one card) against one rank on the
# same card, at full width in bf16, every step from the same state and
# global draws. The ranks' kernels see the same rows as the one rank's (a
# row's PE+MLP, bake and renderer values do not depend on the batch
# beside it) and, with the ResNet whole, the same replicated grid in it
# (the split's own differences: MESH_FEATURE_REL_L2 below); what differs
# is the order of the sums: each rank's dW, loss means and
# spectral-convergence norms over its half, added across ranks after, and
# cuBLAS's choice of kernel for the audio field's half-size GEMMs, whose
# bf16 outputs may round the other way. Losses: the vision ones 1e-5
# relative to the one rank's (f32 sums in another order: 1.2e-7 at most
# measured on an H100). The audio ones 1e-5 relative to the one rank's
# audio field run on the ranks' halves of its batch, inside its own step
# (MeshHalves): a first run gated them against the one rank's whole-batch
# field at 1e-3 and read 1.3e-3 in the spectral convergence, whose
# numerator, a residual, amplifies the halves' bf16 roundings (the
# log-magnitude mean moved 1.8e-4); against the halves only the order of
# the f32 sums differs, and a wrong reduction, a missing 1/N or a dropped
# rank is off by O(1). Both differences from the one rank's own audio
# losses are printed. Step-0 gradients, by the
# relative L2 error of each tensor, 5e-2: phase 9 measured 5-9% between two
# bf16 implementations of one MLP whose every pre-activation rounds
# differently (ReLU masks flip); here only the audio field's rows can round
# differently, so this is the ceiling; a wrong scale (1/N twice, a bake
# gather without its sum over ranks) is 50-100%. The replicated state
# (weights, BatchNorm statistics, grid, folded grid, cursor, step) is gated
# bitwise across ranks after every step. The device sweep at
# tests/test_parallel.py:105-106's bounds.
MESH_RANKS, MESH_STEPS = 2, 3
MESH_LOSS_RTOL = 1e-5
MESH_VISION_LOSSES = ("rgb_loss", "interlevel_loss", "distortion_loss")
MESH_AUDIO_LOSSES = ("audio_sc_loss", "audio_mag_loss")
MESH_GRAD_REL_L2 = 5e-2
MESH_EVAL_RTOL, MESH_EVAL_ATOL = 2e-4, 1e-5
# The depth split: the ranks run the ResNet on depth slabs
# (parallel/depth_split.py), so their bf16 feature, BatchNorm statistics
# and ResNet gradients are the one rank's up to the rounding of convs
# on other shapes (cuDNN may take another algorithm for a slab plus its
# halo) and of statistics merged from the ranks' f32 (mean, M2). Feature
# (train step and eval sweep) and each BatchNorm statistic by relative L2,
# 2e-2: ~50 bf16 layers that each round 2^-9 of a value differently give
# ~sqrt(50) 2^-9 = 1.4e-2; a dropped halo plane, BatchNorm reduction or
# pool sum is O(1e-1) or more. Gradients keep MESH_GRAD_REL_L2. The audio
# losses are held to the one rank's field on the ranks' halves with the
# ranks' own feature (MeshHalves.feature), and the sweep to the one rank's
# sweep with the ranks' eval feature, so that those gates still see only
# the fan-out's summation order.
MESH_FEATURE_REL_L2 = MESH_STATS_REL_L2 = 2e-2
# In the split variants (the replicated one holds every gradient to
# MESH_GRAD_REL_L2), a gradient beyond MESH_GRAD_REL_L2 of the one rank's
# must be no further
# from the one rank's float32 step (same state and draws) than
# MESH_VS_F32 times the one rank's own bf16 step is. The split rounds the
# ResNet's bf16 activations differently from the one rank, and BatchNorm
# on the bench inputs' grid amplifies bf16 rounding in its gradients to
# tens of percent relative L2 from float32 on either side, so two bf16
# steps sit about as far from float32 each (a ratio near 1, the worst of
# ~160 tensors somewhat above it), while a wrong scale or a dropped
# collective moves a gradient by 50-100% on top of that (a ratio of 2.5
# or more).
MESH_VS_F32 = 2.0
# The split step in float32 (split_f32_step): the ranks' step on a
# float32 pipeline of their own against the one rank's float32 step from
# the same state. Losses MESH_LOSS_RTOL; the feature and each BatchNorm
# statistic within MESH_F32_STATE_TOL of their peak
# (tests/test_torch_parallel.py's SPLIT_STATE_TOL); the feature's
# cotangent and the acoustic field's gradients, upstream of the ResNet's
# backward, by relative L2, MESH_F32_E2E_REL_L2: an acoustic-field ReLU
# within float32 rounding of 0 may flip between the split and the whole
# feature (6e-4 of the cotangent's peak on the CPU at 3 ranks), where a
# dropped collective or a wrong factor of N is 1e-1 or more. The ResNet's
# gradients (from the ranks' cotangent) and the vision fields' (the bake
# carries the ResNet's backward into them) are printed, not gated: on the
# bench state's near-empty grid whole channels sit at a ReLU's kink, in
# float32 as in bf16; the first run read 0.113 of a ResNet gradient's
# peak between the split and one rank (ROADMAP.md fault (b): 9.2e-2
# between the card and the CPU, one rank each). The float64 check holds
# them instead: ResNet3D-50 alone over a random 7 x 128^3 volume
# (split_resnet_f64), split on the ranks against whole on one, the
# features, the BatchNorm statistics and every gradient within
# MESH_F64_TOL of their peak (the CPU tests' SPLIT_F64_TOL), where no
# unit sits within rounding of a kink.
MESH_F32_STATE_TOL = 1e-5
MESH_F32_E2E_REL_L2 = 1e-2
MESH_F64_TOL = 1e-6
# (variant, the stem kernel's gate, steps): the split step with the gate
# off and on, then the ResNet run whole on every rank (as before the
# split) for its stage times only
MESH_VARIANTS = (("split", False, MESH_STEPS), ("split_gate", True, MESH_STEPS),
                 ("replicated", False, 2))
# the stem kernel on a rank's slab of the step's folded volume (64 planes):
# (ranks, rank) of each slab, one starting on an even and one on an odd
# plane among them
MESH_STEM_SLABS = ((2, 0), (2, 1), (3, 1))


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def copy_train_state(torch, dst, src) -> None:
    """src's checkpoint contents into dst, as copies (a round trip through
    torch.save)."""
    import io

    from neraf_tpu_torch.engine.checkpoints import load_train_state
    from neraf_tpu_torch.engine.checkpoints import train_state as ckpt_state

    buf = io.BytesIO()
    torch.save(ckpt_state(src), buf)
    buf.seek(0)
    load_train_state(dst, torch.load(buf, map_location="cpu",
                                     weights_only=True))


class MeshHalves:
    """A forward hook on the one rank's audio model: inside its step, the
    audio losses of its batch with the field run whole (`full`, what the
    step computes) and run on the ranks' blocks of the batch, one call a
    block (`halves`), with the step's weights, feature and autocast."""

    def __init__(self, audio_model, n: int):
        self.n, self.busy = n, False
        self.full = self.halves = None
        # the ranks' grid feature, which the halves take in place of the
        # one rank's own when set
        self.feature = None
        self.handle = audio_model.register_forward_hook(self, with_kwargs=True)

    def __call__(self, module, args, kwargs, output):
        if self.busy:
            return
        import torch

        batch, aabb = args
        b = batch["data"].shape[0] // self.n
        kw = dict(kwargs)
        if self.feature is not None:
            kw["grid_feature"] = self.feature
        self.busy = True
        try:
            with torch.no_grad():
                parts = torch.cat([module(
                    {k: v[r * b:(r + 1) * b] for k, v in batch.items()}, aabb,
                    **kw) for r in range(self.n)])
                self.full = {k: float(v) for k, v in module.loss(
                    output.detach().float(), batch["data"]).items()}
                self.halves = {k: float(v) for k, v in module.loss(
                    parts.float(), batch["data"]).items()}
        finally:
            self.busy = False


def named_grads(pipe) -> dict:
    return {f"{m}.{k}": p.grad for m, mod in pipe.models.items()
            for k, p in mod.named_parameters()}


def mesh_grads(pipe, mesh) -> dict:
    """named_grads of a pipeline on a mesh, each model-sharded field
    gradient gathered whole (every rank of its model row calls this)."""
    from neraf_tpu_torch.parallel.sharding import gather_model

    placed = pipe.audio_model.field.placements
    return {name: gather_model(g, mesh)
            if name.removeprefix("audio_model.field.") in placed else g
            for name, g in named_grads(pipe).items()}


def card_mesh(world: int, rank: int, init: str, shape=None):
    """Rank `rank` of `world` gloo ranks sharing card 0: the 1-D mesh, or
    the 2-D one of `shape` (data, model)."""
    from neraf_tpu_torch.parallel.sharding import make_mesh, make_mesh_2d

    devices = ["cuda:0"] * world
    if shape is None:
        return make_mesh(world, devices, backend="gloo", rank=rank,
                         init_method=init)
    return make_mesh_2d(*shape, devices, backend="gloo", rank=rank,
                        init_method=init)


def mesh_rank(rank: int, world: int, init: str, out: str,
              variants=MESH_VARIANTS, sweep: bool = True, setup=None,
              shape=None, min_dim=None, extras: bool = True) -> None:
    """A spawned rank of phases 26 and 27 (rank 0 is the main process):
    its part of the steps (and of the sweep), what it measured written to
    `out`; `setup`, given, runs first (scripts/split_mutants_card.py
    plants a dropped collective with it)."""
    if setup is not None:
        setup()
    import torch

    mesh = card_mesh(world, rank, init, shape)
    try:
        Path(out).write_text(json.dumps(mesh_steps(
            torch, mesh, None, None, variants, sweep, extras, min_dim)))
    finally:
        mesh.close()


def rel_l2(got, want) -> float:
    return float((got.double() - want.double()).norm()
                 / max(float(want.double().norm()), 1e-30))


@contextlib.contextmanager
def whole_resnet(resnet):
    """The ResNet run whole on every rank under the mesh, as before the
    depth split: its forward with the mesh dropped."""
    from neraf_tpu_torch.models.resnet3d import ResNet3D

    resnet.forward = lambda x, bake_slab=None, mesh=None: ResNet3D.forward(
        resnet, x, bake_slab)
    try:
        yield
    finally:
        del resnet.forward


def bn_stats(pipe) -> dict:
    return {k: v for k, v in pipe.resnet.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def mesh_steps(torch, mesh, ref, ref32=None, variants=MESH_VARIANTS,
               sweep: bool = True, extras: bool = True,
               min_dim: int | None = None) -> dict:
    """Phases 26 and 27's work on every rank: the full-width pipeline on
    the mesh (its acoustic field sharded over a 2-D mesh's model axis at
    `min_dim` when given), for each of `variants` its steps each from
    `ref`'s state (rank 0 broadcasts a copy) with their launches, ms,
    stage ms and cross-rank mismatches (each field shard over its data
    column), then (with `sweep`) evaluate_audio_device on EVAL_RIRS
    synthetic RIRs, then (with `extras`) the float32 split step
    (split_f32_step) and the float64 ResNet (split_resnet_f64); rank 0
    also steps and sweeps `ref` (one rank, mesh None) and compares:
    losses every step, the feature, the BatchNorm statistics and the
    gradients (the field's gathered) at each variant's step 0 (the
    gradients also against `ref32`, the one rank in float32, stepped from
    the same state), the sweep with the ranks' eval feature."""
    from neraf_tpu_torch.data.synthetic import synth_scene
    from neraf_tpu_torch.engine.checkpoints import train_state as ckpt_state
    from neraf_tpu_torch.engine.factory import build_joint_pipeline
    from neraf_tpu_torch.parallel.sharding import (
        broadcast_state,
        replica_mismatches,
        replicated_state,
        sharded_names,
    )
    from neraf_tpu_torch.utils import profiling

    # float32 convs in float32 on every rank (rank 0's stem_slab_check
    # sets it too), for the float32 step's gates
    torch.backends.cudnn.allow_tf32 = False
    pipe = build_joint_pipeline(grid_res=128, tiny=False, seed=0, mesh=mesh)
    if min_dim is not None:
        pipe.shard_field(min_dim)
    cams, audio, images = bench_inputs(torch, pipe.device)
    out = {"variants": {}}
    halves = None if ref is None else MeshHalves(ref.audio_model,
                                                 mesh.world_size)
    feats = {}
    hooks = [pipe.resnet.register_forward_hook(
        lambda mod, args, o: feats.__setitem__("mesh", o.detach()[0].float()))]
    if ref is not None:
        hooks.append(ref.resnet.register_forward_hook(
            lambda mod, args, o: feats.__setitem__("one", o.detach()[0].float())))

    def from_ref():
        broadcast_state(pipe, mesh, None if ref is None else ckpt_state(ref))

    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    for variant, gate, n_steps in variants:
        pipe.stem_wgrad_kernel = gate
        if ref is not None:
            ref.stem_wgrad_kernel = gate
        res = {"steps": [], "loss_rel": [], "audio_vs_whole": [],
               "halves_vs_whole": []}
        with (whole_resnet(pipe.resnet) if variant == "replicated"
              else contextlib.nullcontext()):
            for k in range(n_steps):
                from_ref()
                mesh.barrier()  # each rank's clock starts with the state loaded
                torch.cuda.synchronize()
                reset_counts()
                profiling.clear()
                t0 = time.perf_counter()
                with profiling.recording():
                    m = pipe.train_step(cams, audio, images)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                counts = read_counts()
                stages = stage_ms()[0]
                bad = replica_mismatches(replicated_state(pipe), mesh,
                                         sharded_names(pipe))
                check_metrics(m, f"mesh {variant} step {k} rank "
                              f"{mesh.global_rank}")
                res["steps"].append({"metrics": m, "ms": ms, "launches": counts,
                                     "all_reduce_ms": stages["all_reduce"],
                                     "stages": stages, "mismatches": bad})
                grads = mesh_grads(pipe, mesh) if k == 0 else None
                if ref is None:
                    continue
                if k == 0:
                    copy_train_state(torch, ref32, ref)
                    ref32.stem_wgrad_kernel = gate
                    ref32.train_step(cams, audio, images)
                halves.feature = feats["mesh"]
                m1 = ref.train_step(cams, audio, images)
                if halves.full != {k2: m1[k2] for k2 in MESH_AUDIO_LOSSES}:
                    fail(f"mesh: the hook's whole-batch audio losses "
                         f"{halves.full} are not the step's {m1}")
                res["loss_rel"].append(
                    {**{key: rel(m[key], m1[key]) for key in MESH_VISION_LOSSES},
                     **{key: rel(m[key], halves.halves[key])
                        for key in MESH_AUDIO_LOSSES}})
                res["audio_vs_whole"].append({key: rel(m[key], m1[key])
                                              for key in MESH_AUDIO_LOSSES})
                res["halves_vs_whole"].append(
                    {key: rel(halves.halves[key], m1[key])
                     for key in MESH_AUDIO_LOSSES})
                if k == 0:
                    g2, g1 = grads, named_grads(ref)
                    g32 = named_grads(ref32)
                    res["grad_rel_l2"] = {name: rel_l2(g2[name], g)
                                          for name, g in g1.items()}
                    # each tensor's distance from float32: the ranks', and
                    # the one rank's bf16 step's
                    res["grad_vs_f32"] = {
                        name: [rel_l2(g2[name], g), rel_l2(g1[name], g)]
                        for name, g in g32.items()}
                    res["grad_max_rel"] = max(
                        float((g2[name] - g).abs().max()
                              / max(float(g.abs().max()), 1e-30))
                        for name, g in g1.items())
                    res["feature_rel_l2"] = rel_l2(feats["mesh"], feats["one"])
                    s2, s1 = bn_stats(pipe), bn_stats(ref)
                    res["stats_rel_l2"] = {name: rel_l2(s2[name], v)
                                           for name, v in s1.items()}
        if halves is not None:
            halves.feature = None
        out["variants"][variant] = res
    if halves is not None:
        halves.handle.remove()
    if sweep:
        cfg = pipe.audio_model.config
        ds = synth_scene(EVAL_RIRS, fs=cfg.fs, max_len=cfg.max_len, seed=1)
        from_ref()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        metrics = pipe.evaluate_audio_device(ds, chunk=EVAL_CHUNK)
        torch.cuda.synchronize()
        out["sweep"] = {"metrics": metrics, "launches": read_counts(),
                        "wall_s": time.perf_counter() - t0}
        if ref is not None:
            split_feat = feats["mesh"]
            # the one rank's sweep from the ranks' eval feature: the
            # fan-out alone; its own eval feature beside the ranks'
            ref._grid_feature_eval = lambda split=True: split_feat
            try:
                out["ref_sweep"] = ref.evaluate_audio_device(
                    ds, chunk=EVAL_CHUNK)
            finally:
                del ref._grid_feature_eval
            with ref._eval_mode():
                own = ref._grid_feature_eval()
            out["eval_feature_rel_l2"] = rel_l2(split_feat, own)
    for h in hooks:
        h.remove()
    del pipe
    torch.cuda.empty_cache()
    if extras:
        out["f32"] = split_f32_step(torch, mesh, ref, ref32,
                                    (cams, audio, images))
        torch.cuda.empty_cache()
        out["f64"] = split_resnet_f64(torch, mesh, ref is not None)
    return out


def split_resnet_f64(torch, mesh, ref: bool) -> dict:
    """Phase 26: ResNet3D-50 alone in float64 over a random 7 x 128^3
    volume and feature cotangent (seed 26): the eval feature, then in
    train mode the feature, the BatchNorm statistics it moves and every
    gradient of the feature's dot with the cotangent, split over the
    mesh's ranks (the gradients averaged over them, as a step averages
    them) and, with `ref` (rank 0), whole on one rank -> each one's error
    as a share of its peak (rank 0), the ranks' ms and the statistics'
    cross-rank mismatches."""
    from neraf_tpu_torch.models.resnet3d import ResNet3D
    from neraf_tpu_torch.parallel.sharding import (
        average_gradients,
        replica_mismatches,
    )

    def run(m) -> dict:
        gen = torch.Generator().manual_seed(26)
        net = ResNet3D("resnet50", 1024)
        net.reset_parameters(gen)
        vol = torch.rand((1, 128, 128, 128, 7), generator=gen,
                         dtype=torch.float64).to(mesh.device)
        cot = torch.randn((1, net.feature_dim), generator=gen,
                          dtype=torch.float64).to(mesh.device)
        net = net.double().to(mesh.device)
        with torch.no_grad():
            eval_feat = net(vol, mesh=m)
        net.train()
        feat = net(vol, mesh=m)
        (feat * cot).sum().backward()
        average_gradients(list(net.parameters()), m)
        return {"eval_feat": eval_feat, "feat": feat.detach(),
                "grads": {k: p.grad for k, p in net.named_parameters()},
                "stats": {k: v for k, v in net.state_dict().items()
                          if k.endswith(("running_mean", "running_var"))}}

    mesh.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = run(mesh)
    torch.cuda.synchronize()
    res = {"ms": (time.perf_counter() - t0) * 1e3,
           "mismatches": replica_mismatches(got["stats"], mesh)}
    if not ref:
        return res
    one = run(None)
    res.update({
        "eval_feature_peak": rel_err(got["eval_feat"], one["eval_feat"]),
        "feature_peak": rel_err(got["feat"], one["feat"]),
        "stats_peak": {k: rel_err(v, one["stats"][k])
                       for k, v in got["stats"].items()},
        "grad_peak": {k: rel_err(v, one["grads"][k])
                      for k, v in got["grads"].items()}})
    return res


def split_f32_step(torch, mesh, ref, ref32, inputs) -> dict:
    """Phase 26: one split step in float32 on the ranks (a float32
    pipeline of their own, the stem kernel's gate off) from `ref`'s state,
    and on rank 0 the one rank's float32 step (`ref32`) from the same
    state with the ranks' feature cotangent in place of its own -> each
    rank's metrics, ms, launches and cross-rank mismatches; on rank 0 also
    the losses, the feature, the BatchNorm statistics and every gradient
    against the one rank's (the ResNet's from the one cotangent, the rest
    end to end) and the cotangent."""
    import torch.distributed as dist

    from neraf_tpu_torch.engine.factory import build_joint_pipeline
    from neraf_tpu_torch.parallel.sharding import (
        broadcast_state,
        replica_mismatches,
        replicated_state,
    )

    pipe = build_joint_pipeline(grid_res=128, tiny=False, seed=0, mesh=mesh,
                                mixed_precision=False)
    pipe.stem_wgrad_kernel = False
    if ref is not None:
        copy_train_state(torch, pipe, ref)
    broadcast_state(pipe, mesh)
    got = {}

    def grab(key, use=None):
        def hook(mod, args, o):
            got[f"{key}_feat"] = o.detach().clone()

            def cotangent(g):
                got[f"{key}_cot"] = g.detach().clone()
                return use
            o.register_hook(cotangent)
        return hook

    handle = pipe.resnet.register_forward_hook(grab("mesh"))
    mesh.barrier()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    try:
        m = pipe.train_step(*inputs)
        torch.cuda.synchronize()
    finally:
        handle.remove()
    res = {"metrics": m, "ms": (time.perf_counter() - t0) * 1e3,
           "launches": read_counts(),
           "mismatches": replica_mismatches(replicated_state(pipe), mesh)}
    check_metrics(m, f"mesh split_f32 rank {mesh.rank}")
    # the global cotangent: the ranks' summed over N, as their ResNet
    # gradients are averaged over N
    cot = got["mesh_cot"].contiguous()
    dist.all_reduce(cot, group=mesh.group)
    cot /= mesh.world_size
    if ref is None:
        return res
    copy_train_state(torch, ref32, ref)
    ref32.stem_wgrad_kernel = False
    handle = ref32.resnet.register_forward_hook(grab("one", cot))
    try:
        m1 = ref32.train_step(*inputs)
    finally:
        handle.remove()

    g2, g1 = named_grads(pipe), named_grads(ref32)
    s2, s1 = bn_stats(pipe), bn_stats(ref32)
    res.update({
        "loss_rel": {k: abs(m[k] - m1[k]) / max(abs(m1[k]), 1e-30)
                     for k in (*MESH_VISION_LOSSES, *MESH_AUDIO_LOSSES)},
        "feature_peak": rel_err(got["mesh_feat"], got["one_feat"]),
        "stats_peak": {k: rel_err(s2[k], v) for k, v in s1.items()},
        "resnet_grad_peak": {k: rel_err(g2[k], g) for k, g in g1.items()
                             if k.startswith("resnet.")},
        "audio_grad_rel_l2": {k: rel_l2(g2[k], g) for k, g in g1.items()
                              if k.startswith("audio_model.")},
        "other_grad_rel_l2": {
            k: rel_l2(g2[k], g) for k, g in g1.items()
            if not k.startswith(("resnet.", "audio_model."))},
        "cotangent_rel_l2": rel_l2(cot, got["one_cot"]),
        "cotangent_peak": rel_err(cot, got["one_cot"])})
    return res


def stem_slab_check(torch, dev) -> dict:
    """Phase 26: the stem kernel on ranks' slabs of the step's folded
    volume (MESH_STEM_SLABS), as the split step hands it over
    (ops/baked_stem.py: the window of the rank's output planes with one
    halo plane a side, zeros beyond the volume, and the cotangent padded
    by one zero plane a side): against stem_wgrad_folded_plain in float64
    on the same inputs (STEM_REL_TOL of the peak) and cuDNN's weight
    gradient of the window's conv with no depth padding
    (STEM_CONV_BF16_TOL: cuDNN returns bf16); the two slabs of 2 ranks
    summed against the kernel on the whole volume (STEM_REL_TOL); the
    kernel, the plain version and cuDNN timed on each slab beside the
    kernel's bound, and the kernel's launches counted."""
    from neraf_tpu_torch.models.grid import fold_volume
    from neraf_tpu_torch.ops.baked_stem import window_cotangent
    from neraf_tpu_torch.ops.stem_wgrad import (
        fold_weight,
        stem_wgrad,
        stem_wgrad_folded_plain,
        stem_wgrad_unfold,
        unfold_weight,
    )
    from neraf_tpu_torch.parallel.depth_split import local_window
    from neraf_tpu_torch.parallel.sharding import partition

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(26)
    xf = fold_volume(torch.rand((1, 128, 128, 128, 7), generator=gen,
                                device=dev), torch.bfloat16)
    g_all = torch.randn((1, 64, 64, 64, 64), generator=gen, device=dev).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last_3d)
    wp = fold_weight(torch.zeros((64, 7, 5, 5, 5), dtype=torch.bfloat16,
                                 device=dev))
    rows, partial = {}, []
    for n, r in MESH_STEM_SLABS:
        lo, hi = partition(64, n)[r]
        xw = local_window(xf, 1, lo - 1, hi + 1)
        g = g_all[:, :, lo:hi]
        gp = window_cotangent(g)
        got = stem_wgrad(xw, gp)
        ref = stem_wgrad_unfold(stem_wgrad_folded_plain(xw.double(),
                                                         gp.double()))
        cudnn = lambda: unfold_weight(torch.ops.aten.convolution_backward(
            g, xw.permute(0, 4, 1, 2, 3), wp, None, (1,) * 3, (0, 1, 1),
            (1,) * 3, False, (0,) * 3, 1, (False, True, False))[1])
        lib = cudnn()
        err, rel = float((got.double() - ref).abs().max()), rel_err(got, ref)
        lib_rel = rel_err(got, lib.float())
        if not (rel <= STEM_REL_TOL and lib_rel <= STEM_CONV_BF16_TOL):
            fail(f"stem wgrad on the slab {lo}-{hi} of {n} ranks: {rel:.3e} "
                 f"from float64 (tol {STEM_REL_TOL}), {lib_rel:.3e} from "
                 f"cuDNN (tol {STEM_CONV_BF16_TOL})")
        if n == 2:
            partial.append(got)
        run_k = lambda: stem_wgrad(xw, window_cotangent(g))
        run_p = lambda: stem_wgrad_unfold(stem_wgrad_folded_plain(
            xw, window_cotangent(g)))
        for f in (run_k, run_p, cudnn):
            f()
        p1, k1, k2, p2, c1 = (cuda_ms(torch, f, 10) for f in (
            run_p, run_k, run_k, run_p, cudnn))
        bound, by = stem_bound_ms(xw, g)
        rows[f"{n}_ranks_rank{r}"] = {
            "planes": [lo, hi], "window": list(xw.shape), "max_abs_err": err,
            "rel_err": rel, "rel_vs_cudnn": lib_rel, "ms": (k1 + k2) / 2,
            "plain_ms": (p1 + p2) / 2, "library_ms": c1, "bound_ms": bound,
            "bound_by": by}
    whole = stem_wgrad(xf, g_all)
    sum_rel = rel_err(partial[0] + partial[1], whole)
    if not sum_rel <= STEM_REL_TOL:
        fail(f"stem wgrad: the 2 ranks' slabs sum to {sum_rel:.3e} of the "
             f"whole volume's (tol {STEM_REL_TOL})")
    print(f"stem wgrad on ranks' slabs (bf16, {smi('name,power.limit')}): "
          f"{json.dumps(rows)}; the 2 ranks' slabs summed vs the whole "
          f"volume {sum_rel:.3e} (tol {STEM_REL_TOL}); "
          f"{len(MESH_STEM_SLABS)} checked calls", flush=True)
    return {"slabs": rows, "sum_vs_whole_rel": sum_rel}


def mesh_run(torch, dev, tmp, variants=MESH_VARIANTS, sweep: bool = True,
             setup=None, shape=None, min_dim=None,
             extras: bool = True) -> tuple:
    """Phases 26 and 27: the ranks on card 0 (this process rank 0, the
    others spawned; MESH_RANKS on the 1-D mesh, data x model on a 2-D
    `shape`), mesh_steps on each of them against one rank (and one rank
    in float32), at full width; `setup`, given, is run by each spawned
    rank before it starts (rank 0's caller runs it for itself) ->
    (rank 0's results, the other ranks' in rank order, the wall s)."""
    import multiprocessing

    from neraf_tpu_torch.engine.factory import build_joint_pipeline

    world = MESH_RANKS if shape is None else shape[0] * shape[1]
    ref32 = build_joint_pipeline(grid_res=128, tiny=False, device=dev, seed=0,
                                 mixed_precision=False)
    init = f"tcp://127.0.0.1:{free_port()}"
    outs = [tmp / f"mesh_rank{r}.json" for r in range(1, world)]
    ctx = multiprocessing.get_context("spawn")
    children = [ctx.Process(target=mesh_rank, args=(
        r, world, init, str(outs[r - 1]), variants, sweep, setup, shape,
        min_dim, extras), daemon=True) for r in range(1, world)]
    t0 = time.perf_counter()
    for child in children:
        child.start()
    try:
        ref = build_joint_pipeline(grid_res=128, tiny=False, device=dev, seed=0)
        ref.step = 3000  # past start_step_audio: the audio branch is live
        mesh = card_mesh(world, 0, init, shape)
        try:
            r0 = mesh_steps(torch, mesh, ref, ref32, variants, sweep, extras,
                            min_dim)
        finally:
            mesh.close()
        for child in children:
            child.join(600)
    finally:
        for child in children:
            if child.is_alive():
                child.kill()
                child.join()
    codes = [child.exitcode for child in children]
    if any(codes):
        fail(f"mesh: ranks 1-{world - 1} exited {codes}")
    rest = [json.loads(out.read_text()) for out in outs]
    return r0, rest, time.perf_counter() - t0


def mesh_gates(r0, rest, variants=MESH_VARIANTS, sweep: bool = True,
               extras: bool = True) -> tuple:
    """Phases 26 and 27's gates on the ranks' results (mesh_steps: rank
    0's, then the others' in rank order) -> ([(gate, message)] of every
    gate that failed, what the gates read a variant)."""
    ranks = [r0, *rest]
    bad = []
    want0 = {"pe_fwd": 4, "pe_bwd": 4, "hash_fwd": 0, "hash_bwd": 0,
             "stem": 0, "concat": 0, "gl": 0, "fh": 0}
    report = {}
    for variant, gate, _ in variants:
        want = {**want0, "stem": int(gate)}
        for rank, r in enumerate(ranks):
            for k, s in enumerate(r["variants"][variant]["steps"]):
                if s["launches"] != want:
                    bad.append(("launches", f"mesh {variant} step {k} rank "
                                f"{rank}: launches {s['launches']}, expected "
                                f"{want}"))
                if s["mismatches"]:
                    bad.append(("replicas", f"mesh {variant} step {k} rank "
                                f"{rank}: {s['mismatches']} differ from rank "
                                f"0's"))
                if s["metrics"] != r0["variants"][variant]["steps"][k][
                        "metrics"]:
                    bad.append(("rank_metrics", f"mesh {variant} step {k}: "
                                f"rank {rank}'s metrics differ from rank 0's"))
        v = r0["variants"][variant]
        worst_loss = max(max(d.values()) for d in v["loss_rel"])
        if not worst_loss <= MESH_LOSS_RTOL:
            bad.append(("losses", f"mesh {variant}: losses {v['loss_rel']} "
                        f"relative to one rank's, the audio ones to its field "
                        f"run on the ranks' halves with the ranks' feature "
                        f"(tol {MESH_LOSS_RTOL}); the audio ones relative to "
                        f"its own {v['audio_vs_whole']}"))
        grads = v["grad_rel_l2"]
        worst_grad = max(grads, key=grads.get)
        # beyond MESH_GRAD_REL_L2: (ranks', one rank's bf16) from float32
        beyond = {k: v["grad_vs_f32"][k] for k, e in grads.items()
                  if e > MESH_GRAD_REL_L2}
        ratio = {k: a / max(b, 1e-30) for k, (a, b) in beyond.items()}
        if variant == "replicated" and beyond:
            bad.append(("gradients", f"mesh {variant}: {len(beyond)} step-0 "
                        f"gradients beyond {MESH_GRAD_REL_L2} relative L2 from "
                        f"one rank's, the worst {worst_grad} "
                        f"{grads[worst_grad]:.3e}"))
        elif ratio and max(ratio.values()) > MESH_VS_F32:
            k = max(ratio, key=ratio.get)
            bad.append(("gradients", f"mesh {variant}: step-0 gradient {k} "
                        f"{grads[k]:.3e} relative L2 from one rank's (tol "
                        f"{MESH_GRAD_REL_L2}) and {beyond[k][0]:.3e} from one "
                        f"rank's float32 step, {ratio[k]:.2f} times the one "
                        f"rank's bf16 step's {beyond[k][1]:.3e} (tol "
                        f"{MESH_VS_F32})"))
        stats = v["stats_rel_l2"]
        worst_stat = max(stats, key=stats.get)
        if not v["feature_rel_l2"] <= MESH_FEATURE_REL_L2:
            bad.append(("feature", f"mesh {variant}: the feature "
                        f"{v['feature_rel_l2']:.3e} relative L2 from one "
                        f"rank's (tol {MESH_FEATURE_REL_L2})"))
        if not stats[worst_stat] <= MESH_STATS_REL_L2:
            bad.append(("stats", f"mesh {variant}: BatchNorm statistic "
                        f"{worst_stat} {stats[worst_stat]:.3e} relative L2 "
                        f"from one rank's (tol {MESH_STATS_REL_L2})"))
        resnet = {k: e for k, e in grads.items() if k.startswith("resnet.")}
        report[variant] = {
            "worst_loss_rel": worst_loss,
            "audio_vs_whole": v["audio_vs_whole"],
            "halves_vs_whole": v["halves_vs_whole"],
            "worst_grad": [worst_grad, grads[worst_grad]],
            "worst_resnet_grad": max(resnet.items(), key=lambda kv: kv[1]),
            "beyond_grad_tol": len(beyond),
            "worst_vs_f32_ratio": (max(ratio.items(), key=lambda kv: kv[1])
                                   if ratio else None),
            "worst_bf16_vs_f32": max(
                ((k, b) for k, (a, b) in v["grad_vs_f32"].items()),
                key=lambda kv: kv[1]),
            "grad_max_rel": v["grad_max_rel"],
            "feature_rel_l2": v["feature_rel_l2"],
            "worst_stat": [worst_stat, stats[worst_stat]]}
    if sweep:
        for rank, r in enumerate(ranks):
            if r["sweep"]["launches"] != {**want0, "pe_fwd": 0, "pe_bwd": 0,
                                          "gl": EVAL_RIRS // EVAL_CHUNK}:
                bad.append(("sweep", f"mesh sweep rank {rank}: launches "
                            f"{r['sweep']['launches']}"))
        sweep_m, ref_sweep = r0["sweep"]["metrics"], r0["ref_sweep"]
        for k in (*EVAL_KEYS, "audio_mag"):
            if not np.isclose(sweep_m[k], ref_sweep[k], rtol=MESH_EVAL_RTOL,
                              atol=MESH_EVAL_ATOL):
                bad.append(("sweep", f"mesh sweep: {k} {sweep_m[k]} on 2 "
                            f"ranks, {ref_sweep[k]} on one from the ranks' "
                            f"eval feature"))
        if not r0["eval_feature_rel_l2"] <= MESH_FEATURE_REL_L2:
            bad.append(("feature", f"mesh sweep: the ranks' eval feature "
                        f"{r0['eval_feature_rel_l2']} relative L2 from one "
                        f"rank's (tol {MESH_FEATURE_REL_L2})"))
        for rank, r in enumerate(rest, 1):
            if r["sweep"]["metrics"] != sweep_m | {
                    k: r["sweep"]["metrics"][k] for k in (
                        "fps_audio", "num_rays_per_sec_audio")}:
                bad.append(("sweep", f"mesh sweep: rank {rank}'s metrics "
                            f"differ from rank 0's"))
    if not extras:
        return bad, report
    f = r0["f32"]
    for rank, r in enumerate(ranks):
        if r["f32"]["mismatches"]:
            bad.append(("replicas", f"mesh split_f32 rank {rank}: "
                        f"{r['f32']['mismatches']} differ from rank 0's"))
    if any(r["f32"]["metrics"] != f["metrics"] for r in rest):
        bad.append(("rank_metrics", "mesh split_f32: a rank's metrics differ "
                    "from rank 0's"))
    worst = lambda d: max(d.items(), key=lambda kv: kv[1])
    loss, stat = worst(f["loss_rel"]), worst(f["stats_peak"])
    e2e = worst(f["audio_grad_rel_l2"])
    if not loss[1] <= MESH_LOSS_RTOL:
        bad.append(("f32_losses", f"mesh split_f32: loss {loss[0]} {loss[1]:.3e}"
                    f" relative to one rank's float32 step (tol "
                    f"{MESH_LOSS_RTOL})"))
    if not f["feature_peak"] <= MESH_F32_STATE_TOL:
        bad.append(("f32_feature", f"mesh split_f32: the feature "
                    f"{f['feature_peak']:.3e} of its peak from one rank's "
                    f"(tol {MESH_F32_STATE_TOL})"))
    if not stat[1] <= MESH_F32_STATE_TOL:
        bad.append(("f32_stats", f"mesh split_f32: BatchNorm statistic "
                    f"{stat[0]} {stat[1]:.3e} of its peak from one rank's "
                    f"(tol {MESH_F32_STATE_TOL})"))
    if not max(e2e[1], f["cotangent_rel_l2"]) <= MESH_F32_E2E_REL_L2:
        bad.append(("f32_end_to_end", f"mesh split_f32: gradient {e2e[0]} "
                    f"{e2e[1]:.3e}, the feature's cotangent "
                    f"{f['cotangent_rel_l2']:.3e} relative L2 from one "
                    f"rank's (tol {MESH_F32_E2E_REL_L2})"))
    report["split_f32"] = {
        "worst_loss_rel": loss, "feature_peak": f["feature_peak"],
        "worst_stat_peak": stat, "worst_audio_grad_rel_l2": e2e,
        "cotangent_rel_l2": f["cotangent_rel_l2"],
        "cotangent_peak": f["cotangent_peak"],
        "printed_only": {
            "worst_resnet_grad_peak": worst(f["resnet_grad_peak"]),
            "worst_other_grad_rel_l2": worst(f["other_grad_rel_l2"])},
        "ms": [r["f32"]["ms"] for r in ranks], "launches": f["launches"]}
    d = r0["f64"]
    for rank, r in enumerate(ranks):
        if r["f64"]["mismatches"]:
            bad.append(("replicas", f"mesh resnet_f64 rank {rank}: "
                        f"{r['f64']['mismatches']} differ from rank 0's"))
    parts = {"eval_feature": d["eval_feature_peak"],
             "feature": d["feature_peak"],
             "stats": worst(d["stats_peak"]), "grads": worst(d["grad_peak"])}
    for name, v in parts.items():
        e = v if isinstance(v, float) else v[1]
        if not e <= MESH_F64_TOL:
            bad.append((f"f64_{name}", f"mesh resnet_f64: {name} {v} of its "
                        f"peak from one rank's (tol {MESH_F64_TOL})"))
    report["resnet_f64"] = {**parts, "ms": [r["f64"]["ms"] for r in ranks]}
    return bad, report


def mesh_phase(torch, dev, tmp) -> dict:
    """Phase 26: the stem kernel on ranks' slabs (stem_slab_check); two
    ranks on card 0 against one rank, at full width, for each of
    MESH_VARIANTS and in float32 (mesh_run), every gate of mesh_gates
    fatal; then, where the machine has more than one card, cli.train
    --num-devices over NCCL (mesh_cli)."""
    torch.cuda.empty_cache()
    slabs = stem_slab_check(torch, dev)
    torch.cuda.empty_cache()
    r0, rest, wall = mesh_run(torch, dev, tmp)
    bad, report = mesh_gates(r0, rest)
    if bad:
        fail("; ".join(msg for _, msg in bad))
    smi_line = smi("name,power.limit")
    sweep, ref_sweep = r0["sweep"]["metrics"], r0["ref_sweep"]
    steps = lambda r, v: r["variants"][v]["steps"]
    per_rank = {f"rank{i}": {
        "ms": {v: [round(s["ms"], 3) for s in steps(r, v)]
               for v, _, _ in MESH_VARIANTS},
        "f32_ms": round(r["f32"]["ms"], 3),
        "all_reduce_ms": [round(s["all_reduce_ms"], 3)
                          for s in steps(r, "split")],
        "pe_fwd": sum(s["launches"]["pe_fwd"] for s in steps(r, "split")),
        "pe_bwd": sum(s["launches"]["pe_bwd"] for s in steps(r, "split")),
        "stem_split": sum(s["launches"]["stem"]
                          for s in steps(r, "split_gate")),
        "sweep_gl": r["sweep"]["launches"]["gl"],
        "sweep_s": round(r["sweep"]["wall_s"], 3)}
        for i, r in enumerate((r0, *rest))}
    stage_times = {f"rank{i}": {
        v: {st: [round(s["stages"][st], 3) for s in steps(r, v)]
            for st in ("resnet_forward", "backward")}
        for v in ("split", "replicated")} for i, r in enumerate((r0, *rest))}
    print(f"mesh (gloo, 2 ranks sharing card 0: {smi_line}): full-width "
          f"bf16 steps each from one rank's state, the ResNet split by depth "
          f"(gate off and on) and whole, one split step in float32 and the "
          f"ResNet alone in float64; per "
          f"rank {json.dumps(per_rank)}; against one rank "
          f"{json.dumps(report)} (tols: losses {MESH_LOSS_RTOL}, gradients "
          f"{MESH_GRAD_REL_L2} or, split, within {MESH_VS_F32} x the one "
          f"rank's bf16 distance from its float32 step, feature "
          f"{MESH_FEATURE_REL_L2}, statistics {MESH_STATS_REL_L2}; float32: "
          f"feature and statistics {MESH_F32_STATE_TOL} of the peak, the "
          f"cotangent and acoustic-field gradients {MESH_F32_E2E_REL_L2} "
          f"relative L2; the float64 ResNet: features, statistics and "
          f"gradients {MESH_F64_TOL} of the peak); replicas bitwise equal "
          f"after every step; the sweep "
          f"of {EVAL_RIRS} RIRs on 2 ranks {json.dumps(sweep)} vs one from "
          f"the ranks' eval feature {json.dumps(ref_sweep)}, the eval feature "
          f"{r0['eval_feature_rel_l2']:.3e} relative L2 from one rank's; "
          f"phase wall {wall:.2f} s. The shared card's gloo times are not "
          f"a speed of the data-parallel path.", flush=True)
    print(f"mesh stage ms, resnet_forward and backward, each rank, the "
          f"ResNet split against whole (a shared card's, gloo; {smi_line}): "
          f"{json.dumps(stage_times)}", flush=True)
    return {"per_rank": per_rank, "stage_ms": stage_times, "report": report,
            "sweep": sweep, "ref_sweep": ref_sweep,
            "eval_feature_rel_l2": r0["eval_feature_rel_l2"], "wall_s": wall,
            "stem_slabs": slabs, "cli": mesh_cli(torch, tmp)}


# Phase 27, the 2-D mesh. The (2, 2) step takes phase 26's gates on the
# bench inputs (the field's gathered gradients among the step-0 ones): the
# sharded field computes each output column with the same dot as the
# whole one, so the ranks differ from one rank by the depth split's
# rounding alone. The (1, 2) field: float32 at the JAX test's bounds
# (FIELD_RTOL, FIELD_ATOL; a gradient's atol of its peak, as
# tests/test_torch_mesh2d.py holds it: weight gradients of a 2,048-row sum
# reach far above 1, where an absolute 1e-5 is below float32's rounding);
# cuBLAS may take another kernel for a block of columns than for all of
# them, so a leaky-ReLU input within rounding of 0 can flip (relu_flips)
# and a tensor upstream of one is printed, not gated. bf16 by phase 26's
# gate: a tensor beyond MESH_GRAD_REL_L2 of the one rank's bf16 must be
# no further from the one rank's float32 than MESH_VS_F32 times the one
# rank's bf16 is. On an H100 the two bf16 backwards read 9.4e-2 relative
# L2 apart at trunk.0.bias, each of them 5.0e-2 (trunk.4) to 0.105
# (trunk.0) from float32, the bf16 cotangent rounded at every layer, so
# two of them can be that far apart.
MESH2D_SHAPE, MESH2D_STEPS, MESH2D_MIN_DIM = (2, 2), 3, 512
MESH2D_VARIANTS = (("split", False, MESH2D_STEPS),)
FIELD_MODEL, FIELD_ROWS, FIELD_IN_DIM, FIELD_MIN_DIM = 2, 2048, 1187, 1024
FIELD_RTOL, FIELD_ATOL = 2e-4, 1e-5  # tests/test_parallel.py:216


def field_rank(rank: int, world: int, init: str, out: str,
               setup=None) -> None:
    """A spawned rank of phase 27's (1, world) field check; `setup`,
    given, runs first."""
    if setup is not None:
        setup()
    import torch

    mesh = card_mesh(world, rank, init, (1, world))
    try:
        Path(out).write_text(json.dumps(field_model_axis(torch, mesh)))
    finally:
        mesh.close()


def field_model_axis(torch, mesh) -> dict:
    """Phase 27 on every rank of a (1, M) mesh: the full-width acoustic
    field (weights from seed 27, FIELD_ROWS random inputs and output
    cotangents) sharded at FIELD_MIN_DIM, forward and backward in float32
    and in bf16 (autocast), its gradients gathered; the sharded forward +
    backward and the field's all-gathers timed (the gathers alone, each
    sharded layer's output block, as the forward gathers them) and its
    forward FLOPs counted; rank 0 also runs the whole field and compares
    -> what rank 0 read (the others: their times)."""
    import copy

    from torch.utils.flop_counter import FlopCounterMode

    from neraf_tpu_torch.fields.acoustic import AcousticSoundField
    from neraf_tpu_torch.parallel.sharding import (
        apply_param_shardings,
        gather_model,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.device
    whole = AcousticSoundField(FIELD_IN_DIM)
    whole.reset_parameters(torch.Generator().manual_seed(27))
    whole = whole.to(dev)
    gen = torch.Generator(device=dev).manual_seed(27)
    x = torch.randn((FIELD_ROWS, FIELD_IN_DIM), generator=gen, device=dev)
    cot = torch.randn((FIELD_ROWS, 2, 257), generator=gen, device=dev)
    sharded = apply_param_shardings(copy.deepcopy(whole), mesh, FIELD_MIN_DIM)
    names = dict(whole.named_parameters())

    def run(field, bf16):
        xx = x.clone().requires_grad_()
        with torch.autocast("cuda", torch.bfloat16, enabled=bf16):
            y = field(xx)
        (y.float() * cot).sum().backward()
        grads = {k: (gather_model(p.grad, mesh) if k in field.placements
                     else p.grad) for k, p in field.named_parameters()}
        for p in field.parameters():
            p.grad = None
        return {"out": y.detach().float(), "dx": xx.grad, **grads}

    def timed(fn, reps=5, alone=False):
        fn()
        if not alone:
            mesh.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    out = {"rows": FIELD_ROWS, "placements": sorted(sharded.placements)}
    for bf16 in (False, True):
        key = "bf16" if bf16 else "f32"
        mine = run(sharded, bf16)
        blocks = [torch.zeros((FIELD_ROWS, names[k].shape[0]
                               // mesh.model_size), device=dev,
                              dtype=torch.bfloat16 if bf16 else torch.float32)
                  for k in sharded.placements if k.endswith(".weight")]
        out[key] = {
            "ms": timed(lambda: run(sharded, bf16)),
            "gather_ms": timed(lambda: [gather_model(b, mesh, dim=1)
                                        for b in blocks])}
        with relu_inputs(torch, {"field": sharded}) as calls:
            again = run(sharded, bf16)
        if mesh.global_rank != 0:
            continue
        if any(not torch.equal(again[k], v) for k, v in mine.items()):
            fail(f"mesh2d field {key}: two sharded runs differ")
        with relu_inputs(torch, {"field": whole}) as one_calls:
            one = run(whole, bf16)
        out[key]["whole_ms"] = timed(lambda: run(whole, bf16), alone=True)
        if bf16:
            rel = {k: rel_l2(mine[k], v) for k, v in one.items()}
            # (sharded, whole) bf16 from the whole field's float32
            vs32 = {k: [rel_l2(mine[k], v), rel_l2(one[k], v)]
                    for k, v in one32.items()}
            ratio = {k: a / max(b, 1e-30) for k, (a, b) in vs32.items()
                     if rel[k] > MESH_GRAD_REL_L2}
            out[key].update({"rel_l2": rel, "vs_f32": vs32,
                             "ratio": ratio})
            if ratio and max(ratio.values()) > MESH_VS_F32:
                k = max(ratio, key=ratio.get)
                fail(f"mesh2d field bf16: {k} {rel[k]:.3e} relative L2 from "
                     f"one rank's (tol {MESH_GRAD_REL_L2}) and "
                     f"{vs32[k][0]:.3e} from its float32, {ratio[k]:.2f} "
                     f"times the one rank's bf16 {vs32[k][1]:.3e} (tol "
                     f"{MESH_VS_F32})")
            continue
        one32 = one
        leaf = {id(p): k for k, p in names.items()}
        kinks, upstream = relu_flips(torch, calls, one_calls, leaf,
                                     "mesh2d field f32")
        errs, held = {}, []
        for k, want in one.items():
            got = mine[k]
            atol = FIELD_ATOL * (1.0 if k == "out"
                                 else float(want.abs().max()))
            over = (got - want).abs() - FIELD_RTOL * want.abs() - atol
            errs[k] = float((got - want).abs().max()
                            / max(float(want.abs().max()), 1e-30))
            gated = k == "out" or not (upstream and (k == "dx"
                                                      or k in upstream))
            if gated:
                held.append(k)
                if float(over.max()) > 0:
                    fail(f"mesh2d field f32: {k} off by {errs[k]:.3e} of "
                         f"its peak (rtol {FIELD_RTOL}, atol {FIELD_ATOL})")
        out[key].update({"peak_err": errs, "kinks": kinks,
                         "not_gated": sorted(set(one) - set(held))})
    with torch.no_grad():
        flops = {}
        for name, field in (("rank", sharded), ("whole", whole)):
            with FlopCounterMode(display=False) as counter:
                field(x)
            flops[name] = counter.get_total_flops()
    out["flops"] = flops
    return out


def field_check(torch, tmp, setup=None) -> tuple:
    """Phase 27's (1, FIELD_MODEL) check: this process rank 0, the
    others spawned (each running `setup` first, when given) -> (rank 0's
    results, the others', the wall s)."""
    import multiprocessing

    world = FIELD_MODEL
    init = f"tcp://127.0.0.1:{free_port()}"
    outs = [tmp / f"field_rank{r}.json" for r in range(1, world)]
    ctx = multiprocessing.get_context("spawn")
    children = [ctx.Process(target=field_rank,
                            args=(r, world, init, str(outs[r - 1]), setup),
                            daemon=True) for r in range(1, world)]
    t0 = time.perf_counter()
    for child in children:
        child.start()
    try:
        mesh = card_mesh(world, 0, init, (1, world))
        try:
            r0 = field_model_axis(torch, mesh)
        finally:
            mesh.close()
        for child in children:
            child.join(600)
    finally:
        for child in children:
            if child.is_alive():
                child.kill()
                child.join()
    if any(child.exitcode for child in children):
        fail(f"mesh2d field: ranks exited "
             f"{[child.exitcode for child in children]}")
    return (r0, [json.loads(out.read_text()) for out in outs],
            time.perf_counter() - t0)


def mesh2d_phase(torch, dev, tmp) -> dict:
    """Phase 27: the (1, 2) field (field_check), the (2, 2) full-width
    step against one rank (mesh_run, mesh_gates), every gate fatal, then
    dryrun_multichip(4) on card 0 over gloo and, with 4 cards, over
    NCCL."""
    from neraf_tpu_torch.parallel.dryrun import dryrun_multichip

    smi_line = smi("name,power.limit")
    torch.cuda.empty_cache()
    f0, frest, f_wall = field_check(torch, tmp)
    each = lambda key: [round(r[k][key], 3) for r in (f0, *frest)
                        for k in ("f32", "bf16")]
    print(f"mesh2d field (1, {FIELD_MODEL}), gloo ranks sharing card 0 "
          f"({smi_line}): the full-width acoustic field on {FIELD_ROWS} "
          f"rows, sharded at min_dim {FIELD_MIN_DIM} ({f0['placements']}); "
          f"float32 against one rank's whole field, each output's worst "
          f"error of its peak {json.dumps(f0['f32']['peak_err'])} (rtol "
          f"{FIELD_RTOL}, atol {FIELD_ATOL}; not gated, upstream of a kink: "
          f"{f0['f32']['not_gated']}; kinks {f0['f32']['kinks']}); bf16 "
          f"relative L2 {json.dumps(f0['bf16']['rel_l2'])}, (sharded, whole) "
          f"from float32 {json.dumps(f0['bf16']['vs_f32'])} (beyond "
          f"{MESH_GRAD_REL_L2}: within {MESH_VS_F32} x the whole field's "
          f"distance); fwd + bwd ms a rank, sharded "
          f"{each('ms')} (f32, bf16 of each rank), whole on one rank "
          f"{round(f0['f32']['whole_ms'], 3)}, "
          f"{round(f0['bf16']['whole_ms'], 3)}; the field's all-gathers "
          f"alone {each('gather_ms')} ms; forward FLOPs a rank "
          f"{f0['flops']['rank']:.4e} against "
          f"one rank's {f0['flops']['whole']:.4e} (ratio "
          f"{f0['flops']['rank'] / f0['flops']['whole']:.4f}); wall "
          f"{f_wall:.2f} s. Gloo ranks sharing one card say nothing of the "
          f"model axis's speed.", flush=True)
    torch.cuda.empty_cache()
    r0, rest, wall = mesh_run(torch, dev, tmp, MESH2D_VARIANTS, sweep=False,
                              shape=MESH2D_SHAPE, min_dim=MESH2D_MIN_DIM,
                              extras=False)
    bad, report = mesh_gates(r0, rest, MESH2D_VARIANTS, sweep=False,
                             extras=False)
    if bad:
        fail("; ".join(msg for _, msg in bad))
    steps = [r["variants"]["split"]["steps"] for r in (r0, *rest)]
    per_rank = {f"rank{i}": {
        "ms": [round(s["ms"], 3) for s in st],
        "all_reduce_ms": [round(s["all_reduce_ms"], 3) for s in st],
        "audio_forward_ms": [round(s["stages"]["audio_forward"], 3)
                             for s in st],
        "pe_fwd": sum(s["launches"]["pe_fwd"] for s in st),
        "pe_bwd": sum(s["launches"]["pe_bwd"] for s in st)}
        for i, st in enumerate(steps)}
    print(f"mesh2d step {MESH2D_SHAPE} (data, model), 4 gloo ranks sharing "
          f"card 0 ({smi_line}): full-width bf16 steps each from one rank's "
          f"state, the field sharded at min_dim {MESH2D_MIN_DIM}, the ResNet "
          f"split over the 2 data ranks; per rank {json.dumps(per_rank)}; "
          f"against one rank {json.dumps(report)} (tols: losses "
          f"{MESH_LOSS_RTOL}, gradients {MESH_GRAD_REL_L2} or within "
          f"{MESH_VS_F32} x the one rank's bf16 distance from its float32 "
          f"step, feature {MESH_FEATURE_REL_L2}, statistics "
          f"{MESH_STATS_REL_L2}); replicas bitwise over the 4 ranks and each "
          f"field shard over its data column after every step; wall "
          f"{wall:.2f} s. The shared card's gloo times are not a speed of "
          f"the 2-D mesh.", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dry = dryrun_multichip(4, ["cuda:0"] * 4, backend="gloo")
    dry_s = time.perf_counter() - t0
    print(f"mesh2d dryrun_multichip(4), gloo ranks sharing card 0: "
          f"{dry_s:.2f} s, ranks (data, model) "
          f"{[(r['data'], r['model']) for r in dry]}, sharded "
          f"{dry[0]['sharded']}", flush=True)
    nccl = None
    n_cards = torch.cuda.device_count()
    if n_cards >= 4:
        t0 = time.perf_counter()
        nccl = dryrun_multichip(4)
        print(f"mesh2d dryrun_multichip(4) over NCCL, one card a rank: "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    else:
        print(f"mesh2d dryrun_multichip(4) over NCCL: skipped, {n_cards} "
              f"card here (it needs 4, one a rank)", flush=True)
    return {"field": f0, "per_rank": per_rank, "report": report,
            "wall_s": wall, "dryrun": dry, "dryrun_s": dry_s,
            "nccl": nccl}


def mesh_cli(torch, tmp) -> dict | None:
    """Phase 26, more than one card: cli.train --num-devices 2 (and 4
    where there are 4) over NCCL, one card a rank, at full width on a
    scene as phase 21's, for CLI_STEPS steps with its cadences; each save
    checks the ranks' replicated state bitwise (engine/trainer.py)."""
    from neraf_tpu_torch.cli import train as cli_train
    from neraf_tpu_torch.data.synthetic import (
        write_soundspaces_scene,
        write_vision_scene,
    )

    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        print(f"mesh cli: {n_cards} card here, no multi-card run took place",
              flush=True)
        return None
    scene = write_soundspaces_scene(tmp / "mesh_scenes", 96, 8,
                                    scene="office_4")
    write_vision_scene(scene, n_views=12, size=64)
    base = ["--dataset", "SoundSpaces", "--scene", "office_4", "--data-root",
            str(tmp / "mesh_scenes"), "--max-iters", str(CLI_STEPS)]
    for item in CLI_SET:
        base += ["--set", item]
    out = {}
    for n in (2, 4):
        if n > n_cards:
            continue
        run = tmp / f"mesh_run{n}"
        t0 = time.perf_counter()
        trainer = cli_train.main(base + ["--num-devices", str(n),
                                         "--run-dir", str(run)])
        wall = time.perf_counter() - t0
        records = [json.loads(line) for line in
                   (run / "metrics.jsonl").read_text().splitlines()]
        got = {(r["step"], r["prefix"]) for r in records}
        if got != CLI_RECORDS or len(records) != len(CLI_RECORDS):
            fail(f"mesh cli {n}: metrics records {sorted(got)}")
        if not all(finite_record(r) for r in records):
            fail(f"mesh cli {n}: metrics not finite")
        ckpts = sorted(p.name for p in (run / "neraf_models").iterdir())
        if ckpts != ["step-000000004.pt", "step-000000008.pt"]:
            fail(f"mesh cli {n}: checkpoints {ckpts}")
        steps = [t for s, what, t in trainer.timings if what == "step"]
        out[n] = {"wall_s": wall, "step_ms": [round(1e3 * t, 2) for t in steps]}
        print(f"mesh cli --num-devices {n} (NCCL, {smi('name,power.limit')}): "
              f"{wall:.2f} s; steps (ms, rank 0's host clock) "
              f"{out[n]['step_ms']}; replicas bitwise equal at both saves",
              flush=True)
    return out


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
    reset_counts()
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
    counts = read_counts()
    launches, rir_pe_launches = counts["gl"], counts["pe_fwd"]
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
    # the grid feature folds the grid in its s2d stem: its first device
    # kernels (the cast, the fold, the stem conv) and any on f32 operands
    feat_kernels = device_kernels(torch, pipe.grid_feature)
    print(f"grid feature: {len(feat_kernels)} device kernels, "
          f"{sum(ms for _, ms in feat_kernels):.3f} ms; the first four "
          f"{feat_kernels[:4]}; on f32 operands "
          f"{[k for k in feat_kernels if 'f32f32' in k[0]]}", flush=True)

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
    # the colour branch's kernel on the main field's head: a render
    # chunk's rows, and a bake batch's (4,096 cells x 18 directions)
    fh_rows = {
        "render_chunk": field_head_check(torch, dev, vmodel.field, chunk,
                                         vcfg.num_nerf_samples, 3),
        "bake_batch": field_head_check(torch, dev, vmodel.field, 4096 * 18,
                                       1, 4),
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
    want = {k: 0 for k in vis["launches"]}
    want.update({"pe_mlp": 3 * n_chunks * vis["n_images"],
                 "fh": n_chunks * vis["n_images"]})
    if vis["launches"] != want:
        fail(f"vision path: launches {vis['launches']}, expected {want}")
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
    want.update({"pe_mlp": 2 * n_chunks * n_img, "hash_fwd": n_chunks * n_img,
                 "fh": n_chunks * n_img})
    if hvis["launches"] != want:
        fail(f"hash vision path: launches {hvis['launches']}, expected {want}")
    parts, n_timed = chunk_breakdown(torch, hvpipe, arrays, H, W)
    print(f"hash vision breakdown, mean of {n_timed} chunks (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts.items()), flush=True)
    del hvpipe, hmodel
    torch.cuda.empty_cache()

    # phase 28: NeRAF's published radiance model, hash proposal fields
    nerfacto = nerfacto_phase(torch, dev)

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

    # phase 16: the folded stem's pieces at the step's shape, then the stem
    # weight-gradient kernel on the folded volume against the plain version
    stem_folded_rows = stem_folded(torch, dev, 128, bake)
    stem_rows = {name: stem_check(torch, dev, name, shape, cin, seed)
                 for name, shape, cin, seed in STEM_SHAPES}
    print(f"nvidia-smi clocks.sm,power.draw,power.limit,temp: "
          f"{smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    # phase 17: the full-width joint step with the stem kernel, against
    # phase 10's run with the gate off
    with stem_gate():
        sjpipe = build_joint_pipeline(grid_res=128, tiny=False, device=dev,
                                      seed=0)
    if not sjpipe.stem_wgrad_kernel:
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
          f"kernels vs {wg_off['ms']:.3f} in {wg_off['launches']:g}; the "
          f"stem's device kernels {sjoint['stem_kernels']['ms']:.4f} vs "
          f"{joint['stem_kernels']['ms']:.4f} ms a step", flush=True)
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

    # phases 21 and 22 in one temporary directory: the train and eval CLIs
    # at full width on a scene on disk, then the serving and tool entry
    # points on phase 21's run
    tmp = Path(tempfile.mkdtemp(prefix="neraf_cli_"))
    try:
        t0 = time.perf_counter()
        cli = cli_phase(torch, dev, tmp)
        print(f"phase 21: {time.perf_counter() - t0:.2f} s; the run so far "
              f"{time.perf_counter() - t_start:.2f} s", flush=True)
        print(f"nvidia-smi clocks.sm,power.draw,power.limit,temp: "
              f"{smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")
        t0 = time.perf_counter()
        serving = serving_phase(torch, dev, tmp, cli["argv"], cli["n_eval"],
                                cli["resume"]["gaps"]["resumed_vs_resumed"])
        print(f"phase 22: {time.perf_counter() - t0:.2f} s; the run so far "
              f"{time.perf_counter() - t_start:.2f} s", flush=True)
        print(f"nvidia-smi clocks.sm,power.draw,power.limit,temp: "
              f"{smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")
        t0 = time.perf_counter()
        stream = streaming_phase(torch, dev, tmp, cli)
        cli["launches"].update(stream["cli"]["launches"])
        cli["launches"]["lpips_evaluate"] = stream["lpips"]["cli_evaluate"][
            "launches"]
        print(f"phase 23: {time.perf_counter() - t0:.2f} s; the run so far "
              f"{time.perf_counter() - t_start:.2f} s", flush=True)
        print(f"nvidia-smi clocks.sm,power.draw,power.limit,temp: "
              f"{smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")
        t0 = time.perf_counter()
        raf = raf_phase(torch, dev, tmp)
        cli["launches"].update(raf["launches"])
        print(f"phases 24-25: {time.perf_counter() - t0:.2f} s; the run so "
              f"far {time.perf_counter() - t_start:.2f} s", flush=True)
        print(f"nvidia-smi clocks.sm,power.draw,power.limit,temp: "
              f"{smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")
        t0 = time.perf_counter()
        mesh = mesh_phase(torch, dev, tmp)
        print(f"phase 26: {time.perf_counter() - t0:.2f} s; the run so far "
              f"{time.perf_counter() - t_start:.2f} s", flush=True)
        print(f"nvidia-smi clocks.sm,power.draw,power.limit,temp: "
              f"{smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")
        t0 = time.perf_counter()
        mesh2d = mesh2d_phase(torch, dev, tmp)
        print(f"phase 27: {time.perf_counter() - t0:.2f} s; the run so far "
              f"{time.perf_counter() - t_start:.2f} s", flush=True)
        print(f"nvidia-smi clocks.sm,power.draw,power.limit,temp: "
              f"{smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cli_launches = lambda k: {run: c[k] for run, c in cli["launches"].items()}
    mesh_launches = lambda k: {rank: r[k] for rank, r in mesh["per_rank"].items()}
    mesh2d_launches = lambda k: {rank: r[k]
                                 for rank, r in mesh2d["per_rank"].items()}
    viewer_launches = lambda k: {
        name: r["launches"][k]
        for name, r in serving["viewer"]["requests"].items()}
    serving_launches = lambda k: {
        "cli_train_hash": serving["train_hash"]["launches"][k],
        "cli_render": serving["render"]["launches"][k],
        "cli_render_hash": serving["render_hash"]["launches"][k],
        "cli_loudness": serving["loudness"]["launches"][k],
        "trajectory": serving["trajectory"]["launches"][k],
        "live_viewer_train": serving["live_viewer"]["launches"][k],
        "viewer": viewer_launches(k)}

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
        "mesh_sweep_launches_per_rank": mesh_launches("sweep_gl"),
        "ms": gl_row["ms"], "plain_ms": gl_row["plain_ms"],
        "bound_ms": gl_bound, "bound_by": gl_by, "library_ms": None,
        "max_abs_err_32_iter": gl_row["err32"], "plan": gl_row["plan"],
        "eval_sweep_launches": {
            k: evals[k]["gl_launches"]
            for k in ("evaluate_audio", "evaluate_audio_device")},
        "cli_launches": cli_launches("gl"),
        "serving_launches": serving_launches("gl"),
        "serving_channels": {str(M): {k: row[k] for k in (
            "err", "err32", "ms", "plain_ms", "bound_ms", "bound_by", "plan")}
            for M, row in serving["gl"].items()}}, {
        "name": "pe_mlp_fwd", "route": "cuda",
        "source": "neraf_tpu_torch/csrc/pe_mlp.cu",
        "replaces": "neraf_tpu/ops/pallas/fused_pe_mlp.py:373",
        "launches": vis_launches, "max_abs_err": main_bf16["max_abs_err"],
        "ms": main_bf16["ms"], "plain_ms": main_bf16["plain_ms"],
        "bound_ms": fwd_bound, "bound_by": fwd_by, "library_ms": None,
        "train_step_launches": joint["pe_fwd"], "shapes": pe_rows,
        "mesh_step_launches_per_rank": mesh_launches("pe_fwd"),
        "mesh2d_step_launches_per_rank": mesh2d_launches("pe_fwd"),
        "streamed_train_step_launches": stream["step"]["streamed"][
            "launches"]["pe_fwd"],
        "hash_render_launches": hvis["launches"]["pe_mlp"],
        "hash_train_step_launches": hjoint["pe_fwd"],
        "eval_launches": {k: evals[k]["pe_launches"] for k in (
            "eval_loss_dict", "eval_image", "query_grid_full")},
        "cli_launches": cli_launches("pe_fwd"),
        "serving_launches": serving_launches("pe_fwd"),
        "train_step_device_kernels": {"pe_mlp_bf16_kernel":
                                      kern["pe_mlp_bf16_kernel"]}}, {
        "name": "pe_mlp_bwd", "route": "cuda",
        "source": "neraf_tpu_torch/csrc/pe_mlp_bwd.cu",
        "replaces": "neraf_tpu/ops/pallas/fused_pe_mlp.py:298",
        "launches": joint["pe_bwd"], "max_abs_err": bwd_main["max_abs_err"],
        "mesh_step_launches_per_rank": mesh_launches("pe_bwd"),
        "mesh2d_step_launches_per_rank": mesh2d_launches("pe_bwd"),
        "streamed_train_step_launches": stream["step"]["streamed"][
            "launches"]["pe_bwd"],
        "rel_l2_vs_plain": bwd_rows["main_field"]["rel_l2_vs_plain"],
        "ms": bwd_main["ms"], "plain_ms": bwd_main["plain_ms"],
        "bound_ms": bwd_main["bound_ms"], "bound_by": bwd_main["bound_by"],
        "library_ms": None, "shapes": bwd_rows,
        "hash_train_step_launches": hjoint["pe_bwd"],
        "cli_launches": cli_launches("pe_bwd"),
        "serving_launches": serving_launches("pe_bwd"),
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
        "nerfacto": {
            "render_launches": nerfacto["render"]["launches"]["hash_fwd"],
            "train_step_launches": nerfacto["joint"]["hash_fwd"],
            "shapes": {k: {"rows": r["rows"], "max_abs_err": r["max_abs_err"]["forward"],
                           "ms": r["fwd_ms"], "plain_ms": r["fwd_plain_ms"],
                           "bound_ms": r["fwd_bound_ms"], "bound_by": r["fwd_bound_by"]}
                       for k, r in nerfacto["hash"].items()}},
        "serving_launches": serving_launches("hash_fwd"),
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
        "nerfacto": {
            "train_step_launches": nerfacto["joint"]["hash_bwd"],
            "shapes": {k: {"rows": r["rows"], "max_abs_err": r["max_abs_err"]["d_table"],
                           "ms": r["bwd_ms"], "plain_ms": r["bwd_plain_ms"],
                           "bound_ms": r["bwd_bound_ms"], "bound_by": r["bwd_bound_by"]}
                       for k, r in nerfacto["hash"].items()}},
        "serving_launches": serving_launches("hash_bwd"),
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
        "folded_stem": stem_folded_rows,
        "train_step_stem_kernels": {"gate_on": sjoint["stem_kernels"],
                                    "gate_off": joint["stem_kernels"]},
        "gate_off_resnet_ms": joint["stem_ms"],
        "gate_on_resnet_ms": sjoint["stem_ms"],
        "mesh_split_step_launches_per_rank": mesh_launches("stem_split"),
        "mesh_slabs": mesh["stem_slabs"]}, {
        "name": "shifted_value_concat", "route": "cuda",
        "source": "neraf_tpu_torch/csrc/shifted_concat.cu",
        "replaces": "neraf_tpu/ops/pallas/gl_crash_repro.py:48",
        # on no path: the launches are phase 19's own calls
        "launches": concat["launches"], "max_abs_err": 0.0,
        "ms": concat["ms"], "plain_ms": concat["plain_ms"],
        "bound_ms": concat["bound_ms"], "bound_by": "bytes",
        "library_ms": concat["plain_ms"]}, {
        "name": "field_head", "route": "cuda",
        "source": "neraf_tpu_torch/csrc/field_head.cu",
        # no TPU kernel: a fusion the port adds (XLA fuses the chain in the
        # JAX package); "launches" are phase 7's render path's
        "replaces": None,
        "launches": vis["launches"]["fh"],
        **{k: fh_rows["render_chunk"][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None, "shapes": fh_rows,
        "train_step_launches": joint["fh"],
        "hash_render_launches": hvis["launches"]["fh"],
        # Nerfacto's head, 2 hidden layers: its render's launches and rows
        "nerfacto": {"launches": nerfacto["render"]["launches"]["fh"],
                     "shapes": {k: {c: r[c] for c in (
                         "rows", "S", "max_abs_err", "ms", "plain_ms", "bound_ms",
                         "bound_by")} for k, r in nerfacto["field_head"].items()}},
        "eval_launches": {k: evals[k]["fh_launches"] for k in (
            "eval_loss_dict", "eval_image", "query_grid_full")},
        "cli_launches": cli_launches("fh"),
        "serving_launches": serving_launches("fh")}]}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
