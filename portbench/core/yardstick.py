"""Work counted from the configuration's shapes, and the card's peaks.

Published peaks of one NVIDIA H100 SXM (dense): 989 TFLOP/s bf16, 67
TFLOP/s float32 off the tensor cores, 3.35 TB/s of HBM, at its full 700 W
(a card set lower reads lower against them; the run prints its limit).
A bound is the least time of a piece of work: max(its operations at the
peak of their type, the bytes it must move at the memory rate). Nothing
here reads a launch count or a kernel name, so a bound is the same
whatever computes the work.
"""

from __future__ import annotations

import math

from portbench.reference import neraf as ref

H100_BF16, H100_F32, H100_BYTES = 989e12, 67e12, 3.35e12


def bound_ms(flops: float, nbytes: float, rate: float = H100_BF16) -> float:
    return max(flops / rate, nbytes / H100_BYTES) * 1e3


def mlp_flops(dims, rows: int) -> float:
    """Multiply-adds x 2 of a dense chain dims[0] -> dims[1] -> ... on rows."""
    return 2.0 * rows * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def pe_dims(v: dict, which: str):
    if which == "proposal":
        p = v["proposal"]
        return [6 * p["num_frequencies"] + 3] + [p["width"]] * p["layers"] + [1]
    return ([6 * v["num_frequencies"] + 3] + [v["base_mlp_width"]] * v["base_mlp_layers"]
            + [1 + v["geo_feat_dim"]])


def _base_dims(v: dict):
    if v["encoding"] == "hash":
        h = v["hash"]
        return [ref.hash_out_dim(v), h["hidden_dim"], h["hidden_dim"], 1 + v["geo_feat_dim"]]
    return pe_dims(v, "main")


def _head_dims(v: dict):
    hc = v["hidden_dim_color"]
    return [ref.SH_DIM + v["geo_feat_dim"] + v["appearance_embed_dim"], hc, hc, hc, 3]


def pe_mlp_bound_ms(calls) -> float:
    """Least time of the PE+MLP calls: the forward's products (bf16) against
    x and the output's bytes; a backward adds the weight gradients' products
    and the hidden layers' input gradients (layer 0's too with dx), against
    x, the output cotangent and dx."""
    total = 0.0
    for dims, _, n, backward, need_dx in calls:
        fwd = mlp_flops(dims, n)
        total += bound_ms(fwd, n * (12 + 4 * dims[-1]))
        if backward:
            flops = 2.0 * fwd - (0.0 if need_dx else 2.0 * n * dims[0] * dims[1])
            total += bound_ms(flops, n * (12 + 4 * dims[-1] + (12 if need_dx else 0)))
    return total


def gl_bound_ms(channels: int, n_fft: int, frames: int, n_iter: int = 32) -> float:
    """Least time of Griffin-Lim on `channels` spectrograms: per iteration a
    real FFT and an inverse of n_fft a frame (2.5 N log2 N flops each) and
    ~20 flops a bin of projection and momentum, float32 on the CUDA cores;
    against the bytes of the magnitudes, the initial phasors and the
    waveforms."""
    F = n_fft // 2 + 1
    flops = n_iter * channels * frames * (2 * 2.5 * n_fft * math.log2(n_fft) + 20 * F)
    nbytes = channels * F * frames * (4 + 8) + channels * (frames - 1) * (n_fft // 4) * 4
    return bound_ms(flops, nbytes, H100_F32)


def hash_fwd_bound_ms(v: dict, points: int) -> float:
    """Least time of the hash encoding's forward on `points`: per point and
    level the position, floor and fraction, then per corner its weight and
    F multiply-adds, float32; against the bytes of the points and the
    features written. The table rows read are left out (they depend on the
    points), so the bound is low and the share it gives is a floor."""
    h = v["hash"]
    L, Fd = h["num_levels"], h["features_per_level"]
    flops = points * L * (9 + 8 * (2 + 2 * Fd))
    return bound_ms(flops, points * (12 + 4 * L * Fd), H100_F32)


def conv_flops(spec_audio: dict, res: int) -> tuple:
    """Forward products of the 3D ResNet over an R^3 grid -> (all convs,
    the stem alone)."""
    d = (res + 2 * 2 - 5) // 2 + 1
    stem = 2.0 * 64 * ref.GRID_CHANNELS * 125 * d ** 3
    d = (d + 2 - 3) // 2 + 1  # max pool
    total = stem
    for _, cin, planes, stride, bottleneck, down in ref.resnet_stages(spec_audio):
        d_out = (d - 1) // stride + 1
        if bottleneck:
            total += 2.0 * planes * cin * d ** 3
            total += 2.0 * planes * planes * 27 * d_out ** 3
            total += 2.0 * 4 * planes * planes * d_out ** 3
            out = 4 * planes
        else:
            total += 2.0 * planes * cin * 27 * d_out ** 3
            total += 2.0 * planes * planes * 27 * d_out ** 3
            out = planes
        if down:
            total += 2.0 * out * cin * d_out ** 3
        d = d_out
    return total, stem


def field_flops(spec_audio: dict, rows: int) -> float:
    a = spec_audio
    dims = [ref.audio_in_dim(a), *a["trunk"], a["w_field"]]
    return mlp_flops(dims, rows) + a["mic_ch"] * 2.0 * rows * a["w_field"] * a["n_freq_stft"]


def vision_fwd_flops(v: dict, rays: int, bake_points: int = 0) -> float:
    """The proposal fields on every ray's proposal samples, the main field
    (base and colour head) on its samples and on the bake's points."""
    n0, n1 = v["num_proposal_samples"]
    prop = mlp_flops(pe_dims(v, "proposal"), rays * (n0 + n1))
    pts = rays * v["num_nerf_samples"] + bake_points
    return prop + mlp_flops(_base_dims(v), pts) + mlp_flops(_head_dims(v), pts)
