"""Wrapper of the Griffin-Lim CUDA kernel (csrc/griffin_lim.cu).

Replaces neraf_tpu/ops/pallas/griffin_lim_kernel.py::griffin_lim_pallas. The
kernel runs the whole momentum loop for one channel inside one block, with
the signal resident in shared memory. A block runs one residue class of
frames at a time (gl_launch_plan: as many warps as a class has frames, or an
even share of them); a warp takes a frame through an FFT held in registers
(R = n_fft/64 points a lane, two exchanges through shared memory a
transform, three at n_fft 256) and the split step by warp shuffles, and copies its next frame's
per-bin state into shared memory ahead of time. It is bound by the latency
of those chains and the barrier between classes, then by the per-bin state's
traffic through the L2 (see the source's note).

A CPU tensor takes the plain version (dsp/griffin_lim.py::griffin_lim_plain);
a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from neraf_tpu_torch.dsp.stft import _padded_window_np, _wsq_np

LAUNCHES = 0  # kernel launches since the last reset; chip_smoke.py reads it

# H100 (sm_90): the dynamic shared memory a block may opt in to (228 KB an SM
# less the 1 KB the driver reserves beside each resident block). The
# launcher reads the card's own limit and refuses a plan over it.
SMEM_PER_BLOCK = 232_448
# the kernel's most warps a block, by n_fft (csrc/griffin_lim.cu::max_warps:
# its launch bound sizes the registers for this many)
MAX_WARPS = {256: 20, 512: 20, 1024: 8}


class GLPlan(NamedTuple):
    warps: int       # warps a block (one frame each at a time)
    smem_bytes: int  # dynamic shared memory a block


def gl_smem_bytes(n_fft: int, hop: int, T: int, length: int,
                  warps: int) -> int:
    """A block's shared memory, as csrc/griffin_lim.cu lays it out
    (`gl_base_bytes`, `gl_warp_bytes`, which the launcher checks the plan
    against), mirrored here so that the plan is made, and pinned by the CPU
    tests, without the card: the split step's twiddles (P float2); a warp's
    exchange buffer (P float2) and its staging of a frame's state ((P + 1)
    float2 and P + 2 floats); the window, the signal and the overlap-add
    accumulator."""
    P = n_fft // 2
    per_warp = P * 8 + (P + 1) * 8 + (P + 2) * 4
    return P * 8 + warps * per_warp + (2 * n_fft + length + hop * (T - 1)) * 4


def gl_launch_plan(n_fft: int, hop: int, T: int, length: int) -> GLPlan:
    """Warps a block and its shared memory. The frames t = r mod n_fft/hop
    form a residue class (its frames do not overlap) and the block runs one
    class at a time, so each class runs in the fewest rounds that fit, its
    frames spread evenly over them: warps = ceil(frames / rounds). At
    SoundSpaces that is one block of 20 warps an SM; 10 and 16 warps in two
    rounds, and two blocks of 10 an SM, ran slower on an H100 (PERF.md)."""
    frames = -(-T // (n_fft // hop))  # frames in the largest class
    for rounds in range(1, frames + 1):
        warps = -(-frames // rounds)
        smem = gl_smem_bytes(n_fft, hop, T, length, warps)
        if warps <= MAX_WARPS[n_fft] and smem <= SMEM_PER_BLOCK:
            return GLPlan(warps, smem)
    raise ValueError(f"griffin_lim_cuda: n_fft={n_fft} hop={hop} T={T} "
                     f"length={length} does not fit one block's shared memory")


@functools.lru_cache(maxsize=16)
def _constants(n_fft: int, hop: int, win_length: int, n_frames: int,
               length: int, device: torch.device):
    """Twiddles, window and 1/wsq, computed in float64 on the host."""
    ang = 2.0 * np.pi * np.arange(n_fft) / n_fft
    tw = np.stack([np.cos(ang), -np.sin(ang)], axis=-1)  # exp(-2 pi i j / N)
    win = _padded_window_np(n_fft, win_length)
    inv_wsq = 1.0 / np.asarray(_wsq_np(n_fft, hop, win_length, n_frames, length))
    as_dev = lambda a: torch.as_tensor(a.astype(np.float32), device=device)
    return as_dev(tw), as_dev(win), as_dev(inv_wsq)


def griffin_lim_cuda(
    mag: torch.Tensor,
    init_angles: torch.Tensor,
    *,
    n_fft: int,
    hop_length: int,
    win_length: int | None = None,
    n_iter: int = 32,
    momentum: float = 0.99,
    length: int | None = None,
) -> torch.Tensor:
    """(..., F, T) f32 magnitudes + complex64 unit phasors -> (..., length)."""
    global LAUNCHES
    win_length = n_fft if win_length is None else win_length
    F, T = mag.shape[-2:]
    length = hop_length * (T - 1) if length is None else length
    if mag.device.type == "cpu":
        from neraf_tpu_torch.dsp.griffin_lim import griffin_lim_plain

        return griffin_lim_plain(
            mag, n_fft=n_fft, hop_length=hop_length, win_length=win_length,
            n_iter=n_iter, momentum=momentum, length=length,
            init_angles=init_angles)
    if mag.device.type != "cuda":
        raise ValueError(f"griffin_lim_cuda: unsupported device {mag.device}")
    if init_angles.device != mag.device:
        raise ValueError("griffin_lim_cuda: mag and init_angles on different "
                         f"devices ({mag.device}, {init_angles.device})")
    if mag.dtype != torch.float32 or init_angles.dtype != torch.complex64:
        raise TypeError("griffin_lim_cuda: needs float32 mag and complex64 "
                        f"angles, got {mag.dtype} and {init_angles.dtype}")
    if init_angles.shape != mag.shape:
        raise ValueError(f"griffin_lim_cuda: angles {tuple(init_angles.shape)}"
                         f" != mag {tuple(mag.shape)}")
    if not (mag.is_contiguous() and init_angles.is_contiguous()):
        raise ValueError("griffin_lim_cuda: inputs must be contiguous")
    if (n_fft not in (256, 512, 1024) or n_fft % hop_length
            or (n_fft // 2) % hop_length or F != n_fft // 2 + 1
            or length != hop_length * (T - 1) or win_length > n_fft
            or length <= n_fft // 2):
        raise ValueError(
            "griffin_lim_cuda: needs n_fft 256, 512 or 1024, F == "
            "n_fft/2+1, hop | n_fft/2 and length == hop*(T-1) > n_fft/2; got "
            f"n_fft={n_fft} hop={hop_length} win={win_length} F={F} T={T} "
            f"length={length}")

    from neraf_tpu_torch.ops.cuda import build

    lib = build.load()
    lead = mag.shape[:-2]
    M = int(np.prod(lead)) if lead else 1
    out = torch.empty((M, length), dtype=torch.float32, device=mag.device)
    if M == 0:
        return out.reshape(*lead, length)
    tw, win, inv_wsq = _constants(n_fft, hop_length, win_length, T, length,
                                  mag.device)
    plan = gl_launch_plan(n_fft, hop_length, T, length)
    tprev = torch.empty((M, T, F, 2), dtype=torch.float32, device=mag.device)
    mag_t = torch.empty((M, T, F), dtype=torch.float32, device=mag.device)
    with torch.cuda.device(mag.device):
        stream = torch.cuda.current_stream(mag.device).cuda_stream
        err = lib.neraf_gl_launch(
            mag.data_ptr(), init_angles.data_ptr(), tw.data_ptr(),
            win.data_ptr(), inv_wsq.data_ptr(), tprev.data_ptr(),
            mag_t.data_ptr(), out.data_ptr(), M, T, n_fft, hop_length,
            length, n_iter, momentum / (1.0 + momentum), *plan, stream)
    build.check(lib, err, "griffin_lim kernel launch")
    LAUNCHES += 1
    return out.reshape(*lead, length)
