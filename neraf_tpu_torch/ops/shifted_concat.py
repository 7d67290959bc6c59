"""The shifted-slice concat: the plain version and the kernel dispatch
(counterpart of neraf_tpu/ops/pallas/gl_crash_repro.py).

For x (M, ROWS, HOP) float32 and t <= ROWS - 1, the concat of two
row-shifted slices along the last axis, (M, t, 2 HOP):
out[:, r] = [x[:, r], x[:, r + 1]], the two-strip framing of the JAX
package's Griffin-Lim, which the TPU compiler could not build and which the
JAX package keeps as a compiler canary (its test shape is M 8, ROWS 19, t
16, HOP 128; hop 256, the RAF geometry, also crashed it). No path of the
port runs it: the port's Griffin-Lim frames with torch.stft and its own
kernel.

``shifted_value_concat`` runs the plain version for a CPU tensor and the
CUDA copy kernel (csrc/shifted_concat.cu through
ops/cuda/shifted_concat.py) for a CUDA tensor, with no fallback between
them.
"""

from __future__ import annotations

import torch


def shifted_value_concat_plain(x: torch.Tensor, t: int) -> torch.Tensor:
    """torch.cat([x[:, :t], x[:, 1:t + 1]], -1)."""
    return torch.cat([x[:, :t], x[:, 1:t + 1]], -1)


def shifted_value_concat(x: torch.Tensor, t: int) -> torch.Tensor:
    """(M, ROWS, HOP) f32 -> (M, t, 2 HOP): the plain version for a CPU
    tensor, the CUDA kernel for a CUDA tensor (or it raises)."""
    if x.device.type == "cpu":
        return shifted_value_concat_plain(x, t)
    from neraf_tpu_torch.ops.cuda.shifted_concat import shifted_value_concat_cuda

    return shifted_value_concat_cuda(x, t)
