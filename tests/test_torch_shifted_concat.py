"""The port's shifted-slice concat (ops/shifted_concat.py) against the JAX
package's Pallas canary kernel, gl_crash_repro._crash_kernel, run in
interpret mode as tests/test_pallas_gl.py runs it: bitwise equal at the
canary's shape (M 8, ROWS 19, t 16, HOP 128), and against numpy's concat at
hop 256 (the RAF geometry) and t 78 (SoundSpaces' frames). The CUDA kernel
is held against the plain version on a card (marked `cuda`, skipped here);
the JAX package is imported inside the test that uses it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from neraf_tpu_torch.ops import shifted_concat as sc
from neraf_tpu_torch.ops.cuda import shifted_concat as sc_cuda
from neraf_tpu_torch.utils.profiling import counters

SHAPES = [(8, 19, 128, 16), (8, 19, 256, 16), (1024, 79, 128, 78),
          (3, 7, 5, 6)]  # (M, ROWS, HOP, t); the last takes the scalar path


def test_plain_matches_pallas_canary_in_interpret_mode():
    from neraf_tpu.ops.pallas import gl_crash_repro as R

    x = np.random.default_rng(0).normal(size=(R.M, R.ROWS, R.HOP)).astype(
        np.float32)
    want = pl.pallas_call(
        R._crash_kernel,
        out_shape=jax.ShapeDtypeStruct((R.M, R.T, 2 * R.HOP), jnp.float32),
        interpret=True,
    )(jnp.asarray(x))
    got = sc.shifted_value_concat(torch.from_numpy(x), R.T)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m,rows,hop,t", SHAPES)
def test_plain_matches_numpy_concat(m, rows, hop, t):
    x = np.random.default_rng(rows + hop).normal(size=(m, rows, hop)).astype(
        np.float32)
    got = sc.shifted_value_concat_plain(torch.from_numpy(x), t)
    want = np.concatenate([x[:, :t], x[:, 1:t + 1]], -1)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("x,t,err,match", [
    (torch.zeros(8, 19, 128, device="meta"), 16, ValueError, "unsupported device"),
    (torch.zeros(8, 19, 128), 16, ValueError, "unsupported device"),
])
def test_cuda_wrapper_refuses_other_devices(x, t, err, match):
    with pytest.raises(err, match=match):
        sc_cuda.shifted_value_concat_cuda(x, t)


@pytest.mark.cuda
@pytest.mark.parametrize("m,rows,hop,t", SHAPES)
def test_shifted_concat_kernel_matches_plain_on_card(m, rows, hop, t):
    """Bitwise equal to torch.cat of the two slices; one launch; t past
    ROWS - 1 refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    x = torch.randn((m, rows, hop), generator=torch.Generator().manual_seed(m)).cuda()
    n = counters().get("kernel.shifted_concat", 0)
    got = sc.shifted_value_concat(x, t)
    torch.cuda.synchronize()
    assert counters().get("kernel.shifted_concat", 0) == n + 1
    assert torch.equal(got, sc.shifted_value_concat_plain(x, t))
    with pytest.raises(ValueError, match="rows"):
        sc.shifted_value_concat(x, rows)
