"""The port's fused PE+MLP (neraf_tpu_torch/ops/pe_mlp.py) against the JAX
Pallas kernel in interpret mode and its plain reference.

On the CPU `pe_mlp` runs the plain version; the CUDA kernel is held against
it on a card (marked `cuda`, skipped here). JAX is imported inside the
tests that use it, so the `cuda` tests also run where JAX is not installed.
Tolerances: rtol 2e-4 and atol 2e-5 against the JAX kernel in f32, the JAX
package's own bound for its kernel against the layer chain
(tests/test_fused_pe_mlp.py).
"""

import numpy as np
import pytest
import torch

from neraf_tpu_torch.ops.cuda import pe_mlp as pe_mlp_cuda_mod
from neraf_tpu_torch.ops.pe_mlp import (
    pack_layers,
    pe_mlp,
    pe_mlp_plain,
    split_first_layer,
)

CASES = [(6, 32, 2, 1), (4, 24, 4, 8)]  # (F, H, hidden layers, O)


def _rand_params(rng, F, H, L, O):
    """flax-layout (in, out) weights, as tests/test_fused_pe_mlp.py makes them."""
    dims = [6 * F + 3] + [H] * L + [O]
    return [(rng.randn(dims[i], dims[i + 1]).astype(np.float32)
             * np.float32(dims[i] ** -0.5),
             (rng.randn(dims[i + 1]) * 0.01).astype(np.float32))
            for i in range(len(dims) - 1)]


def _torch_layers(params, device="cpu", dtype=torch.float32):
    return [(torch.tensor(w.T, dtype=dtype, device=device),
             torch.tensor(b, dtype=dtype, device=device)) for w, b in params]


def _jax_ref_mlp(x, params, F):
    import jax.numpy as jnp

    from neraf_tpu.ops.encodings import nerf_encoding as jnerf_encoding

    h = jnerf_encoding(jnp.asarray(x), num_frequencies=F)
    for w, b in params[:-1]:
        h = jnp.maximum(h @ w + b, 0.0)
    w, b = params[-1]
    return np.asarray(h @ w + b)


@pytest.mark.parametrize("F,H,L,O", CASES)
def test_pe_mlp_matches_jax_interpret_and_reference(F, H, L, O):
    import jax.numpy as jnp

    from neraf_tpu.ops.pallas.fused_pe_mlp import pe_mlp as jpe_mlp

    rng = np.random.RandomState(0)
    n = 300  # not a multiple of the JAX block: its padding is exercised
    x = rng.rand(n, 3).astype(np.float32)
    params = _rand_params(rng, F, H, L, O)
    before = pe_mlp_cuda_mod.LAUNCHES
    out = pe_mlp(torch.from_numpy(x), _torch_layers(params), F, 0.0, 8.0,
                 torch.float32)
    assert pe_mlp_cuda_mod.LAUNCHES == before  # a CPU tensor: plain version
    assert out.shape == (n, O) and out.dtype == torch.float32
    jparams = [(jnp.asarray(w), jnp.asarray(b)) for w, b in params]
    ref_kernel = np.asarray(jpe_mlp(jnp.asarray(x), jparams, F, 0.0, 8.0,
                                    jnp.float32, 256, True))
    np.testing.assert_allclose(out.numpy(), ref_kernel, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(out.numpy(), _jax_ref_mlp(x, jparams, F),
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("F,H,L,O", CASES)
def test_first_layer_split_and_pack_round_trip(F, H, L, O):
    """split_first_layer cuts layer 0 into its sin/cos/x blocks, and the
    kernel's packed layer 0 (interleaved sin/cos columns, zero padding)
    gives the original weight back; every other layer is zero-padded."""
    layers = _torch_layers(_rand_params(np.random.RandomState(1), F, H, L, O))
    w0 = layers[0][0]
    w_sin, w_cos, w_x = split_first_layer(w0, F)
    assert w_sin.shape == w_cos.shape == (H, 3 * F) and w_x.shape == (H, 3)
    torch.testing.assert_close(torch.cat([w_sin, w_cos, w_x], 1), w0,
                               rtol=0, atol=0)

    w, b, dims = pack_layers(layers, F, torch.float32)
    hp, k0p, op = dims["hp"], dims["k0p"], dims["op"]
    assert hp >= H and hp % 16 == 0 and k0p % 16 == 0 and k0p >= 6 * F + 3
    assert dims["n_hidden"] == L and dims["out_dim"] == O and op % 8 == 0
    first = w[:hp * k0p].reshape(hp, k0p)
    rebuilt = torch.cat([first[:H, 0:6 * F:2], first[:H, 1:6 * F:2],
                         first[:H, 6 * F:6 * F + 3]], 1)
    torch.testing.assert_close(rebuilt, w0, rtol=0, atol=0)
    assert not first[H:].any() and not first[:, 6 * F + 3:].any()
    off = hp * k0p
    for wi, _ in layers[1:-1]:
        blk = w[off:off + hp * hp].reshape(hp, hp)
        torch.testing.assert_close(blk[:H, :H], wi, rtol=0, atol=0)
        assert not blk[H:].any() and not blk[:, H:].any()
        off += hp * hp
    out_blk = w[off:].reshape(op, hp)
    torch.testing.assert_close(out_blk[:O, :H], layers[-1][0], rtol=0, atol=0)
    biases = torch.cat([torch.nn.functional.pad(bi, (0, hp - H))
                        for _, bi in layers[:-1]]
                       + [torch.nn.functional.pad(layers[-1][1], (0, op - O))])
    torch.testing.assert_close(b, biases, rtol=0, atol=0)


def test_split_first_layer_rejects_wrong_width():
    with pytest.raises(ValueError, match="inputs"):
        split_first_layer(torch.zeros(8, 40), 6)


def test_pe_mlp_plain_promotes_float64():
    """The f32 card check holds the kernel against the plain version in
    float64; the chain keeps float64 end to end."""
    rng = np.random.RandomState(2)
    params = _rand_params(rng, 6, 32, 2, 1)
    x = torch.from_numpy(rng.rand(50, 3))
    out = pe_mlp_plain(x, _torch_layers(params, dtype=torch.float64), 6,
                       dtype=torch.float64)
    assert out.dtype == torch.float64
    ref = pe_mlp_plain(x.float(), _torch_layers(params), 6)
    # the f32 chain rounds angles of up to 2^8 turns: ~1e-4 rad of phase
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-3, atol=1e-4)


def test_pe_mlp_cuda_rejects_other_devices():
    layers = [(torch.zeros(32, 39, device="meta"), torch.zeros(32, device="meta")),
              (torch.zeros(1, 32, device="meta"), torch.zeros(1, device="meta"))]
    with pytest.raises(ValueError, match="unsupported device"):
        pe_mlp_cuda_mod.pe_mlp_cuda(torch.zeros(4, 3, device="meta"), layers, 6)


@pytest.mark.cuda
@pytest.mark.parametrize("F,H,L,O", CASES)
def test_pe_mlp_kernel_matches_plain_on_card(F, H, L, O):
    """Kernel against the plain version on the card at n = 300: f32 against
    the plain chain in float64 (the f32 chain's own angle rounding is
    ~3e-5 of the peak; the kernel reduces angles exactly), rtol 2e-4 and
    atol 2e-5 of the peak. bf16: bf16 rounding sites differ (the kernel
    adds biases in f32 before one cast, the plain chain rounds the product
    and the bias add), so against the plain bf16 chain to 3e-2 of the peak,
    and against float64 no further off than 1.5 times the plain bf16
    chain's own error (an emulation of the kernel's rounding on the CPU
    gave at most 1.1 times over ten seeds)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    rng = np.random.RandomState(3)
    params = _rand_params(rng, F, H, L, O)
    x = torch.from_numpy(rng.rand(300, 3).astype(np.float32)).cuda()
    ref = pe_mlp_plain(x.double(), _torch_layers(params, "cuda", torch.float64),
                       F, dtype=torch.float64)
    peak = float(ref.abs().max())
    layers = _torch_layers(params, "cuda")
    before = pe_mlp_cuda_mod.LAUNCHES
    out = pe_mlp(x, layers, F, dtype=torch.float32)
    torch.cuda.synchronize()
    assert pe_mlp_cuda_mod.LAUNCHES == before + 1
    excess = ((out.double() - ref).abs() - 2e-4 * ref.abs()).max()
    assert float(excess) <= 2e-5 * peak
    out16 = pe_mlp(x, layers, F, dtype=torch.bfloat16)
    plain16 = pe_mlp_plain(x, layers, F, dtype=torch.bfloat16)
    assert float((out16 - plain16).abs().max()) <= 3e-2 * peak
    err16 = float((out16.double() - ref).abs().max())
    assert err16 <= 1.5 * float((plain16.double() - ref).abs().max())
