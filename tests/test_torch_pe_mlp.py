"""The port's fused PE+MLP (neraf_tpu_torch/ops/pe_mlp.py) against the JAX
Pallas kernel in interpret mode and its plain reference.

On the CPU `pe_mlp` runs the plain version; the CUDA kernel is held against
it on a card (marked `cuda`, skipped here). JAX is imported inside the
tests that use it, so the `cuda` tests also run where JAX is not installed.
Tolerances: rtol 2e-4 and atol 2e-5 against the JAX kernel in f32, the JAX
package's own bound for its kernel against the layer chain
(tests/test_fused_pe_mlp.py); gradients rtol 2e-3 and atol 1e-4 of each
tensor's peak, that test's bound, on rows with no pre-activation within
f32 noise of 0 (such a unit's ReLU subgradient flips between orderings).
"""

import numpy as np
import pytest
import torch

from neraf_tpu_torch.ops.cuda import pe_mlp as pe_mlp_cuda_mod
from neraf_tpu_torch.ops.pe_mlp import (
    pack_layers,
    pe_mlp,
    pe_mlp_plain,
    pe_mlp_vjp_plain,
    split_first_layer,
    unpack_layers,
)

CASES = [(6, 32, 2, 1), (4, 24, 4, 8)]  # (F, H, hidden layers, O)
# the two field architectures of the training step: proposal, main field
FIELD_CASES = [(6, 128, 2, 1), (10, 256, 4, 16)]


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


def _jax_chain(x, params, F):
    import jax.numpy as jnp

    from neraf_tpu.ops.encodings import nerf_encoding as jnerf_encoding

    h = jnerf_encoding(jnp.asarray(x), num_frequencies=F)
    for w, b in params[:-1]:
        h = jnp.maximum(h @ w + b, 0.0)
    w, b = params[-1]
    return h @ w + b


def _jax_ref_mlp(x, params, F):
    return np.asarray(_jax_chain(x, params, F))


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


def _clear_rows(x, params, F):
    """Rows whose every pre-activation is away from 0 (numpy replica of the
    forward, as tests/test_fused_pe_mlp.py filters them)."""
    freqs = (2.0 ** np.linspace(0, 8, F)).astype(np.float32)
    ang = ((2 * np.pi * x)[..., None] * freqs).reshape(x.shape[0], -1)
    h = np.concatenate([np.sin(ang), np.sin(ang + np.pi / 2), x], -1)
    keep = np.ones(x.shape[0], bool)
    for w, b in params[:-1]:
        pre = h @ w + b
        keep &= (np.abs(pre) > 1e-4 * np.abs(pre).max()).all(axis=-1)
        h = np.maximum(pre, 0.0)
    assert keep.sum() >= x.shape[0] // 2
    return x[keep]


def _assert_grads_close(got, ref):
    """got, ref: [dx, dW0, db0, ...] as numpy arrays in one layout."""
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=2e-3,
                                   atol=1e-4 * max(np.abs(b).max(), 1e-3))


@pytest.mark.parametrize("F,H,L,O", FIELD_CASES)
def test_pe_mlp_vjp_matches_jax_interpret_and_reference(F, H, L, O):
    """The port's backward on the CPU (autograd through pe_mlp's plain
    version) against jax.vjp of the Pallas kernel in interpret mode and of
    the JAX layer chain, at both field architectures."""
    import jax
    import jax.numpy as jnp

    from neraf_tpu.ops.pallas.fused_pe_mlp import pe_mlp as jpe_mlp

    rng = np.random.RandomState(5)
    params = _rand_params(rng, F, H, L, O)
    x = _clear_rows(rng.rand(300, 3).astype(np.float32), params, F)
    g = rng.randn(x.shape[0], O).astype(np.float32)

    xt = torch.from_numpy(x).requires_grad_()
    layers = [(w.requires_grad_(), b.requires_grad_())
              for w, b in _torch_layers(params)]
    out = pe_mlp(xt, layers, F, 0.0, 8.0, torch.float32)
    out.backward(torch.from_numpy(g))
    got = [xt.grad.numpy()] + [t.grad.numpy().T if t.dim() == 2 else
                               t.grad.numpy() for wb in layers for t in wb]

    jparams = [(jnp.asarray(w), jnp.asarray(b)) for w, b in params]
    for fn in (lambda x, p: jpe_mlp(x, p, F, 0.0, 8.0, jnp.float32, 256, True),
               lambda x, p: _jax_chain(x, p, F)):
        _, vjp = jax.vjp(fn, jnp.asarray(x), jparams)
        dx, dp = vjp(jnp.asarray(g))
        ref = [np.asarray(dx)] + [np.asarray(t) for wb in dp for t in wb]
        _assert_grads_close(got, ref)


@pytest.mark.parametrize("F,H,L,O", CASES + FIELD_CASES)
def test_padded_units_get_zero_gradient(F, H, L, O):
    """The kernels' packed network (hidden width padded to 16..256, layer
    0's input to 48 or 64 and interleaved, the output to a multiple of 8):
    its gradient, taken by autograd here, is exactly 0 on every padded row,
    column and bias, and unpack_layers gives back the unpadded network's
    gradient."""
    rng = np.random.RandomState(6)
    params = _rand_params(rng, F, H, L, O)
    layers = _torch_layers(params)
    x = torch.from_numpy(rng.rand(64, 3).astype(np.float32))
    g = torch.from_numpy(rng.randn(64, O).astype(np.float32))
    w, b, dims = pack_layers(layers, F, torch.float32)
    w.requires_grad_()
    b.requires_grad_()
    k0p, hp, op = dims["k0p"], dims["hp"], dims["op"]
    # the encoding in the packed column order: (sin, cos) pairs, x, zeros
    freqs = 2.0 ** torch.linspace(0.0, 8.0, F)
    ang = (2.0 * np.pi * x[:, :, None] * freqs).reshape(64, -1)
    enc = torch.zeros(64, k0p)
    enc[:, 0:6 * F:2], enc[:, 1:6 * F:2] = torch.sin(ang), torch.cos(ang)
    enc[:, 6 * F:6 * F + 3] = x
    h, off = enc, 0
    for i in range(L + 1):
        rows, cols = (op if i == L else hp), (k0p if i == 0 else hp)
        h = h @ w[off:off + rows * cols].reshape(rows, cols).T + b[
            i * hp:i * hp + rows]
        h = torch.relu(h) if i < L else h
        off += rows * cols
    (h[:, :O] * g).sum().backward()
    dw, db = w.grad.detach(), b.grad.detach()

    pad_w, pad_b = torch.ones_like(dw, dtype=torch.bool), torch.ones_like(
        db, dtype=torch.bool)
    live = unpack_layers(torch.arange(dw.numel()), torch.arange(db.numel()),
                         dims, F, H)
    for wi, bi in live:
        pad_w[wi.reshape(-1)] = False
        pad_b[bi] = False
    assert pad_w.any()  # layer 0's odd 6F + 3 is always padded
    assert not dw[pad_w].any() and not db[pad_b].any()

    _, ref = pe_mlp_vjp_plain(x, layers, g, F)
    for (gw, gb), (rw, rb) in zip(unpack_layers(dw, db, dims, F, H), ref):
        torch.testing.assert_close(gw, rw, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(gb, rb, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("F,H,L,O", CASES)
def test_unpack_layers_inverts_pack_layers(F, H, L, O):
    layers = _torch_layers(_rand_params(np.random.RandomState(7), F, H, L, O))
    w, b, dims = pack_layers(layers, F, torch.float32)
    for (w1, b1), (w0, b0) in zip(unpack_layers(w, b, dims, F, H), layers):
        torch.testing.assert_close(w1, w0, rtol=0, atol=0)
        torch.testing.assert_close(b1, b0, rtol=0, atol=0)


def test_pe_mlp_vjp_plain_matches_autograd():
    rng = np.random.RandomState(8)
    params = _rand_params(rng, 4, 24, 2, 3)
    layers = _torch_layers(params)
    x = torch.from_numpy(rng.rand(40, 3).astype(np.float32))
    g = torch.from_numpy(rng.randn(40, 3).astype(np.float32))
    dx, grads = pe_mlp_vjp_plain(x, layers, g, 4)
    xs = x.clone().requires_grad_()
    ps = [(w.clone().requires_grad_(), b.clone().requires_grad_())
          for w, b in layers]
    (pe_mlp_plain(xs, ps, 4) * g).sum().backward()
    torch.testing.assert_close(dx, xs.grad, rtol=0, atol=0)
    for (gw, gb), (w, b) in zip(grads, ps):
        torch.testing.assert_close(gw, w.grad, rtol=0, atol=0)
        torch.testing.assert_close(gb, b.grad, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("F,H,L,O", CASES + FIELD_CASES)
def test_pe_mlp_backward_kernel_matches_plain_on_card(F, H, L, O):
    """The backward kernel through autograd on the card against the plain
    chain's autograd, n = 1000 (ragged row tiles and dW slices). f32:
    against the float64 backward to 1e-4 of each tensor's peak (f32 sums
    over the rows and the angles' f32 range reduction). bf16, by relative
    L2 error ||a - b|| / ||b|| per tensor: a ReLU mask flips wherever bf16
    rounding moves a pre-activation across 0, in the kernel and the plain
    chain at different units, which moves single rows of dx by O(peak), so
    an elementwise bound says nothing, and both sit ~5% from float64
    (measured on an H100); against the plain bf16 backward to 0.15, and no
    further from the float64 backward than 1.5 times the plain bf16
    backward is (a wrong product is O(1) off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    rng = np.random.RandomState(9)
    n = 1000
    params = _rand_params(rng, F, H, L, O)
    x = torch.from_numpy(rng.rand(n, 3).astype(np.float32)).cuda()
    g = torch.from_numpy(rng.randn(n, O).astype(np.float32)).cuda()
    layers = _torch_layers(params, "cuda")

    def flat(dx, grads):
        return [dx] + [t for wb in grads for t in wb]

    ref = flat(*pe_mlp_vjp_plain(
        x.double(), [(w.double(), b.double()) for w, b in layers], g.double(),
        F, dtype=torch.float64))

    def kernel_grads(dtype):
        xs = x.clone().requires_grad_()
        ps = [(w.clone().requires_grad_(), b.clone().requires_grad_())
              for w, b in layers]
        before = pe_mlp_cuda_mod.BWD_LAUNCHES
        pe_mlp(xs, ps, F, dtype=dtype).backward(g)
        torch.cuda.synchronize()
        assert pe_mlp_cuda_mod.BWD_LAUNCHES == before + 1
        return flat(xs.grad, [(w.grad, b.grad) for w, b in ps])

    def rel(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm())

    for got, want in zip(kernel_grads(torch.float32), ref):
        peak = float(want.abs().max())
        assert float((got.double() - want).abs().max()) <= 1e-4 * peak
    plain16 = flat(*pe_mlp_vjp_plain(x, layers, g, F, dtype=torch.bfloat16))
    for i, (got, p16, want) in enumerate(zip(kernel_grads(torch.bfloat16),
                                             plain16, ref)):
        assert rel(got, p16) <= 0.15, (i, rel(got, p16))
        assert rel(got, want) <= 1.5 * rel(p16, want), (
            i, rel(got, want), rel(p16, want))
