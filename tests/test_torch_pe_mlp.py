"""The port's fused PE+MLP (neraf_tpu_torch/ops/pe_mlp.py) against the JAX
Pallas kernel in interpret mode and its plain reference.

On the CPU `pe_mlp` runs the plain version; the CUDA kernel is held against
it on a card (marked `cuda`, skipped here). JAX is imported inside the
tests that use it, so the `cuda` tests also run where JAX is not installed.
Tolerances: the forward, the port's and the JAX kernel's, each against
the float64 chain at rtol 2e-4 and atol 1e-4 of the peak (the float32
angles' noise, see the test); gradients rtol 2e-3 and atol 1e-4 of each
tensor's peak, that test's bound, on rows with no pre-activation within
f32 noise of 0 (such a unit's ReLU subgradient flips between orderings).
"""

import numpy as np
import pytest
import torch

from neraf_tpu_torch.ops.cuda import pe_mlp as pe_mlp_cuda_mod
from neraf_tpu_torch.ops.encodings import nerf_encoding
from neraf_tpu_torch.ops.pe_mlp import (
    KERNEL_HIDDEN_WIDTHS,
    chunk_rows,
    pack_layers,
    pe_mlp,
    pe_mlp_plain,
    pe_mlp_vjp_plain,
    split_first_layer,
    tile_layers,
    unpack_layers,
)
from neraf_tpu_torch.utils.profiling import counters

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


@pytest.mark.parametrize("F,H,L,O", CASES)
def test_pe_mlp_matches_jax_interpret_and_reference(F, H, L, O):
    """The port's output (the plain version on the CPU) and the Pallas
    kernel's in interpret mode, each against the float64 chain of the same
    weights, rtol 2e-4 and atol 1e-4 of the float64 output's peak: both are
    float32 with angles of up to 2^8 turns, which carry ~3e-5 of the peak
    (the f32 plain chain measured 1.75e-5 off at a peak of 0.637), so an
    atol of 2e-5 sits at the noise of float32 sines and another XLA CPU
    build or CPU can cross it; a wrong layer is O(peak) off."""
    import jax.numpy as jnp

    from neraf_tpu.ops.pallas.fused_pe_mlp import pe_mlp as jpe_mlp

    rng = np.random.RandomState(0)
    n = 300  # not a multiple of the JAX block: its padding is exercised
    x = rng.rand(n, 3).astype(np.float32)
    params = _rand_params(rng, F, H, L, O)
    before = counters().get("kernel.pe_mlp_fwd", 0)
    out = pe_mlp(torch.from_numpy(x), _torch_layers(params), F, 0.0, 8.0,
                 torch.float32)
    assert counters().get("kernel.pe_mlp_fwd", 0) == before  # a CPU tensor: plain version
    assert out.shape == (n, O) and out.dtype == torch.float32
    jparams = [(jnp.asarray(w), jnp.asarray(b)) for w, b in params]
    ref_kernel = np.asarray(jpe_mlp(jnp.asarray(x), jparams, F, 0.0, 8.0,
                                    jnp.float32, 256, True))
    ref64 = pe_mlp_plain(torch.from_numpy(x).double(),
                         _torch_layers(params, dtype=torch.float64), F, 0.0,
                         8.0, torch.float64).numpy()
    atol = 1e-4 * np.abs(ref64).max()
    np.testing.assert_allclose(out.numpy(), ref64, rtol=2e-4, atol=atol)
    np.testing.assert_allclose(ref_kernel, ref64, rtol=2e-4, atol=atol)


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
    before = counters().get("kernel.pe_mlp_fwd", 0)
    out = pe_mlp(x, layers, F, dtype=torch.float32)
    torch.cuda.synchronize()
    assert counters().get("kernel.pe_mlp_fwd", 0) == before + 1
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
        before = counters().get("kernel.pe_mlp_bwd", 0)
        pe_mlp(xs, ps, F, dtype=dtype).backward(g)
        torch.cuda.synchronize()
        assert counters().get("kernel.pe_mlp_bwd", 0) == before + 1
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


def _layer_shapes(dims):
    """(rows, packed rows, cols, chunk rows) of each layer as tile_layers
    cuts it: the output layer's op rows padded to 16 and in one chunk."""
    k0p, hp, op, L = dims["k0p"], dims["hp"], dims["op"], dims["n_hidden"]
    opk = -(-op // 16) * 16
    return ([(hp, hp, k0p, chunk_rows(hp))]
            + [(hp, hp, hp, chunk_rows(hp))] * (L - 1) + [(opk, op, hp, opk)])


def _tiled_case(hp):
    F = 10 if hp == 256 else 6
    H = hp - 8 if hp > 16 else hp  # a padded hidden width where there is room
    layers = _torch_layers(_rand_params(np.random.RandomState(hp), F, H, 3, 5))
    w, _, dims = pack_layers(layers, F, torch.float32)
    assert dims["hp"] == hp
    return w, dims


@pytest.mark.parametrize("hp", KERNEL_HIDDEN_WIDTHS)
def test_tile_layers_places_every_weight(hp):
    """tile_layers (the bf16 kernels' weight layout): weight (r, c) of a
    layer lies in chunk r // R at core matrix (r % R // 8, c // 8), element
    64 (j R / 8 + i) + 8 (r % 8) + c % 8; the output layer's padded rows are
    zero; nothing else is in the buffer."""
    w, dims = _tiled_case(hp)
    tiled = tile_layers(w, dims)
    off_packed, off_tiled = 0, 0
    for rows, live, cols, R in _layer_shapes(dims):
        layer = w[off_packed:off_packed + live * cols].reshape(live, cols)
        r, c = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
        idx = (off_tiled + (r // R) * R * cols + 64 * ((c // 8) * (R // 8)
               + (r % R) // 8) + 8 * (r % 8) + c % 8)
        got = tiled[torch.from_numpy(idx)]
        torch.testing.assert_close(got[:live], layer, rtol=0, atol=0)
        assert not got[live:].any()
        off_packed += live * cols
        off_tiled += rows * cols
    assert off_packed == w.numel() and off_tiled == tiled.numel()


def _canonical(buf, start, lbo, sbo, k_major, n_mn, n_k):
    """What wgmma reads from a no-swizzle descriptor (byte start, leading
    and stride byte offsets) over an MN x K operand of bf16: the PTX ISA's
    canonical layouts, K-major ((8, m), (8, 2)) : ((16 B, SBO), (2 B, LBO))
    and MN-major ((8, m), (8, k)) : ((2 B, SBO), (16 B, LBO)) -> (MN, K)."""
    mn, k = np.meshgrid(np.arange(n_mn), np.arange(n_k), indexing="ij")
    if k_major:
        byte = start + (mn // 8) * sbo + (mn % 8) * 16 + (k // 8) * lbo + (k % 8) * 2
    else:
        byte = start + (mn // 8) * sbo + (mn % 8) * 2 + (k // 8) * lbo + (k % 8) * 16
    assert (byte % 2 == 0).all()
    return buf[torch.from_numpy(byte // 2)]


@pytest.mark.parametrize("hp", KERNEL_HIDDEN_WIDTHS)
def test_tiled_chunks_read_as_wgmma_operands(hp):
    """The descriptors the kernels build on a staged chunk of R rows x C
    columns (csrc/pe_mlp_common.cuh chunk_fwd, csrc/pe_mlp_bwd.cu
    back_product) read the weights they mean: the forward's K-major B of k
    tile kt (start kt R 32, LBO R 16, SBO 128) is W[chunk, 16 kt ..]^T, the
    backward's MN-major B of k tile kt over the N columns col0 .. (start
    col0 R 2 + kt 256, LBO 128, SBO R 16) is W[chunk rows 16 kt .., col0 ..]."""
    w, dims = _tiled_case(hp)
    tiled = tile_layers(w, dims)
    off_tiled = 0
    for rows, _, cols, R in _layer_shapes(dims):
        packed = tiled[off_tiled:off_tiled + rows * cols]
        dense = torch.zeros(rows, cols)
        # the layer back from the layout, by test_tile_layers' formula
        r, c = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
        pos = ((r // R) * R * cols + 64 * ((c // 8) * (R // 8) + (r % R) // 8)
               + 8 * (r % 8) + c % 8)
        dense[torch.from_numpy(r), torch.from_numpy(c)] = packed[
            torch.from_numpy(pos)]
        for chunk in range(rows // R):
            buf = packed[chunk * R * cols:(chunk + 1) * R * cols]
            wc = dense[chunk * R:(chunk + 1) * R]
            for kt in range(cols // 16):
                b = _canonical(buf, kt * R * 32, R * 16, 128, True, R, 16)
                torch.testing.assert_close(b, wc[:, 16 * kt:16 * kt + 16],
                                           rtol=0, atol=0)
            n = min(cols, 128)
            for col0 in range(0, cols, n):
                for kt in range(R // 16):
                    b = _canonical(buf, col0 * R * 2 + kt * 256, 128, R * 16,
                                   False, n, 16)
                    torch.testing.assert_close(
                        b, wc[16 * kt:16 * kt + 16, col0:col0 + n].T,
                        rtol=0, atol=0)
        off_tiled += rows * cols


@pytest.mark.parametrize("hp", KERNEL_HIDDEN_WIDTHS)
def test_slices_and_row_tile_blocks(hp):
    """The bf16 kernels' grid sizes: one persistent row-tile block an SM,
    never more than the 128-row tiles; the dW slices, one wave of M tiles
    x slices (66 at HP 256 and 132 below it on a 132-SM card, not the 256
    of a 64 x 64 tile), never more than the 64-row steps."""
    sms = 132
    m_tiles = -(-hp // 128)
    for n in (1, 63, 64, 65, 300, 777, 73_728, 196_608, 1_048_576):
        tiles = -(-n // 128)
        assert pe_mlp_cuda_mod.row_tile_blocks(n, sms) == min(tiles, sms)
        s = pe_mlp_cuda_mod.dw_slices(n, hp, sms)
        assert 1 <= s <= 2 * tiles and m_tiles * s <= sms + m_tiles - 1
        if n >= 196_608:
            assert s == (66 if hp == 256 else 132)


def _kernel_rounding(x, layers, g, F):
    """The bf16 kernels' rounding, emulated in float32 products of bf16
    values: the encoding from exact angles, each layer's input and weights
    in bf16, products summed in f32, bias add and ReLU in f32, then one
    bf16 cast; backward: dW from the bf16 cotangents and inputs, db from
    the f32 ones, the masks h > 0 -> out, dx, [(dW, db)]."""
    bf = lambda t: t.to(torch.bfloat16).float()
    n = x.shape[0]
    enc = nerf_encoding(x.double(), F).float()
    hs = [bf(enc)]
    for w, b in layers[:-1]:
        hs.append(bf(torch.relu(hs[-1] @ bf(w).T + b)))
    out = hs[-1] @ bf(layers[-1][0]).T + layers[-1][1]
    grads = [(bf(g).T @ hs[-1], g.sum(0))]
    dh = bf(g) @ bf(layers[-1][0])
    for i in range(len(layers) - 2, -1, -1):
        dpre = dh * (hs[i + 1] > 0)
        grads.insert(0, (bf(dpre).T @ hs[i], dpre.sum(0)))
        dh = bf(dpre) @ bf(layers[i][0])
    df = 3 * F
    freqs = 2.0 ** torch.linspace(0.0, 8.0, F, dtype=torch.float64,
                                  device=x.device)
    ang = (2.0 * np.pi * x.double()[:, :, None] * freqs).reshape(n, -1)
    d_ang = (dh[:, :df].double() * torch.cos(ang)
             - dh[:, df:2 * df].double() * torch.sin(ang))
    dx = ((d_ang.reshape(n, 3, F) * 2.0 * np.pi * freqs).sum(-1)
          + dh[:, 2 * df:].double())
    return out, dx.float(), grads


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 300, 777])
@pytest.mark.parametrize("hp", KERNEL_HIDDEN_WIDTHS)
def test_bf16_kernels_at_ragged_rows_on_card(hp, n):
    """The wgmma kernels at every HP and ragged row counts (empty, one row,
    a warpgroup's 64 and either side of it, 300, and 777, not a multiple of
    a block's 128), forward and backward, with dx and without: against
    the kernels' rounding emulated in f32 products of bf16 values
    (_kernel_rounding), each tensor to 2e-2 relative L2 and the forward to
    2e-2 of its peak (the two sum in other orders, and a bf16 activation a
    rounding step apart moves a few units; a wrong product, row or layout
    is O(1))."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    F = 10 if hp == 256 else 6
    rng = np.random.RandomState(100 + hp)
    params = _rand_params(rng, F, hp, 3, 16 if hp == 256 else 1)
    params = [(w, (rng.randn(*b.shape) * 0.1).astype(np.float32))
              for w, b in params]
    layers = _torch_layers(params, "cuda")
    x = torch.from_numpy(rng.rand(n, 3).astype(np.float32)).cuda()
    g = torch.from_numpy(rng.randn(n, params[-1][0].shape[1])
                         .astype(np.float32)).cuda()

    def rel(a, b):
        den = float(b.double().norm())
        return float((a.double() - b.double()).norm()) / max(den, 1e-30)

    with torch.no_grad():
        out = pe_mlp(x, layers, F, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert out.shape == (n, g.shape[1])
    if n:
        out_ref, dx_ref, grads_ref = _kernel_rounding(x, layers, g, F)
        peak = float(out_ref.abs().max())
        assert float((out - out_ref).abs().max()) <= 2e-2 * peak
    w, b, dims = pe_mlp_cuda_mod._pack(layers, F, torch.bfloat16)
    for need_dx in (True, False):
        dx, (dw, db) = pe_mlp_cuda_mod.pe_mlp_bwd_cuda(
            x, g, w, b, dims, F, 0.0, 8.0, torch.bfloat16, need_dx=need_dx)
        torch.cuda.synchronize()
        got = unpack_layers(dw, db, dims, F, hp)
        if n == 0:
            assert all(not t.any() for wb in got for t in wb)
            continue
        if need_dx:
            assert rel(dx, dx_ref) <= 2e-2, rel(dx, dx_ref)
        for i, ((gw, gb), (rw, rb)) in enumerate(zip(got, grads_ref)):
            assert rel(gw, rw) <= 2e-2, (i, rel(gw, rw))
            assert rel(gb, rb) <= 2e-2, (i, rel(gb, rb))
