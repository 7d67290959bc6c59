"""The port's stem weight gradient (ops/stem_wgrad.py), the baked stem's
autograd function that takes it (ops/baked_stem.py::StemConvBaked) and the
ResNet3D and joint-step switch that put the stem on it, against the JAX
package and torch's own conv3d.

stem_wgrad_plain (the direct conv's weight gradient, the independent
reference) is held against the Pallas kernel stem_wgrad_pallas in
interpret mode (as tests/test_stem_wgrad.py runs it): x folded with
neraf_tpu.models.grid.fold_volume, the (3, 3, 3, 56, F) folded gradient
mapped back to the direct kernel by the inverse of the weight fold
(neraf_tpu/models/resnet3d.py:89-93: folded tap i = 2 k + r, the 6th a zero
pad), to 1e-5 of the peak in f32 and with bf16 inputs (f32 sums over 512 to
1,536 products in another order), on a cube and on a D != H != W volume.
stem_wgrad takes the folded volume. StemConvBaked against the autograd of
F.conv3d of the same folded volume and folded weight on the CPU: forward
bitwise (the same call), the slab's input gradient and dW to 1e-5 of their
peaks (f32 sums of the same products in another order); under CPU
autocast, dW is the float32 sum rounded to bf16. The CUDA kernel is held
against the plain version on a card, and StemConvBaked with the kernel
against the direct conv's autograd in float64 there (marked `cuda`,
skipped here); the JAX
package is imported inside the tests that use it, so the `cuda` tests also
run where flax is not installed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from neraf_tpu_torch.engine.factory import build_joint_pipeline
from neraf_tpu_torch.models.grid import cell_centers, fold_volume, folded_slab
from neraf_tpu_torch.models.resnet3d import ResNet3D
from neraf_tpu_torch.ops import stem_wgrad as sw
from neraf_tpu_torch.ops.baked_stem import stem_conv_baked
from neraf_tpu_torch.ops.cuda import stem_wgrad as sw_cuda
from neraf_tpu_torch.utils.profiling import counters

CIN = 7


def _inputs(seed, shape, cout):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1, *shape, CIN)).astype(np.float32)
    g = rng.normal(size=(1, cout, *((n - 1) // 2 + 1 for n in shape)))
    return x, g.astype(np.float32)


def _baked_inputs(seed, R=16, B=64, cursor=None):
    """An R^3 grid volume (1, R, R, R, 7), channels 4:7 the cell centers,
    with one cursor batch of B fresh cells in channels 0:4, the fresh cells
    (B, 4), the cursor, the stem weight and an output cotangent, f32
    numpy."""
    rng = np.random.default_rng(seed)
    cursor = 3 * R * R + 4 * R if cursor is None else cursor
    grid = rng.uniform(size=(1, R, R, R, CIN)).astype(np.float32)
    fresh = rng.uniform(size=(B, 4)).astype(np.float32)
    grid.reshape(-1, CIN)[:, 4:] = cell_centers(R)  # as the slab's xyz
    grid.reshape(-1, CIN)[cursor:cursor + B, :4] = fresh
    w = rng.normal(size=(64, CIN, 5, 5, 5)).astype(np.float32)
    g = rng.normal(size=(1, 64, R // 2, R // 2, R // 2)).astype(np.float32)
    return grid, fresh, cursor, w, g


def _baked(grid, fresh, cursor, w, dtype=torch.float32, use_kernel=False):
    """stem_conv_baked over the folded grid with the fresh cells' slab ->
    (out, fresh leaf, weight leaf, the folded volume)."""
    R = grid.shape[1]
    ft = torch.from_numpy(fresh).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    nf = fold_volume(torch.from_numpy(grid), dtype)
    slab, d0, h0, ch = folded_slab(ft, cursor, torch.from_numpy(
        cell_centers(R)), R, dtype)
    return stem_conv_baked(nf, slab, d0, h0, ch, wt, use_kernel), ft, wt, nf


def _unfold_weight(wp, cout):
    """(3, 3, 3, 8 CIN, cout) folded dW -> (cout, CIN, 5, 5, 5)."""
    w = np.asarray(wp).reshape(3, 3, 3, 2, 2, 2, CIN, cout)
    w = w.transpose(0, 3, 1, 4, 2, 5, 6, 7).reshape(6, 6, 6, CIN, cout)
    return w[:5, :5, :5].transpose(4, 3, 0, 1, 2)


@pytest.mark.parametrize("shape", [(16, 16, 16), (8, 16, 24)],
                         ids=["cube", "asymmetric"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stem_wgrad_plain_matches_pallas_interpret(shape, dtype):
    from neraf_tpu.models.grid import fold_volume
    from neraf_tpu.ops.pallas.stem_wgrad_kernel import stem_wgrad_pallas

    cout = 8
    x, g = _inputs(sum(shape), shape, cout)
    jdt = jnp.dtype(dtype)
    xj, gj = jnp.asarray(x, jdt), jnp.asarray(g.transpose(0, 2, 3, 4, 1), jdt)
    want = _unfold_weight(stem_wgrad_pallas(fold_volume(xj), gj, block_d=2,
                                            interpret=True), cout)
    tdt = getattr(torch, dtype)
    got = sw.stem_wgrad_plain(torch.from_numpy(x).to(tdt),
                              torch.from_numpy(g).to(tdt))
    assert got.dtype == torch.float32 and got.shape == (cout, CIN, 5, 5, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_stem_wgrad_plain_sums_float64_in_float64():
    x, g = _inputs(3, (6, 10, 8), 16)
    got = sw.stem_wgrad_plain(torch.from_numpy(x).double(),
                              torch.from_numpy(g).double())
    want = torch.nn.grad.conv3d_weight(
        torch.from_numpy(x).double().permute(0, 4, 1, 2, 3),
        (16, CIN, 5, 5, 5), torch.from_numpy(g).double(), 2, 2)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12)


def test_stem_wgrad_dispatches_on_cpu():
    """On a CPU tensor stem_wgrad is the folded plain version, unfolded."""
    x, g = _inputs(4, (8, 8, 8), 16)
    xf, gt = fold_volume(torch.from_numpy(x)), torch.from_numpy(g)
    got = sw.stem_wgrad(xf, gt)
    assert got.shape == (16, CIN, 5, 5, 5)
    assert torch.equal(got, sw.stem_wgrad_unfold(
        sw.stem_wgrad_folded_plain(xf, gt)))


@pytest.mark.parametrize("bad,match", [
    ("device", "unsupported device"), ("dtype", "one type"),
    ("cin", "input channels"), ("cin0", "input channels"),
    ("cout", "output channels"), ("voxels", "output voxels"),
    ("batch", "batch-1"), ("g_batch", "batch-1")])
def test_stem_wgrad_cuda_refuses_what_the_kernel_does_not_take(bad, match):
    """Checked before any launch, the device last: meta tensors reach every
    other check without a card. The kernel takes the folded volume of 1..8
    input channels (8 to 64 folded channels)."""
    x, g = (1, 4, 4, 4, 56), (1, 64, 4, 4, 4)
    x, g = {"cin": ((1, 4, 4, 4, 72), g), "cin0": ((1, 4, 4, 4, 0), g),
            "cout": (x, (1, 32, 4, 4, 4)),
            "g_batch": (x, (2, 64, 4, 4, 4)),
            "voxels": (x, (1, 64, 4, 4, 5)),
            "batch": ((2, 4, 4, 4, 56), (2, 64, 4, 4, 4))}.get(bad, (x, g))
    xt, gt = torch.zeros(x, device="meta"), torch.zeros(g, device="meta")
    if bad == "dtype":
        gt = gt.bfloat16()
    with pytest.raises(TypeError if bad == "dtype" else ValueError,
                       match=match):
        sw_cuda.stem_wgrad_cuda(xt, gt)


def test_stem_wgrad_plain_of_packed_volume_is_the_7_channel_one():
    """The weight gradient of the volume padded with a zero 8th channel (the
    kernel's reading), in float64: its first 7 input channels are the
    7-channel volume's to 1e-10 of the peak, and the 8th is exactly zero."""
    x, g = _inputs(12, (10, 12, 8), 64)
    xt, gt = torch.from_numpy(x).double(), torch.from_numpy(g).double()
    packed = sw.stem_wgrad_plain(F.pad(xt, (0, 1)), gt)
    want = sw.stem_wgrad_plain(xt, gt)
    assert packed.shape == (64, 8, 5, 5, 5)
    err = float((packed[:, :CIN] - want).abs().max() / want.abs().max())
    assert err <= 1e-10, err
    assert float(packed[:, CIN].abs().max()) == 0.0


def test_stem_conv_matches_conv3d_autograd():
    """StemConvBaked against F.conv3d of the same folded volume with the
    folded weight, autograd through the slab and the weight fold: the
    forward bitwise, the fresh cells' and the weight's gradients to 1e-5 of
    their peaks (the slab's window conv and the plain weight gradient sum
    the same products in another order)."""
    grid, fresh, cursor, w, g = _baked_inputs(5)
    gt = torch.from_numpy(g)
    out, ft, wt, _ = _baked(grid, fresh, cursor, w, use_kernel=True)
    out.backward(gt)
    R = grid.shape[1]
    fr = torch.from_numpy(fresh).requires_grad_()
    wr = torch.from_numpy(w).requires_grad_()
    vol = torch.from_numpy(grid).reshape(-1, CIN)
    vol = torch.cat([vol[:cursor], torch.cat([fr, vol[cursor:cursor + len(
        fresh), 4:]], -1), vol[cursor + len(fresh):]]).reshape(grid.shape)
    ref = F.conv3d(fold_volume(vol).permute(0, 4, 1, 2, 3),
                   sw.fold_weight(wr), None, 1, 1)
    ref.backward(gt)
    assert out.shape == (1, 64, R // 2, R // 2, R // 2)
    assert torch.equal(out, ref)
    for got, want in ((ft.grad, fr.grad), (wt.grad, wr.grad)):
        err = float((got - want).abs().max() / want.abs().max())
        assert err <= 1e-5, err


def test_stem_conv_under_autocast_rounds_dw_to_bf16():
    """StemConvBaked under CPU autocast, bf16 folded state: the output is
    F.conv3d's of the bf16 volume and weight, and dW the float32 sum of the
    bf16 products, rounded to bf16 and unfolded; torch's own bf16 weight
    gradient of the folded conv equal within bf16 rounding."""
    grid, fresh, cursor, w, g = _baked_inputs(6)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        out, ft, wt, nf = _baked(grid, fresh, cursor, w, torch.bfloat16,
                                 use_kernel=True)
    wr = torch.from_numpy(w).requires_grad_()
    with torch.autocast("cpu", dtype=torch.bfloat16):
        ref = F.conv3d(nf.permute(0, 4, 1, 2, 3), sw.fold_weight(wr), None,
                       1, 1)
    assert out.dtype == torch.bfloat16 and torch.equal(out, ref)
    gb = torch.from_numpy(g).bfloat16()
    out.backward(gb)
    ref.backward(gb)
    assert wt.grad.dtype == torch.float32 and ft.grad.dtype == torch.float32
    want = sw.stem_wgrad_unfold(sw.stem_wgrad_folded_plain(nf, gb)).bfloat16()
    assert torch.equal(wt.grad, want.float())
    err = float((wt.grad - wr.grad).abs().max() / wr.grad.abs().max())
    assert err <= 2 ** -7, err


def _count_plain(monkeypatch):
    calls = []
    plain = sw.stem_wgrad_folded_plain

    def spy(x, g):
        calls.append(tuple(x.shape))
        return plain(x, g)

    monkeypatch.setattr(sw, "stem_wgrad_folded_plain", spy)
    return calls


def test_resnet_stem_flag_takes_the_function_in_train_mode_only(monkeypatch):
    """The baked stem's use_kernel flag puts the weight gradient on
    stem_wgrad (the plain version here) once a backward, in train mode
    with gradients; the same net without the flag takes cuDNN's (torch's)
    folded weight gradient, and the s2d stem without a slab, no_grad and
    eval mode never call it. The outputs are equal, the weight gradients
    within 1e-5 of the peak."""
    calls = _count_plain(monkeypatch)
    torch.manual_seed(0)
    nets = [ResNet3D(backbone="resnet18") for _ in range(2)]
    nets[0].reset_parameters(torch.Generator().manual_seed(1))
    nets[1].load_state_dict(nets[0].state_dict())
    grid, fresh, cursor, _, _ = _baked_inputs(2, R=32, B=256,
                                              cursor=5 * 1024 + 512)
    outs, grads = [], []
    for use_kernel, net in zip((False, True), nets):
        net.train()
        ft = torch.from_numpy(fresh).requires_grad_()
        nf = fold_volume(torch.from_numpy(grid))
        slab, d0, h0, ch = folded_slab(ft, cursor, torch.from_numpy(
            cell_centers(32)), 32, torch.float32)
        out = net(nf, bake_slab=(slab, d0, h0, ch, use_kernel))
        out.sum().backward()
        outs.append(out.detach())
        grads.append((ft.grad, net.conv1.weight.grad))
    assert calls == [(1, 16, 16, 16, 8 * CIN)]
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(grads[0][0], grads[1][0])
    dw, ref = grads[1][1], grads[0][1]
    assert float((dw - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    vol = torch.from_numpy(grid)
    with torch.no_grad():
        nets[1](vol)
    nets[1](vol.clone().requires_grad_()).sum().backward()
    nets[1].eval()
    nets[1](vol.clone().requires_grad_()).sum().backward()
    assert len(calls) == 1


def test_joint_pipeline_reads_the_gate_once(monkeypatch):
    monkeypatch.delenv("NERAF_STEM_WGRAD_PALLAS", raising=False)
    off = build_joint_pipeline(grid_res=8, tiny=True, device="cpu",
                               mixed_precision=False)
    monkeypatch.setenv("NERAF_STEM_WGRAD_PALLAS", "1")
    on = build_joint_pipeline(grid_res=8, tiny=True, device="cpu",
                              mixed_precision=False)
    assert not off.stem_wgrad_kernel and on.stem_wgrad_kernel
    monkeypatch.setenv("NERAF_STEM_WGRAD_PALLAS", "0")
    assert on.stem_wgrad_kernel  # read when the pipeline is built


@pytest.mark.cuda
@pytest.mark.parametrize("cin", [7, 8], ids=["cin7", "packed"])
@pytest.mark.parametrize("shape", [(8, 8, 8), (5, 9, 17), (5, 17, 9),
                                   (7, 10, 19), (64, 64, 64)],
                         ids=["cube", "asymmetric", "asymmetric_h", "ragged",
                              "step"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_stem_wgrad_kernel_matches_plain_on_card(shape, dtype, cin):
    """The kernel on the folded volume (1, *shape, 8 cin) against the
    folded plain version in float64 on the same inputs, unfolded, to 1e-4
    of the peak (f32 sums over up to 262,144 products); one launch a call,
    and a second call bitwise equal to the first (fixed summation order).
    cin 7, the ResNet's grid channels: the split pass pads them to the
    kernel's 8; packed: a zero 8th channel given, whose dW channel is
    exactly zero. ragged: output bricks cut at every edge."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    x, g = _inputs(len(shape) + shape[0], tuple(2 * n for n in shape), 64)
    xt = torch.from_numpy(x).cuda().to(dtype)
    if cin == 8:
        xt = F.pad(xt, (0, 1))
    xf = fold_volume(xt)
    gt = torch.from_numpy(g).cuda().to(dtype)
    n = counters().get("kernel.stem_wgrad", 0)
    got = sw.stem_wgrad(xf, gt)
    again = sw.stem_wgrad(xf, gt)
    torch.cuda.synchronize()
    assert counters().get("kernel.stem_wgrad", 0) == n + 2 and got.dtype == torch.float32
    assert got.shape == (64, cin, 5, 5, 5) and torch.equal(got, again)
    want = sw.stem_wgrad_unfold(sw.stem_wgrad_folded_plain(xf.double(),
                                                           gt.double()))
    err = float((got.double() - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max()), err
    if cin == 8:
        assert float(got[:, 7].abs().max()) == 0.0


@pytest.mark.cuda
def test_stem_conv_runs_the_kernel_on_card():
    """stem_conv_baked on the card with use_kernel: the forward is cuDNN's
    folded conv, dW the kernel's (one launch), the slab's gradient the
    window conv, against the autograd of the direct conv (kernel 5, stride
    2, padding 2) of the flat grid with the fresh cells spliced in, on the
    card in float64, each of the output, the fresh cells' and the weight's
    gradient to 1e-4 of its peak (f32, TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    R, B, cursor = 32, 256, 7 * 1024 + 256
    grid, fresh, cursor, w, g = _baked_inputs(9, R=R, B=B, cursor=cursor)
    gt = torch.from_numpy(g).cuda()
    ft, fr = (torch.from_numpy(fresh).cuda().to(dt).requires_grad_()
              for dt in (torch.float32, torch.float64))
    wt, wr = (torch.from_numpy(w).cuda().to(dt).requires_grad_()
              for dt in (torch.float32, torch.float64))
    nf = fold_volume(torch.from_numpy(grid).cuda())
    slab, d0, h0, ch = folded_slab(ft, cursor, torch.from_numpy(
        cell_centers(R)).cuda(), R, torch.float32)
    n = counters().get("kernel.stem_wgrad", 0)
    out = stem_conv_baked(nf, slab, d0, h0, ch, wt, True)
    out.backward(gt)
    torch.cuda.synchronize()
    assert counters().get("kernel.stem_wgrad", 0) == n + 1
    flat = torch.from_numpy(grid).cuda().double().reshape(-1, CIN)
    vol = torch.cat([flat[:cursor], torch.cat([fr, flat[cursor:cursor + B, 4:]],
                                              -1), flat[cursor + B:]])
    ref = F.conv3d(vol.reshape(1, R, R, R, CIN).permute(0, 4, 1, 2, 3), wr,
                   None, 2, 2)
    ref.backward(gt.double())
    for got, want in ((out, ref), (ft.grad, fr.grad), (wt.grad, wr.grad)):
        err = float((got.detach().double() - want).abs().max()
                    / want.abs().max())
        assert err <= 1e-4, err
