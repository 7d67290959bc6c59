"""The port's stem weight gradient (ops/stem_wgrad.py), its autograd
function (ops/stem_conv.py) and the ResNet3D and joint-step switch that put
the stem on it, against the JAX package and torch's own conv3d.

stem_wgrad_plain is held against the Pallas kernel stem_wgrad_pallas in
interpret mode (as tests/test_stem_wgrad.py runs it): x folded with
neraf_tpu.models.grid.fold_volume, the (3, 3, 3, 56, F) folded gradient
mapped back to the direct kernel by the inverse of the weight fold
(neraf_tpu/models/resnet3d.py:89-93: folded tap i = 2 k + r, the 6th a zero
pad), to 1e-5 of the peak in f32 and with bf16 inputs (f32 sums over 512 to
1,536 products in another order), on a cube and on a D != H != W volume.
StemConvFunction against the autograd of F.conv3d on the CPU: forward and
dx bitwise, dW to 1e-5 of its peak; under CPU autocast, dW is the float32
sum rounded to bf16. The CUDA kernel is held against the plain version on
a card (marked `cuda`, skipped here); the JAX package is imported inside
the tests that use it, so the `cuda` tests also run where flax is not
installed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from neraf_tpu_torch.engine.factory import build_joint_pipeline
from neraf_tpu_torch.models.resnet3d import ResNet3D
from neraf_tpu_torch.ops import stem_wgrad as sw
from neraf_tpu_torch.ops.cuda import stem_wgrad as sw_cuda
from neraf_tpu_torch.ops.stem_conv import stem_conv

CIN = 7


def _inputs(seed, shape, cout):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1, *shape, CIN)).astype(np.float32)
    g = rng.normal(size=(1, cout, *((n - 1) // 2 + 1 for n in shape)))
    return x, g.astype(np.float32)


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
    x, g = _inputs(4, (8, 8, 8), 16)
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    assert torch.equal(sw.stem_wgrad(xt, gt), sw.stem_wgrad_plain(xt, gt))


@pytest.mark.parametrize("bad,match", [
    ("device", "unsupported device"), ("dtype", "one type"),
    ("cin", "input channels"), ("cin0", "input channels"),
    ("cout", "output channels"), ("voxels", "output voxels"),
    ("batch", "batch-1"), ("g_batch", "batch-1")])
def test_stem_wgrad_cuda_refuses_what_the_kernel_does_not_take(bad, match):
    """Checked before any launch, the device last: meta tensors reach every
    other check without a card. The kernel takes 1..8 input channels."""
    x, g = (1, 8, 8, 8, 7), (1, 64, 4, 4, 4)
    x, g = {"cin": ((1, 8, 8, 8, 9), g), "cin0": ((1, 8, 8, 8, 0), g),
            "cout": (x, (1, 32, 4, 4, 4)),
            "g_batch": (x, (2, 64, 4, 4, 4)),
            "voxels": (x, (1, 64, 4, 4, 5)),
            "batch": ((2, 8, 8, 8, 7), (2, 64, 4, 4, 4))}.get(bad, (x, g))
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
    rng = np.random.default_rng(5)
    x0 = torch.from_numpy(rng.normal(size=(1, 12, 16, 10, CIN)).astype(np.float32))
    w0 = torch.from_numpy(rng.normal(size=(64, CIN, 5, 5, 5)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(1, 64, 6, 8, 5)).astype(np.float32))
    x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
    out = stem_conv(x, w)
    out.backward(g)
    xr, wr = x0.clone().requires_grad_(), w0.clone().requires_grad_()
    ref = F.conv3d(xr.permute(0, 4, 1, 2, 3), wr, None, 2, 2)
    ref.backward(g)
    assert torch.equal(out, ref)
    assert torch.equal(x.grad, xr.grad)
    err = float((w.grad - wr.grad).abs().max() / wr.grad.abs().max())
    assert err <= 1e-5, err


def test_stem_conv_under_autocast_rounds_dw_to_bf16():
    rng = np.random.default_rng(6)
    x0 = torch.from_numpy(rng.normal(size=(1, 8, 8, 8, CIN)).astype(np.float32))
    w0 = torch.from_numpy(rng.normal(size=(64, CIN, 5, 5, 5)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(1, 64, 4, 4, 4)).astype(np.float32))
    x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
    xr, wr = x0.clone().requires_grad_(), w0.clone().requires_grad_()
    with torch.autocast("cpu", dtype=torch.bfloat16):
        out = stem_conv(x, w)
        ref = F.conv3d(xr.permute(0, 4, 1, 2, 3), wr, None, 2, 2)
    assert out.dtype == torch.bfloat16 and torch.equal(out, ref)
    out.backward(g.bfloat16())
    ref.backward(g.bfloat16())
    assert w.grad.dtype == torch.float32 and torch.equal(x.grad, xr.grad)
    # the f32 sum of the bf16 products, rounded to the weight's compute type
    want = sw.stem_wgrad_plain(x0.bfloat16(), g.bfloat16()).bfloat16().float()
    assert torch.equal(w.grad, want)
    # torch's own bf16 weight gradient: the same within bf16 rounding
    err = float((w.grad - wr.grad).abs().max() / wr.grad.abs().max())
    assert err <= 2 ** -7, err


def _count_plain(monkeypatch):
    calls = []
    plain = sw.stem_wgrad_plain

    def spy(x, g):
        calls.append(tuple(x.shape))
        return plain(x, g)

    monkeypatch.setattr(sw, "stem_wgrad_plain", spy)
    return calls


def test_resnet_stem_flag_takes_the_function_in_train_mode_only(monkeypatch):
    calls = _count_plain(monkeypatch)
    torch.manual_seed(0)
    nets = [ResNet3D(backbone="resnet18") for _ in range(2)]
    nets[0].reset_parameters(torch.Generator().manual_seed(1))
    nets[1].load_state_dict(nets[0].state_dict())
    nets[1].stem_wgrad_kernel = True
    vol = torch.rand((1, 32, 32, 32, CIN), generator=torch.Generator().manual_seed(2))
    outs, grads = [], []
    for net in nets:
        net.train()
        v = vol.clone().requires_grad_()
        out = net(v)
        out.sum().backward()
        outs.append(out.detach())
        grads.append((v.grad, net.conv1.weight.grad))
    assert calls == [(1, 32, 32, 32, CIN)]
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(grads[0][0], grads[1][0])
    dw, ref = grads[1][1], grads[0][1]
    assert float((dw - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    with torch.no_grad():
        nets[1](vol)
    nets[1].eval()
    nets[1](vol.requires_grad_()).sum().backward()
    assert len(calls) == 1


def test_joint_pipeline_reads_the_gate_once(monkeypatch):
    monkeypatch.delenv("NERAF_STEM_WGRAD_PALLAS", raising=False)
    off = build_joint_pipeline(grid_res=8, tiny=True, device="cpu",
                               mixed_precision=False)
    monkeypatch.setenv("NERAF_STEM_WGRAD_PALLAS", "1")
    on = build_joint_pipeline(grid_res=8, tiny=True, device="cpu",
                              mixed_precision=False)
    assert not off.resnet.stem_wgrad_kernel and on.resnet.stem_wgrad_kernel
    monkeypatch.setenv("NERAF_STEM_WGRAD_PALLAS", "0")
    assert on.resnet.stem_wgrad_kernel  # read when the pipeline is built


@pytest.mark.cuda
@pytest.mark.parametrize("cin", [7, 8], ids=["cin7", "packed"])
@pytest.mark.parametrize("shape", [(16, 16, 16), (10, 18, 34), (10, 34, 18),
                                   (13, 19, 37), (128, 128, 128)],
                         ids=["cube", "asymmetric", "asymmetric_h", "ragged",
                              "step"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_stem_wgrad_kernel_matches_plain_on_card(shape, dtype, cin):
    """The kernel against the plain version in float64 on the same inputs,
    to 1e-4 of the peak (f32 sums over up to 262,144 products); one launch
    a call, and a second call bitwise equal to the first (fixed summation
    order). cin 7, the ResNet's grid channels: the split pass pads them to
    the kernel's 8; packed: a zero 8th channel given, whose dW channel is
    exactly zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    x, g = _inputs(len(shape) + shape[0], shape, 64)
    xt = torch.from_numpy(x).cuda().to(dtype)
    if cin == 8:
        xt = F.pad(xt, (0, 1))
    gt = torch.from_numpy(g).cuda().to(dtype)
    n = sw_cuda.LAUNCHES
    got = sw.stem_wgrad(xt, gt)
    again = sw.stem_wgrad(xt, gt)
    torch.cuda.synchronize()
    assert sw_cuda.LAUNCHES == n + 2 and got.dtype == torch.float32
    assert got.shape == (64, cin, 5, 5, 5) and torch.equal(got, again)
    want = sw.stem_wgrad_plain(xt.double(), gt.double())
    err = float((got.double() - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max()), err
    if cin == 8:
        assert float(got[:, 7].abs().max()) == 0.0


@pytest.mark.cuda
def test_stem_conv_runs_the_kernel_on_card():
    """stem_conv on the card: the forward is cuDNN's conv, dW the kernel's
    (one launch), dx cuDNN's input gradient, against the autograd of
    F.conv3d, each to 1e-4 of its peak (f32, TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    x, g = _inputs(9, (32, 24, 16), 64)
    w = np.random.default_rng(10).normal(size=(64, CIN, 5, 5, 5)).astype(np.float32)
    xs, ws = (torch.from_numpy(a).cuda().requires_grad_() for a in (x, w))
    xr, wr = (torch.from_numpy(a).cuda().requires_grad_() for a in (x, w))
    n = sw_cuda.LAUNCHES
    stem_conv(xs, ws).backward(torch.from_numpy(g).cuda())
    F.conv3d(xr.permute(0, 4, 1, 2, 3), wr, None, 2, 2).backward(
        torch.from_numpy(g).cuda())
    torch.cuda.synchronize()
    assert sw_cuda.LAUNCHES == n + 1
    # cuDNN may pick another input-gradient algorithm when asked for dx alone
    for got, want in ((xs.grad, xr.grad), (ws.grad, wr.grad)):
        err = float((got - want).abs().max() / want.abs().max())
        assert err <= 1e-4, err
