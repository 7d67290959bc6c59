"""The work and bound functions against hand counts and against torch's
own FLOP counter on the reference, on the CPU."""


import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.core import spec as bench
from portbench.core import yardstick as ys
from portbench.reference import neraf as ref

SPEC = bench.resolve("ss_fourier.rir512").config["model"]


def test_acoustic_field_at_2048_rows():
    """1187 -> 5096 -> 2048 -> 1024 -> 1024 -> 512 -> 2 x 257: 8.364e10
    forward FLOPs at 2,048 rows."""
    hand = 2 * 2048 * (1187 * 5096 + 5096 * 2048 + 2048 * 1024 + 1024 * 1024
                       + 1024 * 512 + 2 * 512 * 257)
    assert ys.field_flops(SPEC["audio"], 2048) == hand
    assert abs(hand - 8.364e10) / 8.364e10 < 1e-3


def test_pe_mlp_bound_at_proposal_zero():
    """A step's proposal 0: 1,048,576 rows of 39 -> 128 -> 128 -> 1 in
    bf16, 0.0456 ms at 989 TFLOP/s."""
    n = 4096 * 256
    fwd = 2 * n * (39 * 128 + 128 * 128 + 128 * 1)
    got = ys.pe_mlp_bound_ms([([39, 128, 128, 1], 6, n, False, False)])
    assert got == pytest.approx(fwd / 989e12 * 1e3)
    assert got == pytest.approx(0.0456, abs=1e-4)
    with_bwd = ys.pe_mlp_bound_ms([([39, 128, 128, 1], 6, n, True, True)])
    assert with_bwd == pytest.approx(3 * got)


@pytest.mark.parametrize("cell,calls", [
    ("ss_fourier.image512", [512 * 512 * 256, 512 * 512 * 96, 512 * 512 * 48]),
    ("ss_hash.image512", [512 * 512 * 256, 512 * 512 * 96])])
def test_image_work_covers_the_pe_mlp_calls(cell, calls):
    """An image's PE+MLP forward calls: both proposals, and the main field
    where it is fourier; the hash cell's main field has a bound of its own."""
    from portbench.kinds.image import ImageServer

    c = bench.resolve(cell)
    server = ImageServer.__new__(ImageServer)
    server.spec, server.H, server.W = c.config["model"], 512, 512
    v = server.spec["vision"]
    dims = {512 * 512 * 48: ys.pe_dims(v, "main")}
    want = sum(ys.pe_mlp_bound_ms([(dims.get(n, ys.pe_dims(v, "proposal")), 0, n, False, False)])
               for n in calls)
    work = server.work()
    assert work["pe_mlp_bound_ms"] == pytest.approx(want)
    assert ("hash_bound_ms" in work) == (v["encoding"] == "hash")
    assert work["pixels"] == 512 * 512


def test_gl_bound_for_a_request():
    """1,024 channels of 78 frames at n_fft 512, 32 iterations, float32
    operations bound it: 1.075 ms."""
    flops = 32 * 1024 * 78 * (2 * 2.5 * 512 * 9 + 20 * 257)
    assert ys.gl_bound_ms(1024, 512, 78) == pytest.approx(flops / 67e12 * 1e3)
    assert ys.gl_bound_ms(1024, 512, 78) == pytest.approx(1.075, abs=2e-3)


def test_hash_bound_scales_with_points():
    v = bench.resolve("ss_hash.image512").config["model"]["vision"]
    one = ys.hash_fwd_bound_ms(v, 32768 * 48)
    assert ys.hash_fwd_bound_ms(v, 8 * 32768 * 48) == pytest.approx(8 * one)
    flops = 32768 * 48 * 8 * (9 + 8 * (2 + 8))
    assert one == pytest.approx(max(flops / 67e12, 32768 * 48 * (12 + 128) / 3.35e12) * 1e3)


@pytest.mark.parametrize("backbone,res", [("resnet18", 16), ("resnet50", 16)])
def test_conv_flops_match_torch_counter(backbone, res):
    spec = dict(SPEC["audio"], resnet=backbone)
    g = torch.Generator().manual_seed(0)
    P = {k: torch.randn(s, generator=g) * 0.1 for k, s in ref.resnet_shapes(spec).items()}
    for k in P:
        if k.endswith("running_var"):
            P[k] = P[k].abs() + 1.0
    vol = torch.rand((1, res, res, res, 7), generator=g)
    with FlopCounterMode(display=False) as fc:
        ref.resnet(P, spec, vol, False, P, prefix="")
    counted = sum(v for k, v in fc.get_flop_counts()["Global"].items()
                  if "convolution" in str(k))
    assert ys.conv_flops(spec, res)[0] == counted


def test_field_flops_match_torch_counter():
    a = SPEC["audio"]
    g = torch.Generator().manual_seed(0)
    P = {k: torch.randn(s, generator=g) * 0.01 for k, s in ref.field_shapes(a, "f.").items()}
    feat = torch.zeros(ref.resnet_feature_dim(a))
    n = 16
    with FlopCounterMode(display=False) as fc:
        ref.audio_field(P, a, feat, torch.arange(n), torch.rand(n, 3), torch.rand(n, 3),
                        torch.rand(n, 3), torch.tensor(a["aabb"]), prefix="f.")
    assert ys.field_flops(a, n) == fc.get_total_flops()


def test_rir_request_flops_near_the_hand_estimate():
    """A 512-RIR request: the eval ResNet over 7 x 128^3 and the field over
    39,936 frames, ~1.75 TFLOP; its Griffin-Lim bound is 1,024 channels'."""
    from portbench.kinds.rir import RirServer

    server = RirServer.__new__(RirServer)
    server.spec, server.n = SPEC, 512
    work = server.work()
    convs, _ = ys.conv_flops(SPEC["audio"], 128)
    assert work["flops"] == convs + ys.field_flops(SPEC["audio"], 512 * 78)
    assert 1.2e12 < work["flops"] < 2.3e12
    assert work["gl_bound_ms"] == ys.gl_bound_ms(1024, 512, 78)
    assert work["rirs"] == 512
