"""The main field's colour branch (ops/field_head.py, csrc/field_head.cu).

On the CPU: the packed head's layout (pack_head's round trip, and the
wrapper's packing against tile_layers), the packing made once a
weights_fixed() scope and anew outside one, field_head_plain against the
chain rgb_from_features ran before it, bit for bit, and the dispatch
taking the plain chain on a CPU tensor and under autograd without a
launch, in a tiny joint train step and its bake sweep too.

On a card (marked `cuda`, skipped here): the kernel against the plain chain
at the render shapes and at a ragged row count. The kernel rounds where the
plain chain's `dense` rounds (the f32 product, the bias and their sum, each
to bf16), so the two differ only by the order of the products' f32 sums,
which flips a bf16 rounding in a few rows. It is held to one bf16 step
(2^-8) of the plain bf16 chain at the max, and to lie no farther from the
float32 plain chain than the bf16 plain chain does, beyond that step. The
field's own initial scale (lecun-normal weights; small biases added so that
the bias adds count) keeps the outputs in (0.1, 0.8); He's scale, twice the
weight variance, spreads them wider, where a rounding of the bf16 chain
moves the output further. A first design that rounded once, after an f32
bias, lay nearer the float32 chain but up to two steps off the plain bf16
chain there and at the tiny head (PERF.md). The launches: one a call, 8 for
a 512 x 512 render_image, none with a gradient recorded (a train step), one
a batch of the no-grad bake sweep; a float32 field takes the plain chain
(ops/field_head.py). A render after a fused Adam step, which leaves the
weights' version counters as they were, uses the new weights.
"""

import math

import numpy as np
import pytest
import torch

from neraf_tpu_torch.configs.config import VisionModelConfig
from neraf_tpu_torch.data import loader, vision_data
from neraf_tpu_torch.engine import factory
from neraf_tpu_torch.fields.nerfacto import NerfactoField
from neraf_tpu_torch.ops.cuda import field_head as head_cuda
from neraf_tpu_torch.ops.encodings import sh_encoding
from neraf_tpu_torch.ops.field_head import field_head_plain, pack_head
from neraf_tpu_torch.ops.pe_mlp import dense, tile_layers
from neraf_tpu_torch.utils.profiling import counters
from neraf_tpu_torch.utils.weight_cache import cached, weights_fixed

STEP = 2.0 ** -8
RENDER_RAYS, SAMPLES = 32768, 48  # a render chunk: 1,572,864 rows
RAGGED = 3 * 128 + 37
# (geo, appearance, hidden, hidden layers): the serving head (63 -> 64 x 3
# -> 3), the tests' and CLI's tiny one (27 -> 16 x 3 -> 3) and Nerfacto's
# published head (63 -> 64 x 2 -> 3)
WIDTHS = {"serving": (15, 32, 64, 3), "tiny": (7, 4, 16, 3),
          "nerfacto": (15, 32, 64, 2)}


def _field(widths, dtype, seed=0, bias_std=0.1, weight_gain=1.0):
    """A NerfactoField with the head of `widths`, its own initialisers
    (weights scaled by weight_gain) and normal(0, bias_std) head biases."""
    G, E, hc, depth = WIDTHS[widths]
    cfg = VisionModelConfig(geo_feat_dim=G, appearance_embed_dim=E,
                            hidden_dim_color=hc, hidden_layers_color=depth,
                            base_mlp_width=16, base_mlp_layers=1,
                            num_frequencies=2)
    field = NerfactoField(cfg, num_cameras=8, dtype=dtype)
    gen = torch.Generator().manual_seed(seed)
    field.reset_parameters(gen)
    with torch.no_grad():
        for lin in (*field.mlp_head, field.head_out):
            lin.weight.mul_(weight_gain)
            lin.bias.normal_(0.0, bias_std, generator=gen)
    return field


def _inputs(field, rays, S, seed=1, device="cpu"):
    """Directions (rays, S, 3) expanded over the samples as VisionModel
    passes them (S = 1: one row each), geo as the (.., 1 + G) base output's
    view, camera indices expanded alike."""
    gen = torch.Generator().manual_seed(seed)
    G = field.config.geo_feat_dim
    d = torch.nn.functional.normalize(torch.randn(rays, 3, generator=gen), dim=-1)
    cam = torch.randint(0, 8, (rays,), generator=gen)
    base = torch.randn(rays, S, 1 + G, generator=gen).to(field.dtype)
    d, cam, base = d.to(device), cam.to(device), base.to(device)
    if S == 1:
        return d[:, None], base[..., 1:], cam[:, None]
    return (d[:, None].expand(rays, S, 3), base[..., 1:],
            cam[:, None].expand(rays, S))


def _previous_rgb(field, directions, geo, camera_indices, average):
    """NerfactoField.rgb_from_features as it was before ops/field_head.py."""
    d_enc = sh_encoding((directions + 1.0) / 2.0)
    if average:
        emb = field.appearance.weight.mean(dim=0).expand(
            *geo.shape[:-1], field.appearance.embedding_dim)
    else:
        emb = field.appearance(camera_indices)
    h = torch.cat([d_enc, geo.to(torch.float32), emb], dim=-1)
    for lin in field.mlp_head:
        h = torch.relu(dense(h, lin.weight, lin.bias, field.dtype))
    out = field.head_out
    return torch.sigmoid(dense(h, out.weight, out.bias, field.dtype))


def _unpack_head(w, b, dims, in_dim, hidden):
    """pack_head's layout back to [(W (out, in), b)] without the padding."""
    k0p, hp, op, L = dims["k0p"], dims["hp"], dims["op"], dims["n_hidden"]
    out, off = [], 0
    for i in range(L + 1):
        rows, cols = (op, hp) if i == L else (hp, k0p if i == 0 else hp)
        keep = dims["out_dim"] if i == L else hidden
        out.append((w[off:off + rows * cols].reshape(rows, cols)[
            :keep, :in_dim if i == 0 else hidden], b[i * hp:i * hp + keep]))
        off += rows * cols
    return out


def _tiny_joint_step_and_sweep(dev):
    """Launches of a tiny bf16 joint train step (its vision forward and bake
    record gradients) and of the no-grad bake sweep over the grid's 512
    cells in batches of 256 (query_grid_full, S = 1)."""
    rng = np.random.default_rng(9)
    cams = vision_data.camera_arrays(vision_data.synthetic_cameras(8, 6, 5),
                                     dev)
    images = {"images": torch.from_numpy(
        rng.uniform(0, 1, (8, 6, 5, 3)).astype(np.float32)).to(dev)}
    split = loader.audio_arrays(
        {"mic_pose": rng.normal(size=(3, 3)), "source_pose": rng.normal(
            size=(3, 3)), "rot": rng.uniform(size=(3, 3)),
         "log_stft": rng.normal(-3, 1, (3, 2, 257, 12))}, dev)
    pipe = factory.build_joint_pipeline(grid_res=8, tiny=True, device=dev,
                                        mixed_precision=True, seed=4)
    launches = lambda: counters().get("kernel.field_head", 0)
    before = launches()
    metrics = pipe.train_step(cams, split, images)
    assert all(np.isfinite(v) for v in metrics.values())
    step = launches() - before
    grid = pipe.query_grid_full(256)
    assert bool(torch.isfinite(grid).all())
    return step, launches() - before - step


# ------------------------------------------------------------------ CPU


@pytest.mark.parametrize("widths", sorted(WIDTHS))
def test_pack_head_round_trips(widths):
    """pack_head pads the head into the kernel's widths with x0's columns in
    order and zeros elsewhere, from which the layers come back; the
    wrapper's packing is tile_layers of pack_head, bit for bit."""
    field = _field(widths, torch.float32)
    layers = field.head_layers()
    G, E, hc, depth = WIDTHS[widths]
    w, b, dims = pack_head(layers, torch.float32)
    k_in = 16 + G + E
    assert dims == dict(k0p=-(-k_in // 16) * 16, hp=hc, op=8, n_hidden=depth,
                        out_dim=3)
    assert w.numel() == hc * dims["k0p"] + (depth - 1) * hc * hc + 8 * hc
    assert b.numel() == depth * hc + 8
    first = w[:hc * dims["k0p"]].reshape(hc, dims["k0p"])
    assert torch.equal(first[:, k_in:], torch.zeros_like(first[:, k_in:]))
    for (gw, gb), (rw, rb) in zip(_unpack_head(w, b, dims, k_in, hc), layers):
        assert torch.equal(gw, rw) and torch.equal(gb, rb)
    assert int((w != 0).sum()) == sum(int((t != 0).sum()) for t, _ in layers)
    assert int((b != 0).sum()) == sum(int((t != 0).sum()) for _, t in layers)
    w16, _, dims16 = pack_head(layers, torch.bfloat16)
    gw, gb, gdims = head_cuda.pack(layers)
    assert gdims == dims16 and gw.dtype == torch.bfloat16
    assert torch.equal(gw, tile_layers(w16, dims16)) and torch.equal(gb, b)


def test_packing_is_made_once_a_weights_fixed_scope():
    """`cached` makes its value anew every call outside a weights_fixed()
    scope, once for the same tensors inside one (nested scopes share it),
    anew for other tensors, and again in the next scope."""
    field = _field("tiny", torch.bfloat16)
    tensors = [t for wb in field.head_layers() for t in wb]
    made = []

    def make():
        made.append(1)
        return head_cuda.pack(field.head_layers())

    cached("test head", tensors, make)
    cached("test head", tensors, make)
    assert len(made) == 2
    with weights_fixed():
        first = cached("test head", tensors, make)
        with weights_fixed():
            assert cached("test head", tensors, make) is first
        assert cached("test head", tensors, make) is first
        cached("test head", tensors[:-1], make)
        assert len(made) == 4
    with weights_fixed():
        assert cached("test head", tensors, make) is not first
    assert len(made) == 5


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("S", [SAMPLES, 1])
@pytest.mark.parametrize("average", [True, False], ids=["average", "camera"])
def test_field_head_plain_is_the_previous_chain(average, S, dtype):
    """field_head_plain and rgb_from_features give the previous chain's
    output bit for bit, with the average and the per-camera appearance, at
    S = 48 (a render chunk's expand) and S = 1 (the bake)."""
    field = _field("serving", dtype)
    d, geo, cam = _inputs(field, 5, S)
    want = _previous_rgb(field, d, geo, cam, average)
    got = field_head_plain(d, geo, cam, field.appearance.weight,
                           field.head_layers(), average, dtype)
    assert got.dtype == want.dtype == dtype
    assert torch.equal(got, want)
    assert torch.equal(field.rgb_from_features(d, geo, cam, average), want)


def test_cpu_and_autograd_take_the_plain_chain():
    """A CPU tensor runs the plain chain and launches nothing; so does a
    grad-enabled call, whose gradient reaches the head and the table."""
    field = _field("tiny", torch.bfloat16)
    d, geo, cam = _inputs(field, 3, SAMPLES)
    before = counters().get("kernel.field_head", 0)
    with torch.inference_mode():
        out = field.rgb_from_features(d, geo, cam, True)
    assert torch.equal(out, _previous_rgb(field, d, geo, cam, True))
    out = field.rgb_from_features(d, geo, cam, False)
    out.float().sum().backward()
    assert field.head_out.weight.grad is not None
    assert field.appearance.weight.grad is not None
    assert counters().get("kernel.field_head", 0) == before


def test_cpu_train_step_and_bake_sweep_launch_nothing():
    assert _tiny_joint_step_and_sweep(torch.device("cpu")) == (0, 0)


def test_field_head_cuda_rejects_other_devices():
    field = _field("tiny", torch.bfloat16)
    d, geo, cam = _inputs(field, 2, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        head_cuda.field_head_cuda(d, geo, cam, field.appearance.weight,
                                  field.head_layers(), True)


# ----------------------------------------------------------------- card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _on_card(field, rays, S, seed):
    dev = _card()
    field = field.to(dev)
    return field, _inputs(field, rays, S, seed, dev)


def _three_ways(field, n, S, average, seed):
    """The kernel, the plain bf16 chain and the plain float32 chain on n
    rows, S a direction, as float64. The kernel runs through
    rgb_from_features (counted) when the rows are whole rays, with the
    expands VisionModel passes, else through launch on the rays' flat
    directions (the last ray cut short)."""
    rays = -(-n // S)
    field, (d, geo, cam) = _on_card(field, rays, S, seed)
    flat = lambda t: t.reshape(rays * S, *t.shape[2:])[:n]
    d_n, geo_n, cam_n = flat(d), flat(geo), flat(cam)
    table, layers = field.appearance.weight, field.head_layers()
    before = counters().get("kernel.field_head", 0)
    with torch.inference_mode():
        if n == rays * S:
            got = field.rgb_from_features(d, geo, cam, average).reshape(n, 3)
        elif average:
            got = head_cuda.launch(d[:, 0].contiguous(), S, geo_n,
                                   table.mean(dim=0)[None], None, layers)
        else:
            got = head_cuda.launch(d[:, 0].contiguous(), S, geo_n, table,
                                   cam[:, 0].contiguous(), layers)
        plain16, plain32 = (
            field_head_plain(d_n, geo_n, cam_n, table, layers, average, dtype)
            for dtype in (torch.bfloat16, torch.float32))
    torch.cuda.synchronize()
    assert counters().get("kernel.field_head", 0) == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (n, 3)
    return got.double(), plain16.double(), plain32.double()


@pytest.mark.cuda
@pytest.mark.parametrize("widths", sorted(WIDTHS))
@pytest.mark.parametrize("rows", [RENDER_RAYS * SAMPLES, RAGGED],
                         ids=["render", "ragged"])
@pytest.mark.parametrize("S", [SAMPLES, 1])
@pytest.mark.parametrize("average", [True, False], ids=["average", "camera"])
def test_field_head_kernel_matches_plain_on_card(average, S, rows, widths):
    """The kernel against the plain chain at a render chunk's 1,572,864 rows
    and at 3 x 128 + 37, for each head (3 hidden layers, and Nerfacto's 2):
    one bf16 step of the bf16 chain at the max, and no
    farther from the float32 chain than the bf16 chain, beyond that step
    (module docstring)."""
    got, plain16, plain32 = _three_ways(_field(widths, torch.bfloat16), rows,
                                        S, average, seed=len(widths) + S)
    assert float((got - plain16).abs().max()) <= STEP
    own = float((plain16 - plain32).abs().max())
    assert float((got - plain32).abs().max()) <= own + STEP


@pytest.mark.cuda
@pytest.mark.parametrize("S", [SAMPLES, 1])
def test_field_head_kernel_at_he_scale_on_card(S):
    """At He's weight scale, outputs spread over (0.1, 0.9): the bounds of
    test_field_head_kernel_matches_plain_on_card."""
    field = _field("serving", torch.bfloat16, seed=3,
                   weight_gain=math.sqrt(2.0))
    got, plain16, plain32 = _three_ways(field, RENDER_RAYS * SAMPLES // 4, S,
                                        False, seed=4)
    assert float(plain32.min()) < 0.15 and float(plain32.max()) > 0.85
    assert float((got - plain16).abs().max()) <= STEP
    own = float((plain16 - plain32).abs().max())
    assert float((got - plain32).abs().max()) <= own + STEP


@pytest.mark.cuda
def test_field_head_kernel_with_a_camera_a_row_on_card():
    """Directions expanded over a ray's samples but a camera of each row's
    own: the kernel then reads a direction and a camera a row."""
    field, (d, geo, cam) = _on_card(_field("serving", torch.bfloat16), 64,
                                    SAMPLES, seed=6)
    gen = torch.Generator(device=cam.device).manual_seed(6)
    cam = torch.randint(0, 8, cam.shape, device=cam.device, generator=gen)
    before = counters().get("kernel.field_head", 0)
    with torch.inference_mode():
        got = field.rgb_from_features(d, geo, cam, False)
        want = field_head_plain(d, geo, cam, field.appearance.weight,
                                field.head_layers(), False, torch.bfloat16)
    torch.cuda.synchronize()
    assert counters().get("kernel.field_head", 0) == before + 1
    assert float((got.double() - want.double()).abs().max()) <= STEP


@pytest.mark.cuda
def test_field_head_grad_enabled_takes_the_plain_chain_on_card():
    """With a gradient recorded the card runs the plain chain (no launch),
    and the gradient reaches the head."""
    field, (d, geo, cam) = _on_card(_field("tiny", torch.bfloat16), 64,
                                    SAMPLES, seed=2)
    before = counters().get("kernel.field_head", 0)
    out = field.rgb_from_features(d, geo, cam, False)
    want = field_head_plain(d, geo, cam, field.appearance.weight,
                            field.head_layers(), False, torch.bfloat16)
    out.float().sum().backward()
    torch.cuda.synchronize()
    assert counters().get("kernel.field_head", 0) == before
    assert torch.equal(out, want)
    assert field.mlp_head[0].weight.grad is not None


@pytest.mark.cuda
def test_render_image_launches_the_kernel_once_a_chunk_on_card():
    """A 512 x 512 render_image of the tiny bf16 pipeline is 8 chunks of
    32,768 rays: 8 launches."""
    dev = _card()
    pipe = factory.build_vision_pipeline(tiny=True, device=dev,
                                         mixed_precision=True)
    before = counters().get("kernel.field_head", 0)
    out = pipe.render_image(_cams(dev), 0, 512, 512)
    torch.cuda.synchronize()
    assert counters().get("kernel.field_head", 0) == before + 8
    assert bool(torch.isfinite(out["rgb"].float()).all())


def _cams(dev):
    return {
        "c2w": torch.eye(4, device=dev)[:3][None],
        "fx": torch.full((1,), 400.0, device=dev),
        "fy": torch.full((1,), 400.0, device=dev),
        "cx": torch.full((1,), 256.0, device=dev),
        "cy": torch.full((1,), 256.0, device=dev),
    }


@pytest.mark.cuda
def test_f32_field_takes_the_plain_chain_on_card():
    """A float32 field's render launches no colour kernel, and its colour
    branch is the plain chain's, bit for bit."""
    dev = _card()
    pipe = factory.build_vision_pipeline(tiny=True, device=dev,
                                         mixed_precision=False)
    before = counters().get("kernel.field_head", 0)
    out = pipe.render_image(_cams(dev), 0, 64, 64)
    field = pipe.vision_model.field
    d, geo, cam = _inputs(field, 64, SAMPLES, seed=8, device=dev)
    with torch.inference_mode():
        got = field.rgb_from_features(d, geo, cam, True)
        want = field_head_plain(d, geo, cam, field.appearance.weight,
                                field.head_layers(), True, torch.float32)
    torch.cuda.synchronize()
    assert counters().get("kernel.field_head", 0) == before
    assert out["rgb"].dtype == torch.float32 and torch.equal(got, want)


@pytest.mark.cuda
def test_render_after_a_fused_adam_step_uses_the_new_weights_on_card():
    """A fused Adam step moves the weights without moving their version
    counters; the next render, in a scope of its own, packs them anew and
    equals a fresh pipeline loaded with them, bit for bit."""
    dev = _card()
    pipe = factory.build_vision_pipeline(tiny=True, device=dev,
                                         mixed_precision=True, seed=1)
    cams = _cams(dev)
    first = pipe.render_image(cams, 0, 64, 64)["rgb"]
    params = list(pipe.vision_model.parameters())
    opt = torch.optim.Adam(params, lr=0.05, fused=True)
    for p in params:
        p.grad = torch.ones_like(p)
    opt.step()
    moved = pipe.render_image(cams, 0, 64, 64)["rgb"]
    fresh = factory.build_vision_pipeline(tiny=True, device=dev,
                                          mixed_precision=True, seed=2)
    fresh.vision_model.load_state_dict(pipe.vision_model.state_dict())
    want = fresh.render_image(cams, 0, 64, 64)["rgb"]
    assert not torch.equal(moved, first)
    assert torch.equal(moved, want)


@pytest.mark.cuda
def test_train_step_launches_nothing_and_the_bake_sweep_once_a_batch_on_card():
    """On the card a training step takes the plain chain (0 launches); the
    no-grad bake sweep takes the kernel once a batch (2)."""
    assert _tiny_joint_step_and_sweep(_card()) == (0, 2)
