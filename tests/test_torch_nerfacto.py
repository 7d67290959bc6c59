"""NeRAF's published radiance model, nerfstudio's Nerfacto with two hash
proposal fields (fields/nerfacto.py::HashDensityField), against the
benchmark's plain PyTorch reference (portbench/reference/nerfacto.py), on
the CPU at the tiny sizes in float32.

The JAX package cannot build a hash proposal field, so the plain reference
is this model's only one. The program is built from the configuration file
portbench/configs/ss_nerfacto.json cut to tiny sizes, as the benchmark's
kind builds it (through a config.yml round trip), and loaded with the
reference's weights (inputs.make_weights of param_shapes). Held to it: an
eval image (rgb, median depth, accumulation), a train-mode forward's
losses and every parameter's gradient, and the proposal fields' mask. The
default configurations keep their parameters; the joint pipeline trains
and bakes the model; a whole run of the cell at the tiny sizes is correct
and its float8 control is not.

On a card (marked `cuda`, skipped here): the hash kernels at the published
grids and row counts against the plain version, and a 512 x 512 render's
launches.
"""

import copy
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from neraf_tpu_torch.configs import config as tconfig
from neraf_tpu_torch.data import loader, vision_data
from neraf_tpu_torch.engine import factory
from neraf_tpu_torch.models.vision import VisionModel
from neraf_tpu_torch.ops import hashgrid
from neraf_tpu_torch.utils.profiling import counters
from portbench.core import inputs, program
from portbench.core import spec as bench
from portbench.core.common import Run
from portbench.reference import nerfacto as ref
from portbench.reference import neraf

REPO = Path(__file__).resolve().parents[1]
KIND = bench.kind("nerfacto_image")
CPU = torch.device("cpu")
H, W = 6, 5  # 30 rays in chunks of 16: one ragged
SEED = 2**31 + 17
DENSER = 2.0  # added to the main field's density logit: x e^2


def _config(name: str) -> dict:
    return json.loads((REPO / "portbench" / "configs" / f"{name}.json").read_text())


def _tiny_spec() -> dict:
    """ss_nerfacto's model section at the tiny sizes, float32: the main grid
    4 x 2, 2^10 rows, 4-32; the proposal grids 3 x 2, 2^8 rows, 4-16 and
    4-32 (a dense level and hashed ones each), hidden 8; samples (16, 12)
    -> 8; the published depths."""
    spec = copy.deepcopy(_config("ss_nerfacto")["model"])
    spec["mixed_precision"] = False
    v = spec["vision"]
    v.update(geo_feat_dim=7, hidden_dim_color=16, appearance_embed_dim=4,
             num_proposal_samples=[16, 12], num_nerf_samples=8,
             eval_num_rays_per_chunk=16)
    v["hash"].update(num_levels=4, log2_hashmap_size=10, base_res=4, max_res=32,
                     hidden_dim=16)
    for p, top in zip(v["proposal"], (16, 32)):
        p.update(num_levels=3, log2_hashmap_size=8, base_res=4, max_res=top,
                 hidden_dim=8)
    return spec


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(spec, reference weights, the port's pipeline built from the spec's
    ExperimentConfig after a config.yml round trip, cameras)."""
    spec = _tiny_spec()
    path = tmp_path_factory.mktemp("nerfacto") / "config.yml"
    tconfig.save_config(KIND.experiment_config(spec), path)
    cfg = tconfig.load_config(path)
    assert cfg.vision_model == KIND.experiment_config(spec).vision_model
    pipe = KIND.vision_pipeline(spec, cfg, CPU)
    weights = inputs.make_weights(ref.param_shapes(spec), SEED, CPU)
    # a main field denser than the proposals', so that the interlevel loss
    # binds and both proposal fields take a gradient
    weights[f"{ref.PREFIX}field.base_out.bias"][0] += DENSER
    inputs.load_weights(pipe.vision_model, weights, ref.PREFIX)
    cams = inputs.cameras(4, inputs.generator(CPU, SEED, "cameras"), 0.5, 15.0, 4.0, H, W)
    return spec, weights, pipe, cams


def test_the_kind_builds_the_published_model():
    """The full-width file gives nerfacto_model_config()'s fields, and the
    reference's names and shapes are the port's parameters."""
    spec = _config("ss_nerfacto")["model"]
    vm = KIND.experiment_config(spec).vision_model
    want = factory.nerfacto_model_config()
    for name in ("encoding", "num_levels", "features_per_level", "log2_hashmap_size",
                 "base_res", "max_res", "hidden_dim", "proposal_encoding",
                 *tconfig.PORT_ONLY_VISION):
        assert getattr(vm, name) == getattr(want, name), name
    with torch.device("meta"):
        model = VisionModel(vm, num_cameras=8)
    got = {ref.PREFIX + k: tuple(t.shape) for k, t in model.state_dict().items()}
    assert got == ref.param_shapes(spec)


@pytest.mark.parametrize("name", ["ss_fourier", "ss_hash"])
def test_default_configurations_keep_their_parameters(name):
    """ss_fourier and ss_hash build the parameters they built before the
    hash proposal fields and the depths (the harness's names and shapes)."""
    spec = _config(name)["model"]
    with torch.device("meta"):
        model = VisionModel(program.experiment_config(spec).vision_model, num_cameras=8)
    got = {ref.PREFIX + k: tuple(t.shape) for k, t in model.state_dict().items()}
    assert got == neraf.param_shapes(spec, ("vision",))


def test_render_image_matches_the_reference(tiny):
    """An eval image in two chunks: rgb and accumulation to 1e-5, median
    depth to 1e-5 of itself (float32 on both sides; the hash sums and the
    samplers' arithmetic round in other orders, ~1e-7 a step)."""
    spec, weights, pipe, cams = tiny
    for k in range(2):
        cam1 = {n: t[k:k + 1] for n, t in cams.items()}
        got = pipe.render_image(cam1, 0, H, W)
        want = ref.render_image(weights, spec["vision"], cam1, H, W)
        for key in ("rgb", "accumulation"):
            assert float((got[key] - want[key]).abs().max()) <= 1e-5, key
        assert float(((got["depth"] - want["depth"]) / want["depth"]).abs().max()) <= 1e-5
        assert float(want["accumulation"].min()) > 0.0


def test_train_forward_matches_the_reference_losses_and_gradients(tiny):
    """A train-mode forward (camera corrections, one jitter a ray and
    sampler, anneal 0.7): the three losses to 1e-5 of each, and the
    gradient of every parameter, both proposal tables and MLPs included, to
    1e-4 of its largest entry (sums of float32 terms in other orders; the
    table gradients are scatter-adds of ~10^3 terms a row)."""
    spec, weights, pipe, cams = tiny
    model, v = pipe.vision_model, spec["vision"]
    g = torch.Generator().manual_seed(5)
    R = 24
    cam = torch.randint(0, 4, (R,), generator=g)
    px, py = torch.randint(0, W, (R,), generator=g), torch.randint(0, H, (R,), generator=g)
    origins, dirs = neraf.camera_rays(cams, cam, px, py)
    gt = torch.rand((R, 3), generator=g)
    jitter = [torch.rand((R, 1), generator=g) for _ in range(3)]
    model.train()
    try:
        model.zero_grad(set_to_none=True)
        out = model({"origins": origins, "directions": dirs, "camera_indices": cam},
                     train=True, anneal=0.7, jitter=jitter)
        losses = model.loss(out, gt)
        sum(losses.values()).backward()
    finally:
        model.eval()
    P = {k: t.clone().requires_grad_() for k, t in weights.items()}
    rout = ref.vision_forward(P, v, origins, dirs, cam, True, anneal=0.7, jitter=jitter)
    rlosses = ref.vision_losses(v, rout, gt)
    sum(rlosses.values()).backward()
    for k, want in rlosses.items():
        got, want = float(losses[k].detach()), float(want.detach())
        assert abs(got - want) <= 1e-5 * abs(want), k
    grads = {ref.PREFIX + k: p.grad for k, p in model.named_parameters()}
    assert set(grads) == set(P)
    for k, p in P.items():
        peak = float(p.grad.abs().max())
        assert peak > 0.0, k
        assert float((grads[k] - p.grad).abs().max()) <= 1e-4 * peak, k


def test_proposal_mask_matches_the_reference(tiny):
    """Points outside the open cube (0, 1)^3 take zero density, as
    nerfstudio's HashMLPDensityField masks them: the box's points
    uncontracted (some outside, some on its faces), and contracted points so
    far out that they round onto the faces."""
    spec, weights, pipe, _ = tiny
    g = torch.Generator().manual_seed(7)
    x = torch.rand((400, 3), generator=g) * 1.5 - 0.25
    x[:4], x[4:8, 1] = 0.0, 1.0
    far = torch.nn.functional.normalize(torch.randn((50, 3), generator=g), dim=-1) * 1e30
    for k, p in enumerate(spec["vision"]["proposal"]):
        field = pipe.vision_model.proposal_networks[k]
        prefix = f"{ref.PREFIX}proposal_networks.{k}."
        with torch.no_grad():
            got = field(x, contract=False)
            want = ref.proposal_density(weights, prefix, p, 0.01, x, contract=False)
            inside = torch.all((x > 0.0) & (x < 1.0), dim=-1)
            assert torch.equal(got == 0.0, ~inside) and torch.equal(want == 0.0, ~inside)
            assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
            assert torch.equal(field(far), torch.zeros(50))
            assert torch.equal(ref.proposal_density(weights, prefix, p, 0.01, far),
                               torch.zeros(50))


def test_joint_pipeline_trains_and_bakes_the_published_model():
    """JointPipeline.train_step on the tiny published model: both proposal
    tables lie in the proposal_networks Adam group and move; then the
    no-grad bake sweep (query_grid_full) over the grid."""
    rng = np.random.default_rng(4)
    cfg = factory.joint_config(tiny=True)
    cfg.vision_model = factory.nerfacto_model_config(tiny=True)
    pipe = factory.build_joint_pipeline(grid_res=8, tiny=True, device="cpu",
                                        mixed_precision=False, config=cfg, seed=3)
    with torch.no_grad():
        pipe.vision_model.field.base_out.bias[0] += DENSER
    tables = [p.hash.table for p in pipe.vision_model.proposal_networks]
    group = pipe.optimizers["proposal_networks"].params
    assert all(any(t is q for q in group) for t in tables)
    before = [t.detach().clone() for t in tables]
    cams = vision_data.camera_arrays(vision_data.synthetic_cameras(8, H, W), "cpu")
    images = {"images": torch.from_numpy(rng.uniform(0, 1, (8, H, W, 3)).astype(np.float32))}
    split = loader.audio_arrays(
        {"mic_pose": rng.normal(size=(3, 3)), "source_pose": rng.normal(size=(3, 3)),
         "rot": rng.uniform(size=(3, 3)), "log_stft": rng.normal(-3, 1, (3, 2, 257, 12))},
        "cpu")
    metrics = pipe.train_step(cams, split, images)
    assert all(np.isfinite(x) for x in metrics.values())
    assert all(not torch.equal(t.detach(), b) for t, b in zip(tables, before))
    grid = pipe.query_grid_full(256)
    assert bool(torch.isfinite(grid).all())
    assert not torch.equal(grid[:, :4], pipe.grid[:, :4])


def test_work_of_a_published_image():
    """The kind's counts at 512 x 512: 92,274,688 proposal samples and
    12,582,912 main-field samples; FLOPs 32.5 G (proposals) + 77.3 G (base)
    + 209.4 G (head); the hash bound covers the proposals' and the main
    field's encodings."""
    v = _config("ss_nerfacto")["model"]["vision"]
    rays = 512 * 512
    assert KIND.proposal_points(v, rays) == rays * sum(v["num_proposal_samples"]) == 92_274_688
    flops = KIND.flops(v, rays)
    want = (2 * (10 * 16 + 16) * rays * 352
            + 2 * (32 * 64 + 64 * 16) * rays * 48
            + 2 * (63 * 64 + 64 * 64 + 64 * 3) * rays * 48)
    assert flops == want and 3.18e11 < flops < 3.2e11
    assert KIND.pixels(512, 512) == rays
    prop = KIND.proposal_hash_bound_ms(v, rays)
    main = KIND.hash_bound_ms(v, rays) - prop
    assert prop > 0.0 and main > 0.0
    assert main == pytest.approx(
        KIND.hash_fwd_bound_ms(v, rays * v["num_nerf_samples"]))


def test_a_whole_run_of_the_cell_at_tiny_sizes():
    """ss_nerfacto.image512's kind through the closed loop at the tiny
    sizes (16 x 16 views): a sound run is correct; the float8 control is
    not, under the cell's limits."""
    cell = bench.resolve("ss_nerfacto.image512")
    traffic = {**cell.traffic, "height": 16, "width": 16, "camera_pool": 8, "clients": 2,
               "warm_requests": 1, "traced_requests": 1, "check_requests": 1,
               "check_pool": 2}
    spec = _tiny_spec()
    spec["vision"]["eval_num_rays_per_chunk"] = 128

    def run(control=None):
        return Run(cell=cell.name, spec=spec, traffic=traffic, limits=dict(cell.limits),
                   seed=SEED, seconds=1.0, trace=False, device=CPU,
                   started=time.perf_counter(), control=control)

    sound = KIND.drive(run())
    # correct needs at least one request judged (none leaves its gaps
    # infinite); a loaded host may finish none inside the 1 s window
    assert sound.correct is True, sound.notes
    assert sound.record.work["pixels"] == 256
    assert KIND.drive(run("fp8")).correct is False


# ----------------------------------------------------------------- card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("L,lt,top,n", [(5, 17, 128, 8_388_608), (5, 17, 256, 8_388_608),
                                        (16, 19, 2048, 1_572_864)],
                         ids=["proposal0", "proposal1", "main"])
def test_hash_kernels_at_the_published_grids_on_card(L, lt, top, n):
    """Kernels #5 and #5b at the published grids and a render chunk's
    points (a proposal field's 32,768 x 256, the main field's 32,768 x 48)
    against hash_encoding_plain and its autograd: the forward to 1e-6 of
    its peak (the same float32 FMAs in order), the table gradient and dx to
    1e-5 of theirs (atomic order)."""
    dev = _card()
    spec = hashgrid.HashGridSpec(num_levels=L, features_per_level=2, log2_hashmap_size=lt,
                                 base_res=16, max_res=top)
    g = torch.Generator(device=dev).manual_seed(L + top)
    table = (torch.rand((L, spec.table_size, 2), generator=g, device=dev) * 2 - 1)
    x = torch.rand((n, 3), generator=g, device=dev) * 1.2 - 0.1
    cot = torch.randn((n, spec.out_dim), generator=g, device=dev)
    launches = lambda: (counters().get("kernel.hash_fwd", 0),
                        counters().get("kernel.hash_bwd", 0))
    fwd, bwd = launches()
    tt, xx = table.clone().requires_grad_(), x.clone().requires_grad_()
    out = hashgrid.hash_encoding(tt, xx, spec)
    (out * cot).sum().backward()
    torch.cuda.synchronize()
    assert launches() == (fwd + 1, bwd + 1)
    rt, rx = table.clone().requires_grad_(), x.clone().requires_grad_()
    want = hashgrid.hash_encoding_plain(rt, rx, spec)
    (want * cot).sum().backward()
    for got, ref_, tol in ((out, want, 1e-6), (tt.grad, rt.grad, 1e-5),
                           (xx.grad, rx.grad, 1e-5)):
        err = float((got - ref_).detach().abs().max())
        assert err <= tol * float(ref_.detach().abs().max())


@pytest.mark.cuda
def test_published_model_render_launches_on_card():
    """A 512 x 512 render_image of the full-width published model, bf16: 8
    chunks, each 3 hash forward launches (two proposals, the main field) and
    one colour-kernel launch; no PE+MLP."""
    dev = _card()
    cfg = tconfig.ExperimentConfig(dataset="SoundSpaces")
    cfg.vision_model = factory.nerfacto_model_config()
    pipe = factory.build_vision_pipeline(device=dev, config=cfg)
    names = ("kernel.hash_fwd", "kernel.field_head", "kernel.pe_mlp_fwd")
    before = [counters().get(k, 0) for k in names]
    cams = inputs.cameras(1, inputs.generator(dev, SEED, "cameras"), 0.5, 15.0, 256.0,
                          512, 512)
    out = pipe.render_image(cams, 0, 512, 512)
    torch.cuda.synchronize()
    assert [counters().get(k, 0) - b for k, b in zip(names, before)] == [24, 8, 0]
    assert bool(torch.isfinite(out["rgb"].float()).all())
