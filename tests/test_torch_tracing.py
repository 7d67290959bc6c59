"""The port's tracer (neraf_tpu_torch/utils/profiling.py) on the CPU, at the
tiny sizes: the spans of a RIR request, an image and a train step under
torch.profiler, nested as named and covering every aten op of the request;
a request's id on each of its spans; a hash proposal field's spans under
vision.proposal; nothing recorded and nothing
allocated while nothing records; the serving paths' counters; and the
benchmark's readers of the spans and counters (portbench/metrics)."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from neraf_tpu_torch.configs.config import ExperimentConfig
from neraf_tpu_torch.data import loader, vision_data
from neraf_tpu_torch.engine import factory
from neraf_tpu_torch.utils import profiling
from portbench.core import spec as bench
from portbench.core.common import Record
from portbench.core.trace import Trace

RIR_STAGES = ("rir.grid_feature", "rir.field", "rir.magnitude", "rir.angles",
              "rir.griffin_lim")
IMAGE_STAGES = ("image.rays", "vision.sampler", "vision.proposal", "vision.field",
                "vision.render", "image.assemble")
TRAIN_STAGES = ("train.vision_forward", "train.bake", "train.resnet_forward",
                "train.audio_forward", "train.backward", "train.optimizers")
H, W = 6, 5  # an image of 30 rays, in chunks of 16: one ragged


def _poses(n=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.rand((n, 3), generator=g) for _ in range(3)]


def _cams():
    return vision_data.camera_arrays(vision_data.synthetic_cameras(8, H, W), "cpu")


@pytest.fixture(scope="module")
def rir_pipe():
    return factory.build_render_pipeline(grid_res=8, tiny=True, device="cpu",
                                         mixed_precision=False)


@pytest.fixture(scope="module")
def vision_pipe():
    pipe = factory.build_vision_pipeline(tiny=True, device="cpu",
                                         mixed_precision=False)
    pipe.config.vision_model.eval_num_rays_per_chunk = 16
    return pipe


@pytest.fixture(scope="module")
def nerfacto_pipe():
    """The tiny published model: hash proposal fields."""
    cfg = ExperimentConfig(dataset="SoundSpaces")
    cfg.vision_model = factory.nerfacto_model_config(tiny=True)
    cfg.vision_model.eval_num_rays_per_chunk = 16
    return factory.build_vision_pipeline(device="cpu", mixed_precision=False, config=cfg)


def _profiled(fn):
    """fn() under torch.profiler (CPU) -> (its events, the span records
    stored meanwhile)."""
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof.events(), profiling.spans()


def _ancestors(e) -> list:
    out, p = [], e.cpu_parent
    while p is not None:
        out.append(p.name)
        p = p.cpu_parent
    return out


def _check_stages(events, top: str, stages, parents: dict):
    """Every span's cpu_parent is as `parents` names it, and every aten op
    under the span `top` lies under exactly one of `stages`."""
    P = profiling.PREFIX
    ranges = [e for e in events if e.name.startswith(P)]
    assert {e.name for e in ranges} >= {P + s for s in (top, *stages)}
    for e in ranges:
        want = parents.get(e.name[len(P):])
        if want is not None:
            assert e.cpu_parent is not None and e.cpu_parent.name == P + want, e.name
    ops = 0
    for e in events:
        chain = _ancestors(e)
        if P + top in chain and not e.name.startswith(P):
            assert sum(n in {P + s for s in stages} for n in chain) == 1, (e.name, chain)
            ops += 1
    assert ops > 0


def _one_request(recs, top: str):
    """The records of the one request `top` in recs: all carry its id."""
    (req,) = [r for r in recs if r["name"] == top]
    mine = [r for r in recs if r["request"] == req["request"]]
    assert len(mine) == len(recs)
    return req, mine


def test_rir_request_spans(rir_pipe):
    mic, src, rot = _poses()
    events, recs = _profiled(lambda: rir_pipe.render_waveforms(
        mic, src, rot, generator=torch.Generator().manual_seed(1)))
    _check_stages(events, "rir.request", RIR_STAGES,
                  {s: "rir.request" for s in RIR_STAGES})
    req, mine = _one_request(recs, "rir.request")
    assert sorted(r["name"] for r in mine) == sorted(("rir.request", *RIR_STAGES))
    assert all(r["parent"] == req["id"] for r in mine if r is not req)


def test_image_request_spans(vision_pipe):
    events, recs = _profiled(lambda: vision_pipe.render_image(_cams(), 0, H, W))
    parents = {"image.chunk": "image.request", "image.rays": "image.chunk",
               "image.assemble": "image.request",
               **{s: "image.chunk" for s in IMAGE_STAGES if s.startswith("vision.")}}
    _check_stages(events, "image.request", IMAGE_STAGES, parents)
    req, mine = _one_request(recs, "image.request")
    names = [r["name"] for r in mine]
    # 2 chunks, each rays, 3 sampler passes, 2 proposals, the field and
    # the renderers
    assert names.count("image.chunk") == 2 and names.count("image.rays") == 2
    assert names.count("vision.sampler") == 6 and names.count("vision.proposal") == 4
    assert names.count("vision.field") == names.count("vision.render") == 2
    assert names.count("image.assemble") == 1


PROPOSAL_PARTS = ("vision.proposal_encoding", "vision.proposal_mlp")


def test_hash_proposal_spans(vision_pipe, nerfacto_pipe):
    """A hash proposal field's grid and its layers are spans under each
    vision.proposal (2 chunks x 2 fields), the gathers under the one and
    the layers and trunc_exp under the other; the fourier proposals have
    neither."""
    P = profiling.PREFIX
    events, recs = _profiled(lambda: nerfacto_pipe.render_image(_cams(), 0, H, W))
    names = [r["name"] for r in recs]
    for part in PROPOSAL_PARTS:
        assert names.count(part) == names.count("vision.proposal") == 4
        ranges = [e for e in events if e.name == P + part]
        assert len(ranges) == 4
        assert all(e.cpu_parent.name == P + "vision.proposal" for e in ranges)
    under = {p: {e.name for e in events if P + p in _ancestors(e)} for p in PROPOSAL_PARTS}
    assert "aten::index_select" in under["vision.proposal_encoding"]  # the grid's gathers
    assert {"aten::relu", "aten::exp"} <= under["vision.proposal_mlp"]
    assert not under["vision.proposal_encoding"] & {"aten::relu", "aten::exp"}
    events, recs = _profiled(lambda: vision_pipe.render_image(_cams(), 0, H, W))
    assert not {r["name"] for r in recs} & set(PROPOSAL_PARTS)
    assert not any(e.name in {P + p for p in PROPOSAL_PARTS} for e in events)


def test_proposal_points_counter(nerfacto_pipe):
    """image.proposal_points: rays x (n0 + n1) a chunk."""
    n0, n1 = nerfacto_pipe.config.vision_model.num_proposal_samples
    profiling.reset_counters()
    nerfacto_pipe.render_image(_cams(), 0, 4, 4)  # one chunk of 16 rays
    assert profiling.counters()["image.proposal_points"] == 16 * (n0 + n1)
    nerfacto_pipe.render_image(_cams(), 0, H, W)
    assert profiling.counters()["image.proposal_points"] == (16 + H * W) * (n0 + n1)
    profiling.reset_counters()


def test_train_step_spans():
    rng = np.random.default_rng(3)
    cams = vision_data.camera_arrays(vision_data.synthetic_cameras(8, H, W), "cpu")
    images = {"images": torch.from_numpy(rng.uniform(0, 1, (8, H, W, 3)).astype(np.float32))}
    split = loader.audio_arrays(
        {"mic_pose": rng.normal(size=(3, 3)), "source_pose": rng.normal(size=(3, 3)),
         "rot": rng.uniform(size=(3, 3)), "log_stft": rng.normal(-3, 1, (3, 2, 257, 12))},
        "cpu")
    pipe = factory.build_joint_pipeline(grid_res=8, tiny=True, device="cpu",
                                        mixed_precision=False, seed=4)
    pipe.step = 2  # past start_step_audio: the audio branch is live
    events, recs = _profiled(lambda: pipe.train_step(cams, split, images))
    parents = {**{s: "train.step" for s in TRAIN_STAGES},
               **{s: "train.vision_forward" for s in IMAGE_STAGES if s.startswith("vision.")}}
    _check_stages(events, "train.step", TRAIN_STAGES, parents)
    req, mine = _one_request(recs, "train.step")
    assert {r["name"] for r in mine if r["parent"] == req["id"]} == set(TRAIN_STAGES)


def test_spans_cost_nothing_while_nothing_records(rir_pipe):
    assert profiling.span("a") is profiling.span("b") is profiling.request("c")
    n = len(profiling.spans())
    rir_pipe.render_waveforms(*_poses())
    assert len(profiling.spans()) == n
    with profiling.recording():
        assert profiling.span("a") is not profiling.span("a")
        rir_pipe.render_waveforms(*_poses())
    recs = profiling.spans()[n:]
    assert sorted(r["name"] for r in recs) == sorted(("rir.request", *RIR_STAGES))
    assert all("device_ms" not in r for r in recs)  # no card: host ms alone


def test_store_keeps_the_newest():
    profiling.clear()
    with profiling.recording():
        for i in range(profiling.STORE_SIZE + 5):
            with profiling.span("s"):
                pass
    recs = profiling.spans()
    assert len(recs) == profiling.STORE_SIZE
    assert recs[-1]["id"] - recs[0]["id"] == profiling.STORE_SIZE - 1
    profiling.clear()
    assert profiling.spans() == []


def test_serving_counters(rir_pipe, vision_pipe):
    profiling.reset_counters()
    rir_pipe.render_waveforms(*_poses(n=3))
    vision_pipe.render_image(_cams(), 0, H, W)
    T = rir_pipe.audio_model.config.max_len
    n0, n1 = vision_pipe.config.vision_model.num_proposal_samples
    assert profiling.counters() == {
        "rir.requests": 1, "rir.grid_features": 1, "rir.rirs": 3, "rir.frames": 3 * T,
        "image.requests": 1, "image.rays": H * W, "image.chunks": 2,
        "image.proposal_points": H * W * (n0 + n1)}
    profiling.reset_counters()
    assert profiling.counters() == {}


def _record(work, under_ms=None, units=4):
    trace = None if under_ms is None else Trace(
        window_s=0.1, units=units, kernels=[("k", 0.0, 1.0)], under_ms=under_ms)
    return Record(seconds=1.0, units=units, latencies_s=[0.1] * units, setup_s=1.0,
                  work=work, trace=trace)


RIR, IMAGE = {"rirs": 512, "flops": 1.0}, {"pixels": 64, "flops": 1.0}


@pytest.mark.parametrize("metric,work,span", [
    ("field_ms.rir", RIR, "rir.field"),
    ("grid_feature_ms.rir", RIR, "rir.grid_feature"),
    ("gl_ms.rir", RIR, "rir.griffin_lim"),
    ("sampler_ms.image", IMAGE, "vision.sampler"),
    ("proposal_ms.image", IMAGE, "vision.proposal"),
    ("field_ms.image", IMAGE, "vision.field"),
    ("render_ms.image", IMAGE, "vision.render"),
    ("proposal_encoding_ms.image", IMAGE, "vision.proposal_encoding"),
    ("proposal_mlp_ms.image", IMAGE, "vision.proposal_mlp"),
])
def test_span_readers(metric, work, span):
    read = bench.metric_reader(metric).read
    assert read(_record(work, {"neraf." + span: 10.0, "aten::mm": 3.0})) == 2.5
    assert read(_record(work, {"aten::mm": 3.0})) is None
    assert read(_record(work)) is None
    other = IMAGE if work is RIR else RIR
    assert read(_record(other, {"neraf." + span: 10.0})) is None


@pytest.mark.parametrize("metric,work,span", [
    ("host_ms.rir", RIR, "rir.request"), ("host_ms.image", IMAGE, "image.request")])
def test_host_ms_reader(metric, work, span):
    read = bench.metric_reader(metric).read
    profiling.clear()
    assert read(_record(work, {}, units=2)) is None
    with profiling.recording():
        for _ in range(3):
            with profiling.request(span):
                pass
    got = read(_record(work, {}, units=2))
    want = np.mean([r["host_ms"] for r in profiling.spans()][-2:])
    assert got == pytest.approx(want)
    assert read(_record(work)) is None


def test_proposal_hash_roofline_reader():
    """% of proposal_hash_bound_ms, held to the points the program counted
    an image (image.proposal_points / image.requests against the unit's
    proposal_points), in the device ms an image under
    vision.proposal_encoding; None without the bound (a fourier
    configuration), the span or the counters (a program without hash
    proposals)."""
    read = bench.metric_reader("proposal_hash_roofline.image").read
    work = {**IMAGE, "proposal_hash_bound_ms": 0.5, "proposal_points": 100}
    span = {"neraf.vision.proposal_encoding": 8.0}  # 2 ms an image
    profiling.reset_counters()
    assert read(_record(work, span)) is None
    profiling.count("image.requests", 3)
    profiling.count("image.proposal_points", 300)
    assert read(_record(work, span)) == 25.0
    profiling.count("image.proposal_points", 300)  # twice the points an image
    assert read(_record(work, span)) == 50.0
    assert read(_record(IMAGE, span)) is None
    assert read(_record(work, {"aten::mm": 3.0})) is None
    assert read(_record(work)) is None
    profiling.reset_counters()


def test_resnet_runs_reader():
    read = bench.metric_reader("resnet_runs.rir").read
    profiling.reset_counters()
    assert read(_record(RIR)) is None
    profiling.count("rir.requests", 4)
    profiling.count("rir.grid_features", 4)
    assert read(_record(RIR)) == 1.0
    assert read(_record(IMAGE)) is None
    profiling.reset_counters()
