"""Whole runs of every cell at the tiny CPU sizes (portbench/tiny.py),
without the look for a card: a sound run of the port in float32 agrees
with the reference and prints the benchmark's result line; the control
(the reference in float8 in the program's place) and each fault planted
under the timed path come out not correct under the cell's own limits.
The card-sized control is the `cuda` case at the end."""

import io
import json

import pytest
import torch

from portbench.core import spec as bench
from portbench.core.main import execute
from portbench.tiny import result_of, tiny_run

CELLS = ["ss_fourier.rir512", "ss_hash.image512", "ss_fourier.image512"]


def _run(cell, **kw):
    run, c = tiny_run(cell, **kw)
    out, err = io.StringIO(), io.StringIO()
    assert execute(run, c, out, err) == 0, err.getvalue()
    return result_of(out.getvalue()), err.getvalue()


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_agrees_with_the_reference(cell):
    res, err = _run(cell)
    assert res["correct"] is True, err
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0
    assert "setup_s" in res["metrics"] and len(res["metrics"]) >= 2
    for name, c in res["checks"].items():
        assert c["value"] <= 0.05 * c["limit"], (name, c)
    tail = err.strip().splitlines()[-len(res["checks"]):]
    assert all(line.startswith("check ") for line in tail)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_per_layer_metrics(cell):
    res, _ = _run(cell, trace=True)
    assert res["correct"] is True
    assert "busy_s" in res["device"] and res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert any(k.startswith("mfu.") for k in res["metrics"])
    assert "setup_s" not in res["metrics"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    run, _ = tiny_run(cell, control="fp8")
    assert bench.kind(run.traffic["kind"]).drive(run).correct is False


def _half_batch_rir(monkeypatch):
    from neraf_tpu_torch.engine.pipeline import RenderPipeline

    render = RenderPipeline.render_waveforms

    def half(self, mic, src, rot, generator=None):
        n = mic.shape[0] // 2
        out = render(self, mic[:n], src[:n], rot[:n], generator=generator)
        rest = out.mean(dim=0, keepdim=True).expand(mic.shape[0] - n, *out.shape[1:])
        return torch.cat([out, rest])

    monkeypatch.setattr(RenderPipeline, "render_waveforms", half)


def _altered_rir(monkeypatch):
    from neraf_tpu_torch.engine.pipeline import RenderPipeline

    render = RenderPipeline.render_waveforms

    def altered(self, *a, **kw):
        out = render(self, *a, **kw).clone()
        out[0] = 0.0
        return out

    monkeypatch.setattr(RenderPipeline, "render_waveforms", altered)


def _half_batch_image(monkeypatch):
    from neraf_tpu_torch.engine.pipeline import VisionPipeline

    render = VisionPipeline.render_image

    def half(self, *a, **kw):
        out = {k: v.clone() for k, v in render(self, *a, **kw).items()}
        h = out["rgb"].shape[0] // 2
        for k in out:
            out[k][h:] = out[k][:h].mean(dim=(0, 1))
        return out

    monkeypatch.setattr(VisionPipeline, "render_image", half)


def _altered_image(monkeypatch):
    from neraf_tpu_torch.engine.pipeline import VisionPipeline

    render = VisionPipeline.render_image

    def altered(self, *a, **kw):
        out = {k: v.clone() for k, v in render(self, *a, **kw).items()}
        out["depth"] *= 1.02
        return out

    monkeypatch.setattr(VisionPipeline, "render_image", altered)


def _altered_colour(monkeypatch):
    from neraf_tpu_torch.engine.pipeline import VisionPipeline

    render = VisionPipeline.render_image

    def altered(self, *a, **kw):
        out = {k: v.clone() for k, v in render(self, *a, **kw).items()}
        out["rgb"] = out["rgb"].flip(-1)
        return out

    monkeypatch.setattr(VisionPipeline, "render_image", altered)


FAULTS = [("ss_fourier.rir512", _half_batch_rir), ("ss_fourier.rir512", _altered_rir),
          ("ss_hash.image512", _half_batch_image), ("ss_hash.image512", _altered_image),
          ("ss_hash.image512", _altered_colour),
          ("ss_fourier.image512", _half_batch_image), ("ss_fourier.image512", _altered_image),
          ("ss_fourier.image512", _altered_colour)]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=lambda x: getattr(x, "__name__", x))
def test_fault_under_the_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    res, err = _run(cell)
    assert res["correct"] is False, err


def test_same_seed_same_inputs():
    from portbench.core import inputs
    from portbench.reference import neraf as ref

    run, _ = tiny_run("ss_fourier.rir512")
    shapes = ref.param_shapes(run.spec, ("vision", "resnet", "field"))
    a = inputs.make_weights(shapes, 2**31 + 7, torch.device("cpu"))
    b = inputs.make_weights(shapes, 2**31 + 7, torch.device("cpu"))
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = inputs.make_weights(shapes, 2**31 + 8, torch.device("cpu"))
    assert not torch.equal(a["resnet.conv1.weight"], c["resnet.conv1.weight"])


@pytest.mark.cuda
def test_control_fails_on_the_card_at_full_size():
    """The rir512 control at the cell's own size, one seed (the chip's
    readings over three seeds are in PERF.md)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell runs at full size on the card")
    from portbench.core.common import Run

    cell = bench.resolve("ss_fourier.rir512")
    run = Run(cell=cell.name, spec=cell.config["model"], traffic=cell.traffic,
              limits=cell.limits, seed=2**31 + 11, seconds=1.0, trace=False,
              device=torch.device("cuda", 0), started=0.0, control="fp8")
    out = bench.kind("rir").drive(run)
    assert out.correct is False, json.dumps(out.readings)
