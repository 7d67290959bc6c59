"""The benchmark's data against its rules, found by name, on the CPU:
BENCHMARK.json's keys, names, units and bounds; every configuration,
traffic mix, limit file and metric reader that a cell names; and the
imports of every harness module (neither JAX nor the JAX package; the
reference nothing of the program either)."""

import ast
import json
import math
import re
from pathlib import Path

import pytest

from portbench.core import spec as bench

ROOT = Path(__file__).resolve().parents[1]
B = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in B["workloads"]]
METRICS = [m["name"] for m in B["end_to_end"] + B["per_layer"]]


def _line(s) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert B["command"] == ["python3", "portbench/run.py"]
    assert 1 <= len(B["paths"]) <= 16 and B["paths"] == ["portbench"]
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs():
    assert 1 <= len(B["configs"]) <= 24
    files = set()
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("portbench/") and c["file"] not in files
        files.add(c["file"])
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert any(w["config"] == c["name"] for w in B["workloads"])


def test_workloads():
    assert 1 <= len(B["workloads"]) <= 24
    pairs = set()
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] == 1
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert len(set(CELLS)) == len(CELLS)


def test_metrics():
    assert len(set(METRICS)) == len(METRICS)
    e2e = {m["name"]: m for m in B["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and "setup_s" in e2e
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            moved = e2e[m["moves"]]
            assert cell in moved.get("workloads", CELLS), (m["name"], cell)
    for m in B["end_to_end"] + B["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert all(c in CELLS for c in m.get("workloads", []))
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_enough():
    for cell in CELLS:
        e2e = [m["name"] for m in B["end_to_end"] if bench.applies(m, cell)]
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        assert any(bench.applies(m, cell) for m in B["per_layer"]), cell


def test_check_fits_the_day():
    """2 + 14 n runs of run_seconds + 60 s, 180 s a cell, 1,200 s spare,
    with the full 24 cells."""
    runs = 2 + 14 * 24
    assert runs * (B["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    c = bench.resolve(cell)
    assert callable(bench.kind(c.traffic["kind"]).drive)
    assert c.limits and all(math.isfinite(v) and v > 0 for v in c.limits.values())
    assert c.config["model"]["mixed_precision"] is True


@pytest.mark.parametrize("name", METRICS)
def test_metric_reader_resolves(name):
    m = {x["name"]: x for x in B["end_to_end"] + B["per_layer"]}[name]
    reader = bench.metric_reader(name)
    assert reader.SOURCE == m["source"] and callable(reader.read)


def test_metric_of_a_part_reads_with_its_quantity():
    """idle_share.<part> has no file of its own: idle_share.py reads it."""
    assert not (ROOT / "portbench" / "metrics" / "idle_share.rir.py").exists()
    assert bench.metric_reader("idle_share.rir").read.__module__ == "portbench_metric_idle_share.rir"
    assert bench.metric_reader("idle_share.rir").__file__.endswith("idle_share.py")


@pytest.mark.parametrize("cell", CELLS)
def test_program_is_built_from_the_file(cell):
    """Every number of the configuration's model reaches the port's
    ExperimentConfig; another number in the file makes another program."""
    import copy

    from portbench.core.program import experiment_config

    spec = bench.resolve(cell).config["model"]
    cfg = experiment_config(spec)
    v, a, vm, am = spec["vision"], spec["audio"], cfg.vision_model, cfg.audio_model
    assert (vm.encoding, vm.num_frequencies, vm.base_mlp_width, vm.base_mlp_layers) == (
        v["encoding"], v["num_frequencies"], v["base_mlp_width"], v["base_mlp_layers"])
    assert (vm.num_levels, vm.features_per_level, vm.hidden_dim) == (
        v["hash"]["num_levels"], v["hash"]["features_per_level"], v["hash"]["hidden_dim"])
    assert list(vm.num_proposal_samples) == v["num_proposal_samples"]
    assert (am.max_len, am.n_freq_stft, am.mic_ch, am.w_field, am.resnet_backbone, am.n_fft) == (
        a["max_len"], a["n_freq_stft"], a["mic_ch"], a["w_field"], a["resnet"], a["n_fft"])
    assert cfg.trainer.mixed_precision is spec["mixed_precision"]
    assert cfg.audio_data.batch_size == spec["trainer"]["audio_batch_size"]
    assert cfg.optimizers.audio_fields.lr == spec["optimizers"]["audio_fields"]["lr"]
    other = copy.deepcopy(spec)
    other["vision"]["hash"]["num_levels"] = 16
    other["vision"]["hash"]["features_per_level"] = 2
    other["audio"]["max_len"] = 60
    cfg2 = experiment_config(other)
    assert (cfg2.vision_model.num_levels, cfg2.vision_model.features_per_level,
            cfg2.audio_model.max_len) == (16, 2, 60)


def test_unknown_cell_refused():
    with pytest.raises(KeyError):
        bench.resolve("no_such.cell")


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


HARNESS = sorted((ROOT / "portbench").rglob("*.py"))


@pytest.mark.parametrize("path", HARNESS, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_in_the_harness(path):
    """Whole top-level names: neraf_tpu_torch is not neraf_tpu."""
    found = _imports(path)
    assert not found & {"jax", "jaxlib", "flax", "neraf_tpu"}, found
    if "reference" in path.parts:
        assert not any(n.startswith("neraf") for n in found), found


def test_top_level_name_compare_is_whole():
    from portbench.core.main import FORBIDDEN

    assert "neraf_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "neraf_tpu.models".split(".")[0] in FORBIDDEN
