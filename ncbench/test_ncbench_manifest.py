"""The manifest and the harness's sources, without running a cell."""
import ast
import importlib
import json
import pathlib
import re

import pytest

from ncbench import harness

ROOT = pathlib.Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    p.relative_to(ROOT).as_posix()
    for p in (ROOT / "ncbench").rglob("*.py")))
def test_no_module_imports_jax_or_the_jax_package(path):
    """Top-level names compared whole: ``repro_torch`` is allowed, ``repro``
    is not."""
    found = {name.split(".")[0] for name in _imports(ROOT / path)}
    assert not found & set(harness.FORBIDDEN), (path, found)


def test_forbidden_modules_compares_whole_names():
    clean = ["repro_torch", "repro_torch.core", "ncbench", "jaxtyping_x"]
    assert harness.forbidden_modules(clean) == []
    assert harness.forbidden_modules(clean + ["repro.core", "jax._src"]) == \
        ["jax", "repro"]


def test_manifest_keys_names_and_units(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert manifest["paths"] == ["ncbench"]
    assert 1 <= manifest["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in manifest[k]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES, m
    for m in manifest["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in manifest["end_to_end"]}
    cells = {w["name"] for w in manifest["workloads"]}
    for m in manifest["per_layer"]:  # each names the cells that read it
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}, m
        assert m["workloads"] and set(m["workloads"]) <= cells, m
    assert len((ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024


def test_every_cell_finds_its_files(manifest):
    for wl in manifest["workloads"]:
        cell = harness.Cell.find(manifest, wl["name"], ROOT)
        assert wl["chips"] == 1 and len(wl["why"]) <= 200
        cfg = cell.config
        importlib.import_module(f"ncbench.builders.{cfg['builder']}")
        importlib.import_module(f"ncbench.references.{cfg['reference']}")
        assert int(cell.traffic["batch"]) >= 1
        assert set(cfg["check"]["limits"]) == {"logit_gap",
                                               "failed_requests"}
        reported = {m["name"] for m in cell.end_to_end()}
        assert "setup_s" in reported and len(reported) >= 2
        layer = cell.per_layer()
        assert layer, wl["name"]
        for m in layer:
            assert m["moves"] in reported, m
            assert (ROOT / "ncbench" / "metrics" / f"{m['name']}.py").is_file()


def test_config_files_belong_to_one_configuration(manifest):
    files = [c["file"] for c in manifest["configs"]]
    assert len(files) == len(set(files))
    for c in manifest["configs"]:
        assert c["file"].startswith("ncbench/configs/")
        json.loads((ROOT / c["file"]).read_text())
        assert set(c) == {"name", "source", "file", "reduced", "why"}


def test_metric_readers_return_nothing_without_a_reading(manifest):
    ctx = dict(config=json.loads(
        (ROOT / manifest["configs"][0]["file"]).read_text()),
        traffic={"batch": 2}, images=0, batches=0, window_s=0.0, spans={},
        kernel_s={}, busy_s=0.0)
    for m in manifest["per_layer"]:
        assert harness.read_metric(m["name"], ctx) is None, m["name"]
