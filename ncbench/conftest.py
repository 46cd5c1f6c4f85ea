"""Fixtures of the benchmark's CPU tests: a test-sized cell of the
manifest's own configurations (one mixed block, a 47 px image, a quarter of
the widths, 10 classes, batches of 2)."""
import copy
import json
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = dict(img=47, classes=10, width_div=4, mixed=["Mixed_5b"])


@pytest.fixture
def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def tiny_cell(manifest):
    """``tiny_cell(name)``: the manifest's cell ``name`` at test size."""
    from ncbench import harness

    def make(name):
        cell = harness.Cell.find(copy.deepcopy(manifest), name, ROOT)
        cell.config.update(TINY)
        cell.traffic = dict(cell.traffic, batch=2)
        return cell
    return make
