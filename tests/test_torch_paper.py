"""The port's paper evaluation (``repro_torch.benchmarks`` figure and
table modules, ``lm_neural_cache`` and ``repro_torch.examples.paper_repro``)
against the reference's ``benchmarks/`` and ``examples/paper_repro.py``,
on the CPU.

Every row is host arithmetic of the simulator on the same inputs, so the
rows must be equal as text; the example's 65 lines byte-identical, in
process and through both command lines.  ``common``'s helpers: the cached
simulations, the row format, the overlap slack by core count, and a
``timed`` that waits for the card before each clock read when CUDA is in
use.
"""
import importlib
import importlib.util
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import common as rcommon  # noqa: E402
from repro_torch.benchmarks import common as tcommon  # noqa: E402
from repro_torch.examples import paper_repro as tpaper  # noqa: E402

torch.set_num_threads(1)

MODULES = ["fig13_latency_by_layer", "fig14_breakdown", "fig15_total_latency",
           "fig16_throughput_batch", "tab3_energy", "tab4_cache_scaling",
           "lm_neural_cache"]


def _pair(name):
    return (importlib.import_module(f"benchmarks.{name}"),
            importlib.import_module(f"repro_torch.benchmarks.{name}"))


@pytest.mark.parametrize("name", MODULES)
def test_module_rows_equal_reference(name):
    ref, port = _pair(name)
    rows = port.run()
    assert rows and rows == ref.run()


@pytest.mark.parametrize("mb", [35, 45, 60])
def test_sim_equals_reference(mb):
    r, t = rcommon.sim(mb), tcommon.sim(mb)
    assert t.latency_s == r.latency_s and t.energy_j == r.energy_j
    assert t.power_w == r.power_w and t.breakdown() == r.breakdown()
    assert [l.total_s for l in t.layers] == [l.total_s for l in r.layers]
    assert tcommon.sim(mb) is t  # cached


@pytest.mark.parametrize("value", [0.0, 4722.89201, 1e-7, 123456789.98765])
def test_row_format_equals_reference(value):
    assert tcommon.row("a/b", value, "x y") == rcommon.row("a/b", value, "x y")
    assert tcommon.row("a/b", value) == rcommon.row("a/b", value)


@pytest.mark.parametrize("cores", [None, 1, 2, 8])
def test_overlap_wall_slack_equals_reference(monkeypatch, cores):
    monkeypatch.setattr(os, "cpu_count", lambda: cores)
    assert tcommon.overlap_wall_slack() == rcommon.overlap_wall_slack()


def test_lm_fc_gemm_equals_reference():
    ref, port = _pair("lm_neural_cache")
    for n in (1, 10 ** 6, 7_615_616_000):
        for bits in (8, 4):
            assert (port.simulate_fc_gemm(n, bits=bits).__dict__
                    == ref.simulate_fc_gemm(n, bits=bits).__dict__)


def test_timed_takes_the_min_and_syncs_when_cuda_is_in_use(monkeypatch):
    ticks = iter([0.0, 5.0, 10.0, 12.0, 20.0, 23.0])
    monkeypatch.setattr(tcommon.time, "perf_counter", lambda: next(ticks))
    calls = []
    out, us = tcommon.timed(lambda a, k=0: calls.append((a, k)) or a + k,
                            1, k=2)
    assert out == 3 and us == 2.0 * 1e6 and len(calls) == 4
    syncs = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: syncs.append(None))
    ticks = iter([0.0, 1.0, 2.0, 4.0])
    monkeypatch.setattr(tcommon.time, "perf_counter", lambda: next(ticks))
    _, us = tcommon.timed(lambda: None, iters=2)
    assert us == 1.0 * 1e6 and len(syncs) == 4  # one before each read


def _reference_example():
    """``examples/paper_repro.py``, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "reference_example_paper_repro", ROOT / "examples" / "paper_repro.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_paper_lines_equal_reference_example(capsys):
    ref = _reference_example()
    assert [(t, m.__name__.rsplit(".", 1)[-1]) for t, m in tpaper.MODULES] \
        == [(t, m.__name__.rsplit(".", 1)[-1]) for t, m in ref.MODULES]
    want = []
    for title, m in ref.MODULES:
        want += ["", f"=== {title} ==="] + [f"  {line}" for line in m.run()]
    lines = tpaper.paper_lines()
    assert len(lines) == 65 and lines == want
    assert tpaper.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out == "\n".join(lines) + "\n"


def test_paper_repro_command_lines_byte_identical(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    port = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.paper_repro",
         "--device", "cpu"], cwd=tmp_path, capture_output=True,
        env=dict(env, PYTHONPATH=str(ROOT / "src")), timeout=300)
    ref = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "paper_repro.py")],
        cwd=tmp_path, capture_output=True, timeout=300,
        env=dict(env, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}"))
    assert port.returncode == 0 and ref.returncode == 0, (
        port.stderr[-2000:] + ref.stderr[-2000:])
    assert port.stdout == ref.stdout
    assert port.stdout.count(b"\n") == 65
