"""The port's public surface against the reference's, and its imports.

For every module of ``src/repro/`` the port's counterpart (the same path
under ``src/repro_torch/``) must exist and export every name the
reference's ``__all__`` lists (a module without ``__all__``: every public
function, class and constant it defines, and for a config module what it
re-exports from the package), except the allow-listed JAX or
TPU machinery below, each with the reason it has no counterpart.  A later
gap between the packages fails here.  The same holds for the repository's
paper evaluation: every module of ``benchmarks/`` but the timing harness
(``kernel_bench``, ``run``) against ``repro_torch.benchmarks``, and
``examples/paper_repro.py`` against ``repro_torch.examples.paper_repro``.
No file of ``src/repro_torch/`` and not ``chip_smoke.py`` may import
``jax``, the reference package or the repository's ``benchmarks`` and
``examples`` (which import JAX).
"""
import ast
import importlib
import importlib.util
import sys
import pathlib
import types

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

# whole modules with no counterpart
NO_MODULE = {
    "repro.distributed.hlo_analysis":
        "reads XLA's HLO text; repro_torch.distributed.trace_analysis "
        "counts FLOPs and collective bytes from a torch dispatch trace",
    "repro.distributed.hlo_loop_analysis":
        "the same for HLO while loops; trace_analysis replaces it",
    "repro.kernels.ref":
        "the Pallas kernels' oracles: each plain version sits beside its "
        "kernel (bitserial_matmul_plain, bitserial_matmul_a4_plain, "
        "quant_matmul_plain, flash_attention_plain, pack_activation_nibbles)",
}

# names with no counterpart, by module
NO_NAME = {
    "repro.core.bitserial": {
        "bucket_words": "pads tile word counts to the jit backend's XLA "
                        "executable buckets; gemm takes the jit backend's "
                        "role",
        "engine_cache_info": "reports that XLA executable cache",
        "engine_cache_clear": "clears that XLA executable cache",
    },
    "repro.kernels.ops": {
        "on_tpu": "switches Pallas between interpret mode and the TPU; the "
                  "port's wrappers choose by the tensor's device",
    },
    "repro.kernels.bitserial_matmul": {
        "DEFAULT_BM": "the Pallas kernel's row block; the Hopper kernels "
                      "tile TILE_M x TILE_N x TILE_K",
    },
    "repro.kernels.quant_matmul": {
        "DEFAULT_BM": "Pallas block sizes; see TILE_M/TILE_N/TILE_K",
        "DEFAULT_BN": "Pallas block sizes; see TILE_M/TILE_N/TILE_K",
        "DEFAULT_BK": "Pallas block sizes; see TILE_M/TILE_N/TILE_K",
    },
    "repro.distributed.roofline": {
        "TPU_V5E": "the TPU's roofline; H100_SXM is the card's",
    },
    "repro.distributed.sharding": {
        "current_abstract_mesh": "a JAX version shim",
    },
    "repro.launch.mesh": {
        "make_mesh_compat": "a JAX version shim",
        "set_mesh_compat": "a JAX version shim",
    },
    "repro.launch.steps": {
        "build_jitted_step": "builds a jax.jit step; its counterpart is "
                             "build_sharded_step",
    },
}


# the repository's benchmark modules with no counterpart: the timing
# harness, which the benchmark of the port will replace
NO_BENCHMARK = ("kernel_bench", "run")

# names with no counterpart, by benchmark module
NO_BENCHMARK_NAME = {
    "sched_breakdown": {
        "load_bench_baseline": "reads the JAX package's CPU timings from "
                               "BENCH_kernels.json; the port measures its "
                               "inputs on the device (measure_calibration, "
                               "measure_overlap)",
        "BenchBaselineError": "that file's missing or stale schema",
        "REQUIRED_OPS": "the records that file must hold",
        "OVERLAP_OPS": "the names of that file's serial/overlapped pair; "
                       "the port measures the pair (measure_overlap)",
    },
    "traffic_replay": {
        "RECORDS": "the timing harness's record sink (benchmarks/run.py, "
                   "not ported)",
        "RETIMERS": "the timing harness's re-measure hooks",
    },
}


def _module_names():
    out = []
    for f in sorted(REF.rglob("*.py")):
        parts = list(f.relative_to(REF.parent).with_suffix("").parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def _public(mod) -> list[str]:
    """``__all__``, else what the module defines; a config module (the
    registry's) also what it re-exports from the package, as
    ``configs.inception_v3`` re-exports ``inception_v3_specs``."""
    names = getattr(mod, "__all__", None)
    if names is not None:
        return list(names)
    reexports = mod.__name__.startswith("repro.configs")

    def owned(v):
        home = getattr(v, "__module__", None) or mod.__name__
        return home == mod.__name__ or (reexports
                                        and home.split(".")[0] == "repro")

    return sorted(k for k, v in vars(mod).items()
                  if not k.startswith("_")
                  and not isinstance(v, types.ModuleType) and owned(v))


@pytest.mark.parametrize("name", _module_names())
def test_port_covers_reference_surface(name):
    port_name = "repro_torch" + name[len("repro"):]
    if name in NO_MODULE:
        path = PORT.joinpath(*port_name.split(".")[1:])
        assert not path.with_suffix(".py").exists(), (
            f"{port_name} exists: take it off the allow-list")
        return
    ref = importlib.import_module(name)
    port = importlib.import_module(port_name)
    allowed = NO_NAME.get(name, {})
    missing = [k for k in _public(ref) if k not in allowed
               and not hasattr(port, k)]
    assert not missing, f"{port_name} lacks {missing}"
    if hasattr(ref, "__all__") and hasattr(port, "__all__"):
        unlisted = [k for k in ref.__all__ if k not in allowed
                    and k not in port.__all__]
        assert not unlisted, f"{port_name}.__all__ lacks {unlisted}"
    stale = [k for k in allowed if hasattr(port, k)]
    assert not stale, f"{port_name} has {stale}: take them off the allow-list"


def test_allow_list_names_reference_modules():
    names = set(_module_names())
    assert set(NO_MODULE) <= names and set(NO_NAME) <= names
    for name, allowed in NO_NAME.items():
        ref = importlib.import_module(name)
        assert all(hasattr(ref, k) for k in allowed), name


def _benchmark_names():
    return sorted(f.stem for f in (ROOT / "benchmarks").glob("*.py")
                  if f.stem != "__init__" and f.stem not in NO_BENCHMARK)


def _reference_benchmark(name: str):
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    return importlib.import_module(f"benchmarks.{name}")


@pytest.mark.parametrize("name", _benchmark_names() + ["paper_repro"])
def test_port_covers_paper_evaluation_surface(name):
    if name == "paper_repro":
        spec = importlib.util.spec_from_file_location(
            "reference_example_paper_repro",
            ROOT / "examples" / "paper_repro.py")
        ref = importlib.util.module_from_spec(spec)
        _reference_benchmark("common")  # puts the root on the path
        spec.loader.exec_module(ref)
        port = importlib.import_module("repro_torch.examples.paper_repro")
    else:
        ref = _reference_benchmark(name)
        port = importlib.import_module(f"repro_torch.benchmarks.{name}")
    allowed = NO_BENCHMARK_NAME.get(name, {})
    assert all(hasattr(ref, k) for k in allowed), name
    missing = [k for k in _public(ref) if k not in allowed
               and not hasattr(port, k)]
    assert not missing, f"{port.__name__} lacks {missing}"
    stale = [k for k in allowed if hasattr(port, k)]
    assert not stale, f"{port.__name__} has {stale}: take them off the list"


def test_benchmark_allow_list_names_ported_modules():
    assert set(NO_BENCHMARK_NAME) <= set(_benchmark_names())
    for name in NO_BENCHMARK:
        assert (ROOT / "benchmarks" / f"{name}.py").exists()
        assert not (PORT / "benchmarks" / f"{name}.py").exists()


def _imports(path: pathlib.Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append(node.module or "")
    return out


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "flax", "optax",
                                  "benchmarks", "examples")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
