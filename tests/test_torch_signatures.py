"""The port's public surface below module level, against the reference's.

``test_torch_surface.py`` holds the names each module exports; this file
holds what those names carry.  The modules of both packages are listed by
file path (``src/repro/models/`` and ``src/repro/launch/`` have no
``__init__.py``, so ``pkgutil`` would skip them).  For every public class
of a reference module whose counterpart exists in the port:

* every public member (method, property, attribute of the class) must
  exist on the port's class, and every dataclass or NamedTuple field with
  the same default;
* every public method present on both takes every parameter the
  reference's takes, with the same default where the reference has one.

Every public function is held to the same rule.  The port may add
parameters (``device=``, ``generator=``) and may give a default where the
reference has none: every call the reference accepts binds on the port.
What the port may lack or change is listed below, each entry with its
reason; a stale entry (the reference no longer has it, or the port now
matches) fails.  Names the port lacks altogether are
``test_torch_surface.py``'s to report.
"""
import dataclasses
import importlib
import inspect
import pathlib
import types

import numpy as np
import pytest
import torch

from repro_torch.distributed.roofline import H100_SXM

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"

# ---------------------------------------------------------------------------
# The allow-list.
# ---------------------------------------------------------------------------
# a reference parameter the port takes under another name, anywhere
RENAMED = {
    "key": ("generator", "a JAX PRNG key; the port's inits draw from an "
                         "explicit torch.Generator (dense_init ... init_lm, "
                         "stub_*, inception.init_params)"),
}
# reference parameters with no counterpart, anywhere in a module prefix
NO_PARAM_IN = {
    "repro.kernels": {
        "bm": "a Pallas block size; the Hopper kernels tile TILE_M x "
              "TILE_N x TILE_K",
        "bn": "a Pallas block size (plane_block_mask's too: the port's "
              "block_n sets the mask granularity)",
        "bk": "a Pallas block size (plane_block_mask's too: the port's "
              "block_k sets the mask granularity)",
        "bk2": "the W4A4 Pallas kernel's packed K block",
        "bq": "the Pallas flash kernel's query block; the CUDA kernel "
              "picks its tiles by dtype (kernel_tiles)",
        "interpret": "switches Pallas between interpret mode and the TPU; "
                     "the port's wrappers choose by the tensor's device",
        "prefer_pallas": "picks the Pallas kernel over XLA's fused "
                         "version; the port's wrappers always run the "
                         "kernel on a CUDA tensor",
    },
    "repro.quant.ptq": {
        "prefer_pallas": "as in repro.kernels.ops: the port always runs "
                         "the kernel on a CUDA tensor",
    },
}
# one function's parameter with no counterpart
NO_PARAM = {
    ("repro.launch.dryrun", "run_cell", "xla_flags_extra"):
        "extra XLA flags for the compile; the port dispatches on meta "
        "tensors and compiles nothing",
    ("repro.core.bitserial", "packed_dot_words", "materialize"):
        "defers the jit backend's device-to-host copy; the port returns a "
        "tensor on the operands' device, never copied",
    ("repro.models.layers", "norm_init", "key"):
        "unused there: norms start at ones and zeros and draw nothing, so "
        "the port's takes no generator",
}
# one function's parameter whose default differs, with the port's value
OTHER_DEFAULT = {
    ("repro.core.bitserial", "packed_dot_words", "engine"):
        ("'walk'", "the exact walk is the reference's 'host' body under "
                   "the port's name"),
    ("repro.distributed.roofline", "roofline", "hw"):
        (repr(H100_SXM), "the reference prices a TPU v5e by default; the "
                     "port's default is the card it runs on"),
}
# class members (fields, methods, properties) with no counterpart
NO_MEMBER = {
    ("repro.core.backends", "Backend", "max_lane_words"):
        "caps one operand before the Pallas adapter delegates; the port's "
        "gemm decodes operands of any size, and its max_grid_words caps "
        "the walk's broadcast grid, which callers split into chunks: a "
        "different rule, not this one renamed",
}


def _dtype_name(v) -> str | None:
    """A dtype default by name: ``jnp.float32`` and ``torch.float32`` are
    both ``"float32"`` (the port's defaults are torch's dtypes)."""
    if isinstance(v, torch.dtype):
        return str(v).removeprefix("torch.")
    if isinstance(v, type) and hasattr(v, "dtype"):
        try:
            return np.dtype(v).name
        except TypeError:
            return None
    return None


def _default(v) -> str:
    return _dtype_name(v) or repr(v)


# ---------------------------------------------------------------------------
# The comparison.
# ---------------------------------------------------------------------------
def _module_names():
    out = []
    for f in sorted(REF.rglob("*.py")):
        parts = list(f.relative_to(REF.parent).with_suffix("").parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def _public(mod) -> list[str]:
    names = getattr(mod, "__all__", None)
    if names is not None:
        return list(names)
    return sorted(k for k, v in vars(mod).items()
                  if not k.startswith("_")
                  and not isinstance(v, types.ModuleType)
                  and (getattr(v, "__module__", None) or mod.__name__)
                  == mod.__name__)


def _signature(fn):
    if isinstance(fn, (staticmethod, classmethod)):
        fn = fn.__func__
    if not callable(fn) or isinstance(fn, type):
        return None
    try:
        return inspect.signature(fn)
    except (TypeError, ValueError):
        return None


def _param_gaps(module: str, qualname: str, ref_fn, port_fn) -> list[str]:
    """What ``port_fn`` lacks of ``ref_fn``'s parameters and defaults."""
    rs, ps = _signature(ref_fn), _signature(port_fn)
    if rs is None or ps is None:
        return []
    gaps = []
    func = qualname.split(".")[-1]
    skip = {}
    for prefix, names in NO_PARAM_IN.items():
        if module == prefix or module.startswith(prefix + "."):
            skip.update(names)
    for name, rp in rs.parameters.items():
        if name in skip or (module, func, name) in NO_PARAM:
            continue
        pname = RENAMED[name][0] if name in RENAMED else name
        pp = ps.parameters.get(pname)
        if pp is None:
            gaps.append(f"{qualname}({name}=) missing")
            continue
        if rp.default is inspect.Parameter.empty:
            continue
        want = _default(rp.default)
        if (module, func, name) in OTHER_DEFAULT:
            want = OTHER_DEFAULT[(module, func, name)][0]
        got = (_default(pp.default) if pp.default is not inspect.Parameter.empty
               else "<required>")
        if got != want:
            gaps.append(f"{qualname}({name}=) default {got}, reference "
                        f"{_default(rp.default)}")
    return gaps


def _fields(cls) -> dict[str, str] | None:
    if dataclasses.is_dataclass(cls):
        out = {}
        for f in dataclasses.fields(cls):
            if f.default is not dataclasses.MISSING:
                out[f.name] = _default(f.default)
            elif f.default_factory is not dataclasses.MISSING:
                out[f.name] = "<factory>"
            else:
                out[f.name] = "<required>"
        return out
    if issubclass(cls, tuple) and hasattr(cls, "_fields"):
        defaults = getattr(cls, "_field_defaults", {})
        return {n: _default(defaults[n]) if n in defaults else "<required>"
                for n in cls._fields}
    return None


def _class_gaps(module: str, name: str, ref_cls, port_cls) -> list[str]:
    gaps = []
    members = sorted(m for m in dir(ref_cls) if not m.startswith("_"))
    for m in members:
        if (module, name, m) in NO_MEMBER:
            continue
        if not hasattr(port_cls, m):
            gaps.append(f"{name}.{m} missing")
            continue
        gaps += _param_gaps(module, f"{name}.{m}",
                            inspect.getattr_static(ref_cls, m),
                            inspect.getattr_static(port_cls, m))
    rf = _fields(ref_cls)
    if rf is not None:
        pf = _fields(port_cls) or {}
        for f, d in rf.items():
            if (module, name, f) in NO_MEMBER:
                continue
            if f not in pf:
                gaps.append(f"{name} field {f} missing")
            elif d != "<required>" and pf[f] != d:
                gaps.append(f"{name} field {f} default {pf[f]}, reference {d}")
    # __init__ of a class that is not a dataclass: its parameters
    if rf is None and "__init__" in vars(ref_cls):
        gaps += _param_gaps(module, f"{name}.__init__", ref_cls.__init__,
                            port_cls.__init__)
    return gaps


def _gaps(module: str) -> list[str]:
    port_name = "repro_torch" + module[len("repro"):]
    try:
        port = importlib.import_module(port_name)
    except ModuleNotFoundError:
        return []  # test_torch_surface.py's NO_MODULE
    ref = importlib.import_module(module)
    gaps = []
    for name in _public(ref):
        rv, pv = getattr(ref, name, None), getattr(port, name, None)
        if rv is None or pv is None:
            continue
        if inspect.isclass(rv) and inspect.isclass(pv):
            gaps += _class_gaps(module, name, rv, pv)
        elif callable(rv) and callable(pv):
            gaps += _param_gaps(module, name, rv, pv)
    return gaps


@pytest.mark.parametrize("module", _module_names())
def test_port_members_and_parameters_cover_reference(module):
    gaps = _gaps(module)
    assert not gaps, f"{module}: " + "; ".join(gaps)


def test_allow_list_entries_still_apply():
    """Every single-function entry names a reference parameter or member
    the port still lacks or still differs in."""
    def port_of(module, qual):
        obj = importlib.import_module("repro_torch" + module[len("repro"):])
        for part in qual.split("."):
            obj = getattr(obj, part)
        return obj

    def ref_of(module, qual):
        obj = importlib.import_module(module)
        for part in qual.split("."):
            obj = getattr(obj, part)
        return obj

    for (module, func, param) in NO_PARAM:
        assert param in _signature(ref_of(module, func)).parameters
        assert param not in _signature(port_of(module, func)).parameters, (
            f"{module}.{func} takes {param}: take it off NO_PARAM")
    for (module, func, param), (want, _) in OTHER_DEFAULT.items():
        ref_p = _signature(ref_of(module, func)).parameters[param]
        port_p = _signature(port_of(module, func)).parameters[param]
        assert _default(port_p.default) == want
        assert _default(ref_p.default) != want
    for (module, cls, member) in NO_MEMBER:
        assert hasattr(ref_of(module, cls), member) or member in (
            _fields(ref_of(module, cls)) or {})
        assert not hasattr(port_of(module, cls), member), (
            f"{cls}.{member} exists in the port: take it off NO_MEMBER")


def test_dtype_defaults_compare_by_name():
    import jax.numpy as jnp

    assert _default(jnp.float32) == _default(torch.float32) == "float32"
    assert _default(jnp.bfloat16) == _default(torch.bfloat16) == "bfloat16"
    assert _default(jnp.float32) != _default(torch.bfloat16)
