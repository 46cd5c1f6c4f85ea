"""The port's per-device step analysis against the reference's HLO
analysis (``repro.distributed.hlo_analysis``, ``hlo_loop_analysis``).

* ``_wire_factor`` and ``CollectiveStats`` equal the reference's.
* Contraction FLOPs of ``tests/test_hlo_analysis.py``'s programs — a
  loop-free ``tanh(a @ b) @ b``, a stack of 12 layers, a 5 x 3 nested
  stack — equal the dot FLOPs the reference's ``analyze_hlo`` finds in the
  same JAX functions' compiled HLO (its elementwise rules switched off for
  the count), and the totals agree within the reference's own 2%.
* A matmul whose contraction dim is sharded over a 2-rank ``model`` axis
  (a fake world of 4 ranks, (2, 2) mesh) gives one all-reduce with the
  wire bytes the reference's ``collective_bytes`` reads from the HLO of
  the same shardings on 4 host devices (a subprocess: this process has one
  JAX device).
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import pytest
import torch

import repro.distributed.hlo_loop_analysis as RLA
from repro.distributed.hlo_analysis import CollectiveStats as RStats
from repro.distributed.hlo_analysis import _wire_factor as r_wire
from repro_torch.distributed import trace_analysis as TA

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("kind", ["all-gather", "all-reduce",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute"])
def test_wire_factor_and_stats_equal_reference(kind):
    for n in (0, 1, 2, 3, 16, 256):
        assert TA._wire_factor(kind, n) == r_wire(kind, n)
    rs, ts = RStats(), TA.CollectiveStats()
    for nbytes, group in ((1000, 2), (4096, 16), (77, 1), (123457, 256)):
        rs.add(kind, nbytes, group)
        ts.add(kind, nbytes, group)
    assert ts.as_dict() == rs.as_dict()
    assert ts.total_wire_bytes == rs.total_wire_bytes


def _ref(fn, *shapes):
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    text = jax.jit(fn).lower(*args).compile().as_text()
    total = RLA.analyze_hlo(text).flops
    return total, text


def _ref_dots(text, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(RLA, "_ELEMENTWISE", set())
        m.setattr(RLA, "_REDUCE_LIKE", set())
        return RLA.analyze_hlo(text).flops


def _torch(fn, *shapes):
    g = torch.Generator().manual_seed(0)
    args = [torch.randn(s, generator=g) for s in shapes]
    return TA.analyze_step(fn, *args)


def _jax_stack(L):
    def f(a, b):
        def body(c, _):
            return jnp.tanh(c @ b), None
        y, _ = jax.lax.scan(body, a, None, length=L)
        return y
    return f


def _jax_nested(a, b):
    def outer(c, _):
        def inner(d, _):
            return jnp.tanh(d @ b), None
        d, _ = jax.lax.scan(inner, c, None, length=3)
        return d, None
    y, _ = jax.lax.scan(outer, a, None, length=5)
    return y


def _torch_stack(L):
    def f(a, b):
        TA.note_loop("layers", L)
        for _ in range(L):
            a = torch.tanh(a @ b)
        return a
    return f


def _torch_nested(a, b):
    TA.note_loop("outer", 5)
    for _ in range(5):
        TA.note_loop("inner", 3)
        for _ in range(3):
            a = torch.tanh(a @ b)
    return a


@pytest.mark.parametrize("case", ["loop_free", "stack12", "nested5x3"])
def test_contraction_flops_equal_reference_dots(case, monkeypatch):
    if case == "loop_free":
        n = 256
        jf = lambda a, b: jnp.tanh(a @ b) @ b  # noqa: E731
        tf = lambda a, b: torch.tanh(a @ b) @ b  # noqa: E731
    elif case == "stack12":
        n, jf, tf = 128, _jax_stack(12), _torch_stack(12)
    else:
        n, jf, tf = 64, _jax_nested, _torch_nested
    total, text = _ref(jf, (n, n), (n, n))
    got = _torch(tf, (n, n), (n, n))
    assert got.contraction_flops == _ref_dots(text, monkeypatch)
    assert got.flops == pytest.approx(total, rel=0.02)
    if case == "stack12":
        assert got.loops == [{"while": "layers", "trips": 12, "calls": 1}]
    if case == "nested5x3":
        assert {(l["while"], l["trips"]) for l in got.loops} == {
            ("outer", 5), ("inner", 3)}


def test_bytes_and_peak_scale_with_the_stack():
    b4 = _torch(_torch_stack(4), (128, 128), (128, 128))
    b8 = _torch(_torch_stack(8), (128, 128), (128, 128))
    assert b8.bytes_accessed == pytest.approx(2 * b4.bytes_accessed,
                                              rel=0.01)
    # each layer's product and tanh are freed before the next: the peak
    # does not grow with depth
    assert b8.peak_live_bytes == b4.peak_live_bytes >= 128 * 128 * 4


_REF_SCRIPT = textwrap.dedent("""
    import os, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.distributed.hlo_analysis import collective_bytes
    from repro.launch.mesh import make_mesh_compat
    mesh = make_mesh_compat((2, 2), ("data", "model"))
    x = jax.ShapeDtypeStruct((64, 256), jnp.float32)
    w = jax.ShapeDtypeStruct((256, 128), jnp.float32)
    f = jax.jit(lambda a, b: a @ b,
                in_shardings=(NamedSharding(mesh, P(None, "model")),
                              NamedSharding(mesh, P("model", None))),
                out_shardings=NamedSharding(mesh, P()))
    st = collective_bytes(f.lower(x, w).compile().as_text())
    print("STATS", json.dumps(st.as_dict()))
""")


def test_sharded_contraction_all_reduce_equals_reference():
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REF_SCRIPT], env=env,
                       capture_output=True, text=True, timeout=120, cwd=ROOT)
    line = [l for l in r.stdout.splitlines() if l.startswith("STATS")]
    assert line, r.stdout + r.stderr
    want = json.loads(line[0][len("STATS "):])

    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import fake_world, named_mesh

    with fake_world(4):
        mesh = named_mesh("cuda", (2, 2), ("data", "model"))
        x = distribute_tensor(torch.empty(64, 256, device="meta"), mesh,
                              [Replicate(), Shard(1)], src_data_rank=None)
        w = distribute_tensor(torch.empty(256, 128, device="meta"), mesh,
                              [Replicate(), Shard(0)], src_data_rank=None)
        got = TA.analyze_step(
            lambda a, b: (a @ b).redistribute(mesh, [Replicate()] * 2), x, w)
    assert got.collectives.as_dict() == want
    assert got.collective_ops == want["ops"] == {"all-reduce": 1}
    assert got.collective_wire_bytes == want["total_wire_bytes"]
    # the local product is 64 x 128 over a 128-row shard of the contraction
    assert got.contraction_flops == 2 * 64 * 128 * 128
