"""Per-device cost of one eager step, read from its local operations (the
counterpart of ``repro.distributed.hlo_analysis`` and
``repro.distributed.hlo_loop_analysis``).

The reference reads XLA's optimized, SPMD-partitioned HLO text.  The port
has no such program, so it matches the quantities, not the input:
:func:`analyze_step` runs the step under a ``TorchDispatchMode`` and counts
every operation one rank executes on its *local* shards.  The mode returns
``NotImplemented`` for DTensor operands, so DTensor first lowers each
global operation to its local operations and collectives, which the mode
then sees (a FLOP counter around DTensor code would count the global op);
the fake-tensor ops DTensor runs on global shapes to propagate shapes are
not counted.
On a fake world of ``meta`` tensors (:func:`repro_torch.launch.mesh.fake_world`)
nothing is computed and nothing allocated, so a full-size model on a
256-rank mesh is analysed on any host.

  * FLOPs: contractions (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
    ``_scaled_dot_product_*``) by ``torch.utils.flop_counter``'s formulas,
    ``2 m n k`` as the reference's dots; every other op one FLOP per output
    element (the reference charges elementwise and reduce ops so; an eager
    step also charges copies and casts that XLA fuses away).
  * bytes: operand + result bytes of every op that is not a view (the
    reference's per-instruction convention; an eager step has no fusion,
    so this is an upper bound on HBM traffic next to the reference's).
  * collectives: each ``_c10d_functional`` collective (and DTensor's
    ``shard_dim_alltoall``) with its group size,
    its wire bytes the result's bytes times the ring factor of
    :func:`_wire_factor`, as ``analyze_hlo`` charges them.
  * peak live bytes: tensors allocated by the step, tracked by storage
    until freed; the port's own estimate of the temporaries, not XLA's
    schedule.
  * loops: an eager step has no ``while`` loops; the layer loop and the
    attention tiles run in Python and report their trip counts through
    :func:`note_loop`.
  * hand-written kernels: each is a ``repro_torch::*`` custom op
    (:mod:`repro_torch.kernels.ops`), one op to the mode, whose FLOPs come
    from the formula it registers in ``torch.utils.flop_counter``'s
    registry and count as contractions.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["analyze_step", "StepCost", "CollectiveStats", "DTYPE_BYTES",
           "note_loop"]

DTYPE_BYTES = {
    torch.bool: 1, torch.int8: 1, torch.uint8: 1, torch.int16: 2,
    torch.int32: 4, torch.int64: 8, torch.float8_e4m3fn: 1,
    torch.float8_e5m2: 1, torch.bfloat16: 2, torch.float16: 2,
    torch.float32: 4, torch.float64: 8, torch.complex64: 8,
    torch.complex128: 16,
}


def _wire_factor(kind: str, n: int) -> float:
    if n <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n
    if kind == "collective-permute":
        return 1.0
    return (n - 1) / n  # all-gather / reduce-scatter / all-to-all


@dataclasses.dataclass
class CollectiveStats:
    ops: dict[str, int] = dataclasses.field(default_factory=dict)
    operand_bytes: dict[str, int] = dataclasses.field(default_factory=dict)
    wire_bytes: dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def total_operand_bytes(self) -> int:
        return sum(self.operand_bytes.values())

    @property
    def total_wire_bytes(self) -> float:
        return sum(self.wire_bytes.values())

    def add(self, kind: str, nbytes: int, group: int) -> None:
        self.ops[kind] = self.ops.get(kind, 0) + 1
        self.operand_bytes[kind] = self.operand_bytes.get(kind, 0) + nbytes
        self.wire_bytes[kind] = (
            self.wire_bytes.get(kind, 0.0) + nbytes * _wire_factor(kind, group)
        )

    def as_dict(self) -> dict:
        return {
            "ops": dict(self.ops),
            "operand_bytes": dict(self.operand_bytes),
            "wire_bytes": {k: round(v) for k, v in self.wire_bytes.items()},
            "total_operand_bytes": self.total_operand_bytes,
            "total_wire_bytes": round(self.total_wire_bytes),
        }


@dataclasses.dataclass
class StepCost:
    """The fields of the reference's ``LoopAwareCost``, per device, plus
    the contraction share of the FLOPs, the collectives by kind and the
    peak of live bytes the step allocated."""

    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_wire_bytes: float = 0.0
    collective_ops: dict = dataclasses.field(default_factory=dict)
    loops: list = dataclasses.field(default_factory=list)
    contraction_flops: float = 0.0
    collectives: CollectiveStats = dataclasses.field(
        default_factory=CollectiveStats)
    peak_live_bytes: int = 0

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "collective_wire_bytes": self.collective_wire_bytes,
            "collective_ops": dict(self.collective_ops),
            "loops": list(self.loops),
            "contraction_flops": self.contraction_flops,
            "peak_live_bytes": self.peak_live_bytes,
        }


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * DTYPE_BYTES.get(t.dtype, t.element_size())


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


# collective op name -> the reference's kind (the group name is the last
# argument of each)
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",  # DTensor's Shard(i) -> Shard(j)
    "broadcast": "broadcast",
}
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "wait_tensor"}

_ACTIVE: "_CostMode | None" = None


def _group_size(args, kwargs) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    name = kwargs.get("group_name", args[-1])
    return _resolve_process_group(name).size()


class _CostMode(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.flop_registry = flop_registry
        self.cost = StepCost()
        self.live = 0
        self.seen: dict[int, int] = {}

    def _alloc(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.seen:
            return
        nb = st.nbytes()
        self.seen[key] = nb
        self.live += nb
        self.cost.peak_live_bytes = max(self.cost.peak_live_bytes, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self.seen.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # let DTensor lower it to local ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = list(_tensors(args)) + list(_tensors(kwargs))
        outs = list(_tensors(out))
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out  # DTensor's shape propagation on global shapes
        packet = func._overloadpacket
        name = packet.__name__
        c = self.cost
        in_ids = {id(t) for t in ins}
        if (func.namespace == "_c10d_functional" and name in _COLLECTIVES
                or func.namespace == "_dtensor" and name in _COLLECTIVES):
            kind = _COLLECTIVES[name]
            rbytes = sum(_nbytes(t) for t in outs)
            c.collectives.add(kind, rbytes, _group_size(args, kwargs))
            c.collective_ops[kind] = c.collective_ops.get(kind, 0) + 1
            c.collective_wire_bytes = c.collectives.total_wire_bytes
        elif packet in self.flop_registry:
            f = self.flop_registry[packet](*args, **kwargs, out_val=out)
            c.flops += f
            c.contraction_flops += f
        elif not func.is_view:
            c.flops += sum(t.numel() for t in outs if id(t) not in in_ids)
        if not func.is_view and name not in _NO_BYTES:
            c.bytes_accessed += (sum(_nbytes(t) for t in ins)
                                 + sum(_nbytes(t) for t in outs))
        if not func.is_view:
            for t in outs:
                if id(t) not in in_ids:
                    self._alloc(t)
        return out


def note_loop(name: str, trips: int) -> None:
    """Record a Python loop of ``trips`` iterations at site ``name`` in the
    step being analysed (no-op otherwise)."""
    if _ACTIVE is None:
        return
    for entry in _ACTIVE.cost.loops:
        if entry["while"] == name and entry["trips"] == trips:
            entry["calls"] += 1
            return
    _ACTIVE.cost.loops.append({"while": name, "trips": int(trips),
                               "calls": 1})


@contextlib.contextmanager
def _recording():
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("analyze_step does not nest")
    mode = _CostMode()
    _ACTIVE = mode
    try:
        with mode:
            yield mode
    finally:
        _ACTIVE = None


def analyze_step(fn, *args, **kwargs) -> StepCost:
    """Run ``fn(*args, **kwargs)`` once and return its per-device
    :class:`StepCost`.  The step really runs (on a real device its results
    are computed and discarded); on ``meta`` tensors it only dispatches."""
    with _recording() as mode:
        out = fn(*args, **kwargs)
        del out
    return mode.cost
