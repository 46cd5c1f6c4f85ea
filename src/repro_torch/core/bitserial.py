"""Bit-serial in-SRAM arithmetic — the packed word engine in PyTorch.

The port of ``repro.core.bitserial`` for the parts the Inception main path
runs.  Data lives in the transposed layout: an unsigned n-bit tensor becomes
n binary planes (LSB first), and 32 element lanes are packed into one word,
so one bitwise op advances 32 lanes (see the reference module for the full
layout contract).  Two lane layouts share ``words[(n_planes, n_words)]``:

* flat (``row_lanes == 0``): bit ``l`` of ``words[p, w]`` is plane ``p`` of
  lane ``w * 32 + l`` (lanes flattened C-order, zero-padded to 32),
* row-aligned (``row_lanes == P``): the last lane axis (length K, the
  reduce axis) is padded to ``P = next_pow2(K)`` bit positions; ``P >= 32``
  gives ``P/32`` words per row, ``P < 32`` packs ``32/P`` rows per word.

Word tensors are ``torch.int64`` holding the 32-bit value (CPU torch has
no ``>>`` for ``uint32``); every complement is masked back to 32 bits.
Tensors stay on whatever device they arrive on.

Cycle-model invariants (the packed engine models the same hardware):

    add        : n + 1                     (§III-B)
    multiply   : n^2 + 5n - 2              (§III-C)
    divide     : 1.5 n^2 + 5.5 n           (§III-C)
    reduction  : log2(k) x (move + widening add)   (§III-D)

:func:`packed_dot_words` charges :func:`dot_cycles` before it dispatches to
a backend (core/backends.py), so modeled cycles cannot depend on the
backend.  The reference's compressed filter store, ABFT checksums and the
host walk's zero-word elision statistics are not part of this package yet.
"""
from __future__ import annotations

import dataclasses
import math

import torch

__all__ = [
    "PackedPlanes",
    "pack_lanes",
    "unpack_lanes",
    "pack_values",
    "unpack_values",
    "shuffle_to_rows",
    "add_cycles",
    "mul_cycles",
    "div_cycles",
    "move_cycles",
    "reduce_cycles",
    "minmax_cycles",
    "dot_cycles",
    "filter_occupancy",
    "bitserial_reduce",
    "bitserial_minmax",
    "selective_copy",
    "bitserial_max",
    "packed_dot_words",
    "OpCycles",
]

_WORD = 32
_MASK = 0xFFFFFFFF


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _row_layout(K: int) -> tuple[int, int, int]:
    """Reduce-axis layout: (P, words_per_row, rows_per_word) for K lanes."""
    P = _next_pow2(max(K, 1))
    if P >= _WORD:
        return P, P // _WORD, 1
    return P, 1, _WORD // P


def _numel(shape) -> int:
    return math.prod(shape) if shape else 1


# ---------------------------------------------------------------------------
# Word <-> bit helpers.
# ---------------------------------------------------------------------------
def _shifts(device) -> torch.Tensor:
    return torch.arange(_WORD, dtype=torch.int64, device=device)


def _pack_bits32(bits: torch.Tensor) -> torch.Tensor:
    """(..., 32) {0,1} -> (...,) int64 words."""
    return (bits.to(torch.int64) << _shifts(bits.device)).sum(dim=-1)


def _unpack_bits32(words: torch.Tensor) -> torch.Tensor:
    """(...,) words -> (..., 32) int64 {0,1}."""
    return (words.unsqueeze(-1) >> _shifts(words.device)) & 1


# ---------------------------------------------------------------------------
# Packed bit-lane container.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PackedPlanes:
    """Word-packed bit planes: ``words`` is ``(n_planes, n_words)`` int64
    holding 32-bit words (layout in the module docstring)."""

    words: torch.Tensor
    lane_shape: tuple[int, ...]
    row_lanes: int = 0

    @property
    def n_planes(self) -> int:
        return self.words.shape[0]

    @property
    def n_lanes(self) -> int:
        return _numel(self.lane_shape)

    def __getitem__(self, idx) -> "PackedPlanes":
        """Plane-axis slicing (lane layout is preserved)."""
        if not isinstance(idx, slice):
            raise TypeError("PackedPlanes supports plane-axis slices only")
        return PackedPlanes(self.words[idx], self.lane_shape, self.row_lanes)


def _grid_bits(flat: torch.Tensor, lane_shape: tuple[int, ...],
               row_align: bool) -> torch.Tensor:
    """Per-lane values ``(n, n_lanes)`` -> the ``(n, n_words, 32)``
    bit-position grid of the requested layout (padding positions zero)."""
    n, n_lanes = flat.shape
    if not row_align:
        n_words = max(-(-n_lanes // _WORD), 1)
        grid = flat.new_zeros((n, n_words * _WORD))
        grid[:, :n_lanes] = flat
        return grid.reshape(n, n_words, _WORD)
    K = lane_shape[-1] if lane_shape else 1
    B = max(n_lanes // max(K, 1), 1)
    P, wpr, r = _row_layout(K)
    if r == 1:
        grid = flat.new_zeros((n, B, wpr * _WORD))
        grid[:, :, :K] = flat.reshape(n, B, K)
        return grid.reshape(n, B * wpr, _WORD)
    Bp = -(-B // r) * r
    grid = flat.new_zeros((n, Bp, P))
    grid[:, :B, :K] = flat.reshape(n, B, K)
    return grid.reshape(n, Bp // r, _WORD)


def _ungrid(grid: torch.Tensor, lane_shape: tuple[int, ...],
            row_lanes: int) -> torch.Tensor:
    """Inverse of :func:`_grid_bits`: (n, n_words, 32) grid -> (n, lanes)."""
    n = grid.shape[0]
    n_lanes = _numel(lane_shape)
    if not row_lanes:
        return grid.reshape(n, -1)[:, :n_lanes]
    K = lane_shape[-1] if lane_shape else 1
    B = max(n_lanes // max(K, 1), 1)
    P, wpr, r = _row_layout(K)
    if r == 1:
        return grid.reshape(n, B, wpr * _WORD)[:, :, :K].reshape(n, -1)
    return grid.reshape(n, -1, P)[:, :B, :K].reshape(n, -1)


def _row_lanes(lane_shape: tuple[int, ...], row_align: bool) -> int:
    return _row_layout(lane_shape[-1] if lane_shape else 1)[0] if row_align else 0


def pack_lanes(planes: torch.Tensor, row_align: bool = False) -> PackedPlanes:
    """Raw ``{0,1}`` planes ``(n, *lanes)`` -> :class:`PackedPlanes`."""
    n = planes.shape[0]
    lane_shape = tuple(planes.shape[1:])
    flat = planes.to(torch.int64).reshape(n, -1)
    words = _pack_bits32(_grid_bits(flat, lane_shape, row_align))
    return PackedPlanes(words, lane_shape, _row_lanes(lane_shape, row_align))


def unpack_lanes(pp: PackedPlanes) -> torch.Tensor:
    """:class:`PackedPlanes` -> raw ``{0,1}`` planes ``(n, *lanes)`` uint8."""
    bits = _unpack_bits32(pp.words)
    flat = _ungrid(bits, pp.lane_shape, pp.row_lanes)
    return flat.reshape((pp.n_planes,) + pp.lane_shape).to(torch.uint8)


def pack_values(x: torch.Tensor, n_bits: int,
                row_align: bool = False) -> PackedPlanes:
    """Integer tensor -> :class:`PackedPlanes` without materializing the
    raw ``(n_bits, *lanes)`` plane tensor (``row_align=True`` when the last
    axis is the reduce axis)."""
    lane_shape = tuple(x.shape)
    grid = _grid_bits(x.to(torch.int64).reshape(1, -1), lane_shape,
                      row_align)[0]  # (n_words, 32) values
    shifts = _shifts(x.device)
    words = torch.stack([(((grid >> p) & 1) << shifts).sum(dim=-1)
                         for p in range(n_bits)])
    return PackedPlanes(words, lane_shape, _row_lanes(lane_shape, row_align))


def unpack_values(pp: PackedPlanes, signed: bool = False) -> torch.Tensor:
    """:class:`PackedPlanes` -> int64 tensor of ``lane_shape``."""
    n = pp.n_planes
    acc = torch.zeros((pp.words.shape[1], _WORD), dtype=torch.int64,
                      device=pp.words.device)
    for p in range(n):
        acc += _unpack_bits32(pp.words[p]) << p
    val = _ungrid(acc[None], pp.lane_shape, pp.row_lanes)[0]
    if signed:
        sign = _ungrid(_unpack_bits32(pp.words[n - 1])[None], pp.lane_shape,
                       pp.row_lanes)[0]
        val = torch.where(sign.bool(), val - (1 << n), val)
    return val.reshape(pp.lane_shape)


def shuffle_to_rows(pp: PackedPlanes) -> PackedPlanes:
    """Flat-packed -> row-aligned (reduce layout) lane shuffle."""
    if pp.row_lanes:
        return pp
    K = pp.lane_shape[-1] if pp.lane_shape else 1
    bits = _unpack_bits32(pp.words).reshape(pp.n_planes, -1)[:, :pp.n_lanes]
    grids = _grid_bits(bits, pp.lane_shape, True)
    return PackedPlanes(_pack_bits32(grids), pp.lane_shape, _row_layout(K)[0])


def _coerce(x) -> tuple[PackedPlanes, bool]:
    if isinstance(x, PackedPlanes):
        return x, True
    return pack_lanes(x), False


def _align_pair(pa: PackedPlanes, pb: PackedPlanes):
    """Bring two operands to a common lane layout (packed-space shuffle)."""
    if pa.row_lanes == pb.row_lanes:
        return pa, pb
    if pa.row_lanes and not pb.row_lanes:
        return pa, shuffle_to_rows(pb)
    if pb.row_lanes and not pa.row_lanes:
        return shuffle_to_rows(pa), pb
    raise ValueError(
        f"incompatible row layouts: {pa.row_lanes} vs {pb.row_lanes}")


def _emit(words, lane_shape: tuple[int, ...], packed: bool,
          row_lanes: int = 0):
    pp = PackedPlanes(words, lane_shape, row_lanes)
    return pp if packed else unpack_lanes(pp)


def _pack_mask(mask, like: PackedPlanes | None = None) -> torch.Tensor:
    """Per-lane predicate -> packed tag word row ``(n_words,)`` in the lane
    layout of ``like`` (flat when omitted)."""
    if isinstance(mask, PackedPlanes):
        return mask.words[0]
    row = bool(like is not None and like.row_lanes)
    return pack_lanes(torch.as_tensor(mask).to(torch.uint8)[None],
                      row_align=row).words[0]


# ---------------------------------------------------------------------------
# Cycle formulas (paper §III).
# ---------------------------------------------------------------------------
def add_cycles(n: int) -> int:
    return n + 1


def mul_cycles(n: int) -> int:
    return n * n + 5 * n - 2


def div_cycles(n: int) -> float:
    return 1.5 * n * n + 5.5 * n


def move_cycles(n: int) -> int:
    # word-line move: read + write-back per bit (§III-D)
    return n


def _log2_steps(k: int) -> int:
    return (max(k, 1) - 1).bit_length()  # == ceil(log2(max(k, 1)))


def reduce_cycles(k: int, width: int) -> int:
    """Cycles to reduce ``k`` elements of ``width`` bits to one sum in-array."""
    cyc = 0
    w = width
    for _ in range(_log2_steps(k)):
        cyc += move_cycles(w) + add_cycles(w)
        w += 1
    return cyc


def minmax_cycles(k: int, width: int) -> int:
    """Cycles for the §IV-D in-cache min/max log tree over ``k`` lanes of
    ``width``-bit values: per halving step one subtract, one tag-masked
    selective copy and a tag load."""
    return _log2_steps(k) * (add_cycles(width) + (width + 1) + 1)


def dot_cycles(k: int, n_bits: int, acc_bits: int) -> int:
    """Per-lane-group dot cycles: one n-bit MAC into an ``acc_bits`` partial
    sum, then the §III-D log tree over ``k`` lanes (the conv inner loop)."""
    return (mul_cycles(n_bits) + add_cycles(max(acc_bits, 2 * n_bits))
            + reduce_cycles(k, acc_bits))


def filter_occupancy(rows: torch.Tensor, n_bits: int, zero: int = 0):
    """Pack-time operand occupancy scan for sparsity-aware scheduling.

    ``rows``: integer filter rows ``(M, K)``.  Returns ``(zero_mask,
    plane_live)`` as CPU bool tensors: ``zero_mask`` ``(M,)`` marks filters
    whose every weight equals ``zero``; ``plane_live`` ``(n_bits,)`` marks
    bit planes with at least one set bit across the live filters."""
    rows = torch.as_tensor(rows)
    if rows.ndim != 2:
        rows = rows.reshape(rows.shape[0], -1)
    rows = rows.to(torch.int64)
    zero_mask = (rows == zero).all(dim=1)
    live = rows[~zero_mask]
    plane_live = torch.stack([((live >> p) & 1).any()
                              for p in range(n_bits)]) if n_bits else \
        torch.zeros(0, dtype=torch.bool)
    return zero_mask.cpu(), plane_live.cpu()


# ---------------------------------------------------------------------------
# The column peripheral, word-packed: full adder + carry latch + tag latch,
# one bit-slice per step.  Word tensors broadcast over their lane axes.
# ---------------------------------------------------------------------------
def _word_full_adder(a, b, c):
    s = a ^ b ^ c
    carry = (a & b) | ((a ^ b) & c)
    return s, carry


def _zext(w: torch.Tensor, n: int) -> torch.Tensor:
    if w.shape[0] == n:
        return w
    if w.shape[0] > n:
        return w[:n]
    out = w.new_zeros((n,) + tuple(w.shape[1:]))
    out[: w.shape[0]] = w
    return out


def _add_words(aw, bw, *, out_bits: int, invert_b: bool = False,
               carry_one: bool = False) -> torch.Tensor:
    """Packed ripple add over ``out_bits`` planes (operands broadcast).

    ``invert_b``/``carry_one`` give two's-complement subtraction (complement
    planes from BLB, carry latch preset to 1, §III-B)."""
    a = _zext(aw, out_bits)
    b = _zext(bw, out_bits)
    if invert_b:
        b = ~b & _MASK
    shape = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    carry = torch.full(shape, _MASK if carry_one else 0, dtype=torch.int64,
                       device=a.device)
    out = []
    for i in range(out_bits):
        s, carry = _word_full_adder(a[i], b[i], carry)
        out.append(s.expand(shape))
    return torch.stack(out)


def _mul_words(aw: torch.Tensor, bw: torch.Tensor) -> torch.Tensor:
    """Packed tag-predicated shifted-add multiply (§III-C): one step per
    multiplier plane, full-adding the plane-shifted multiplicand into the
    product under that plane's tag word."""
    na, nb = aw.shape[0], bw.shape[0]
    total = na + nb
    shape = torch.broadcast_shapes(aw.shape[1:], bw.shape[1:])
    zero = torch.zeros(shape, dtype=torch.int64, device=aw.device)
    prod = [zero] * total
    for j in range(nb):
        tag = bw[j]
        ntag = ~tag & _MASK
        carry = zero
        for i in range(total):
            # plane i of the multiplicand shifted up by j planes
            src = aw[i - j] if 0 <= i - j < na else zero
            s, carry = _word_full_adder(prod[i], src, carry)
            prod[i] = (tag & s) | (ntag & prod[i])
    return torch.stack([p.expand(shape) for p in prod])


def _select_words(dst, src, tag) -> torch.Tensor:
    """Tag-predicated copy: dst where tag bit is 0, src where it is 1."""
    src = _zext(src, dst.shape[0])
    return (tag & src) | ((~tag & _MASK) & dst)


def _keep_mask(half: int, seg: int) -> int:
    pat = (1 << half) - 1
    keep = 0
    for j in range(_WORD // seg):
        keep |= pat << (j * seg)
    return keep


def _halves(w: torch.Tensor, half: int, seg: int):
    """Top and bottom half of every row segment: a word slice for halves of
    at least a word, an in-word shift below that."""
    if half >= _WORD:
        hw = half // _WORD
        return w[..., :hw], w[..., hw:]
    keep = _keep_mask(half, seg)
    return w & keep, (w >> half) & keep


# ---------------------------------------------------------------------------
# Reduction (§III-D): log tree over the last lane axis in packed space.
# ---------------------------------------------------------------------------
def _reduce_tree_words(words: torch.Tensor, width: int, K: int):
    """Run the log tree on row-aligned words ``(width, ..., wpr)``.

    Returns ``(words (width+steps, ..., 1), cycles)``; each row's sum sits
    at its segment's bit 0."""
    P, wpr, r = _row_layout(K)
    cycles = 0
    w, m = width, P
    seg = P if P < _WORD else _WORD
    while m > 1:
        half = m // 2
        lo, hi = _halves(words, half, seg)
        words = _add_words(lo, hi, out_bits=w + 1)
        cycles += move_cycles(w) + add_cycles(w)
        w += 1
        m = half
    return words, cycles


def _rows_result_bits(words: torch.Tensor, K: int) -> torch.Tensor:
    """Each row's post-tree result bit: (w, ..., 1) words -> (w, n_rows)."""
    P, wpr, r = _row_layout(K)
    t = words[..., 0]
    if r == 1:
        return t & 1
    offs = torch.arange(r, dtype=torch.int64, device=t.device) * P
    bits = (t.unsqueeze(-1) >> offs) & 1
    return bits.reshape(tuple(t.shape[:-1]) + (-1,))


def bitserial_reduce(planes, out_bits: int | None = None):
    """Sum across the last axis via the §III-D log tree.  Accepts raw planes
    or :class:`PackedPlanes`; returns ``(planes, cycles)`` with the lane axis
    reduced to 1, in the representation it was given."""
    packed_in = isinstance(planes, PackedPlanes)
    pp = planes if packed_in else pack_lanes(planes, row_align=True)
    k = pp.lane_shape[-1] if pp.lane_shape else 1
    width = pp.n_planes
    other = tuple(pp.lane_shape[:-1])
    out_shape = other + (1,)
    if k <= 1:
        # the K == 1 row layout degenerates to flat packing of the rows
        out = PackedPlanes(pp.words, out_shape, 0)
        cycles = 0
    else:
        rows = shuffle_to_rows(pp)
        tree, cycles = _reduce_tree_words(
            rows.words.reshape(width, -1, max(_row_layout(k)[1], 1)),
            width, k)
        bits = _rows_result_bits(tree, k)[:, :_numel(other)]
        out = pack_lanes(bits.reshape((bits.shape[0],) + out_shape))
    if cycles != reduce_cycles(k, width):
        raise AssertionError((cycles, reduce_cycles(k, width)))
    if out_bits is not None:
        out = PackedPlanes(_zext(out.words, out_bits), out.lane_shape,
                           out.row_lanes)
    return (out if packed_in else unpack_lanes(out)), cycles


def _minmax_tree_words(words: torch.Tensor, width: int, K: int):
    """Min/max log tree on row-aligned words ``(width, ..., wpr)``: per step
    one subtract whose sign drives a tag-masked selective copy, for the min
    and the max candidate grids in lockstep.  Returns
    ``(min_words, max_words, cycles)``."""
    P, wpr, r = _row_layout(K)
    seg = P if P < _WORD else _WORD
    mn = mx = words
    cycles = 0
    m = P
    while m > 1:
        half = m // 2
        lo, hi = _halves(mx, half, seg)
        lo_lt = _add_words(lo, hi, out_bits=width + 1, invert_b=True,
                           carry_one=True)[-1]  # sign of lo - hi
        mx = _select_words(lo, hi, lo_lt)
        lo, hi = _halves(mn, half, seg)
        hi_lt = _add_words(hi, lo, out_bits=width + 1, invert_b=True,
                           carry_one=True)[-1]  # sign of hi - lo
        mn = _select_words(lo, hi, hi_lt)
        cycles += add_cycles(width) + (width + 1) + 1
        m = half
    return mn, mx, cycles


def bitserial_minmax(planes):
    """Per-row min AND max over the last lane axis (§IV-D dynamic range).

    Returns ``((min, max), cycles)`` with the lane axis reduced to 1.
    Zero-padded lanes fold a 0 into the tree: callers that need exact
    minima pad rows with copies of a real lane (see ``nc_layers.nc_minmax``).
    """
    packed_in = isinstance(planes, PackedPlanes)
    pp = planes if packed_in else pack_lanes(planes, row_align=True)
    k = pp.lane_shape[-1] if pp.lane_shape else 1
    width = pp.n_planes
    other = tuple(pp.lane_shape[:-1])
    out_shape = other + (1,)
    if k <= 1:
        out_mn = out_mx = PackedPlanes(pp.words, out_shape, 0)
        cycles = 0
    else:
        rows = shuffle_to_rows(pp)
        wpr = max(_row_layout(k)[1], 1)
        mnw, mxw, cycles = _minmax_tree_words(
            rows.words.reshape(width, -1, wpr), width, k)
        n_rows = _numel(other)

        def emit(w):
            bits = _rows_result_bits(w, k)[:, :n_rows]
            return pack_lanes(bits.reshape((width,) + out_shape))

        out_mn, out_mx = emit(mnw), emit(mxw)
    if cycles != minmax_cycles(k, width):
        raise AssertionError((cycles, minmax_cycles(k, width)))
    if packed_in:
        return (out_mn, out_mx), cycles
    return (unpack_lanes(out_mn), unpack_lanes(out_mx)), cycles


# ---------------------------------------------------------------------------
# Fused packed dot (MAC + log tree) over row-aligned word grids.
# ---------------------------------------------------------------------------
def _dot_words_impl(xw: torch.Tensor, ww: torch.Tensor, *, K: int,
                    acc_bits: int) -> torch.Tensor:
    """The exact bit-serial walk behind :func:`packed_dot_words`: packed
    multiply, zero-extend to the accumulator width, log-tree reduce, decode
    each row's sum.  Returns int64 row values."""
    prod = _mul_words(xw, ww)  # (nx+nw, *grid, wpr_or_rowwords)
    acc = _zext(prod, acc_bits)
    P, wpr, r = _row_layout(K)
    # P >= 32: last axis is the words-per-row; P < 32: every axis is grid
    grid = tuple(acc.shape[1:-1]) if r == 1 else tuple(acc.shape[1:])
    tree, _ = _reduce_tree_words(acc.reshape(acc_bits, -1, wpr), acc_bits, K)
    bits = _rows_result_bits(tree, K)  # (w', flat_rows)
    weights = torch.ones(bits.shape[0], dtype=torch.int64,
                         device=bits.device) << torch.arange(
        bits.shape[0], dtype=torch.int64, device=bits.device)
    vals = (bits * weights[:, None]).sum(dim=0)
    if r == 1:
        return vals.reshape(grid)
    return vals.reshape(grid[:-1] + (grid[-1] * r,))


def packed_dot_words(xw: torch.Tensor, ww: torch.Tensor, *, K: int,
                     acc_bits: int, engine: str | None = None):
    """Fused row-aligned dot: ``sum_k x[row, k] * w[row, k]`` per row.

    ``xw``/``ww`` are word tensors ``(n_planes, *grid, row_words)`` whose
    grid axes broadcast (a window row packed once serves every filter).
    ``row_words`` covers rows of ``K`` lanes padded to ``P = next_pow2(K)``
    (``P < 32``: the last grid axis counts words of ``32/P`` rows each, and
    the result expands it back to rows).

    Returns ``(values int64, cycles_per_row)``.  Cycles follow
    :func:`dot_cycles` and are charged HERE, before dispatch, so no backend
    can perturb the cycle model.  ``engine`` names a registered backend
    (core/backends.py); ``None`` resolves through ``NC_TORCH_BACKEND``, then
    the default (``gemm``)."""
    from repro_torch.core import backends as _backends

    backend = _backends.get_backend(_backends.resolve_backend(engine))
    n_bits = max(xw.shape[0], ww.shape[0])
    cycles = dot_cycles(K, n_bits, acc_bits)
    return backend.dot_words(xw, ww, K=K, acc_bits=acc_bits), cycles


# ---------------------------------------------------------------------------
# Predicated ops (tag latch) — selective copy and max (§IV-D).
# ---------------------------------------------------------------------------
def selective_copy(dst, src, mask):
    """Copy ``src`` planes over ``dst`` where ``mask`` (per bit line) is 1.
    Cycles: one per bit (tag-enabled write-back) plus 1 to load the tag."""
    pd, packed_d = _coerce(dst)
    ps, _ = _coerce(src)
    pd, ps = _align_pair(pd, ps)
    n = max(pd.n_planes, ps.n_planes)
    tag = _pack_mask(mask, like=pd)
    out = _select_words(pd.words, ps.words, tag)
    return _emit(out, pd.lane_shape, packed_d, pd.row_lanes), n + 1


def bitserial_max(a, b):
    """Element-wise max of two unsigned plane tensors via subtract + masked
    copy (§IV-D max pooling)."""
    pa, packed_a = _coerce(a)
    pb, packed_b = _coerce(b)
    pa, pb = _align_pair(pa, pb)
    n = max(pa.n_planes, pb.n_planes)
    diff = _add_words(pa.words, pb.words, out_bits=n + 1,
                      invert_b=True, carry_one=True)
    out = _select_words(pa.words, pb.words, diff[-1])  # sign of a-b
    return _emit(out, pa.lane_shape, packed_a or packed_b,
                 pa.row_lanes), add_cycles(n) + n + 1


@dataclasses.dataclass
class OpCycles:
    """Cycle-cost card for one 8-bit MAC pipeline, used by the simulator
    (``mac8`` is the paper's measured per-MAC constant, §VI-A)."""

    bits: int = 8
    acc_bits: int = 24
    mac8: int = 236

    @property
    def mac_floor(self) -> int:
        return mul_cycles(self.bits) + add_cycles(self.acc_bits)

    @property
    def mac_overhead(self) -> int:
        return self.mac8 - self.mac_floor
