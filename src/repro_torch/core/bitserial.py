"""Bit-serial in-SRAM arithmetic — the packed word engine in PyTorch.

The port of ``repro.core.bitserial``: the paper's §III arithmetic (add,
subtract, multiply, MAC, ReLU, max, selective copy, the log-tree reduce and
min/max, the dot) on word-packed bit planes.  Data lives in the transposed
layout: an unsigned n-bit tensor becomes n binary planes (LSB first), and
32 element lanes are packed into one word, so one bitwise op advances 32
lanes (see the reference module for the full layout contract).  Two lane
layouts share ``words[(n_planes, n_words)]``:

* flat (``row_lanes == 0``): bit ``l`` of ``words[p, w]`` is plane ``p`` of
  lane ``w * 32 + l`` (lanes flattened C-order, zero-padded to 32),
* row-aligned (``row_lanes == P``): the last lane axis (length K, the
  reduce axis) is padded to ``P = next_pow2(K)`` bit positions; ``P >= 32``
  gives ``P/32`` words per row, ``P < 32`` packs ``32/P`` rows per word.

Word tensors are ``torch.int64`` holding the 32-bit value (CPU torch has
no ``>>`` for ``uint32``); every complement is masked back to 32 bits.
Tensors stay on whatever device they arrive on, and the same word
recurrence runs on either (the reference's traced ``lax.scan`` branches
have no counterpart).  The ops accept raw ``{0,1}`` plane tensors
``(n_bits, *lanes)`` or :class:`PackedPlanes` and return ``(planes,
cycles)`` in the representation they were given.

Cycle-model invariants (the packed engine models the same hardware):

    add        : n + 1                     (§III-B)
    multiply   : n^2 + 5n - 2              (§III-C)
    divide     : 1.5 n^2 + 5.5 n           (§III-C)
    reduction  : log2(k) x (move + widening add)   (§III-D)

:func:`packed_dot_words` charges :func:`dot_cycles` before it dispatches to
a backend (core/backends.py), so modeled cycles cannot depend on the
backend.  :class:`CompressedPlanes` is the CSR-per-bit-plane filter store
and :func:`abft_checksums` / :func:`checksum_cycles` the ABFT integrity
layer's references and price.

Zero-operand elision (EIE-style, beyond the paper): the multiply drops word
columns whose 32 lanes all carry a zero operand and skips multiplier planes
whose tag word is all zero, as the reference's host walk does; ``ZERO_SKIP``
switches both off and ``SKIP_STATS`` counts them exactly as the reference
does.  Results and modeled cycles never change from either elision.
"""
from __future__ import annotations

import contextlib
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
    "shuffle_to_flat",
    "bitplane_pack",
    "bitplane_unpack",
    "add_cycles",
    "mul_cycles",
    "div_cycles",
    "move_cycles",
    "reduce_cycles",
    "minmax_cycles",
    "dot_cycles",
    "filter_occupancy",
    "bitserial_add",
    "bitserial_sub",
    "bitserial_multiply",
    "bitserial_mac",
    "bitserial_reduce",
    "bitserial_minmax",
    "selective_copy",
    "bitserial_relu",
    "bitserial_max",
    "bitserial_dot",
    "packed_dot_words",
    "CompressedPlanes",
    "abft_checksums",
    "checksum_cycles",
    "SkipStats",
    "SKIP_STATS",
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

    @property
    def n_words(self) -> int:
        return self.words.shape[1]

    @property
    def n_rows(self) -> int:
        """Row count of the row-aligned layout (reduce groups)."""
        if not self.row_lanes:
            raise ValueError("flat-packed planes have no row structure")
        return _numel(self.lane_shape[:-1])

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


def bitplane_pack(x: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Integer tensor -> ``n_bits`` binary planes ``(n_bits, *x.shape)``
    uint8, LSB first (values taken modulo 2^32, as the reference's uint32
    cast).  The paper's transposed layout: plane index == word line, the
    other axes == bit lines."""
    x = torch.as_tensor(x).to(torch.int64) & _MASK
    shifts = torch.arange(n_bits, dtype=torch.int64, device=x.device)
    shifts = shifts.reshape((n_bits,) + (1,) * x.ndim)
    return ((x[None] >> shifts) & 1).to(torch.uint8)


def bitplane_unpack(planes, signed: bool = False) -> torch.Tensor:
    """Inverse of :func:`bitplane_pack` (int64); ``signed`` reads the planes
    as two's complement of their width.  :class:`PackedPlanes` go through
    :func:`unpack_values`."""
    if isinstance(planes, PackedPlanes):
        return unpack_values(planes, signed=signed)
    n = planes.shape[0]
    p = planes.to(torch.int64)
    weights = (torch.ones(n, dtype=torch.int64, device=p.device)
               << torch.arange(n, dtype=torch.int64, device=p.device))
    val = (p * weights.reshape((n,) + (1,) * (p.ndim - 1))).sum(dim=0)
    if signed:
        val = torch.where(p[-1].bool(), val - (1 << n), val)
    return val


def shuffle_to_rows(pp: PackedPlanes) -> PackedPlanes:
    """Flat-packed -> row-aligned (reduce layout) lane shuffle."""
    if pp.row_lanes:
        return pp
    K = pp.lane_shape[-1] if pp.lane_shape else 1
    bits = _unpack_bits32(pp.words).reshape(pp.n_planes, -1)[:, :pp.n_lanes]
    grids = _grid_bits(bits, pp.lane_shape, True)
    return PackedPlanes(_pack_bits32(grids), pp.lane_shape, _row_layout(K)[0])


def shuffle_to_flat(pp: PackedPlanes) -> PackedPlanes:
    """Row-aligned -> flat-packed lane shuffle (inverse of
    :func:`shuffle_to_rows`)."""
    if not pp.row_lanes:
        return pp
    flat = _ungrid(_unpack_bits32(pp.words), pp.lane_shape, pp.row_lanes)
    grids = _grid_bits(flat, pp.lane_shape, False)
    return PackedPlanes(_pack_bits32(grids), pp.lane_shape, 0)


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


# ---------------------------------------------------------------------------
# EIE-style zero-operand elision (beyond the paper), counted as the
# reference's host walk counts it.
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SkipStats:
    """Accounting for the multiply's zero-operand elision (modeled cycles
    never change: the SRAM clocks every bit slice).

    ``words_*``/``lanes_*`` count word columns of the multiplier's
    broadcast grid (kept only with ``ZERO_SKIP`` on and more than one
    column); ``planes_*`` count multiplier plane steps, a plane with an
    all-zero tag word being an identity that is skipped."""

    lanes_total: int = 0
    lanes_zero: int = 0  # lanes with a provably-zero operand
    words_total: int = 0
    words_skipped: int = 0  # whole 32-lane words elided
    planes_total: int = 0  # multiplier plane steps seen
    planes_skipped: int = 0  # all-zero tag planes elided

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)

    def add(self, other: "SkipStats") -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name,
                    getattr(self, f.name) + getattr(other, f.name))


SKIP_STATS = SkipStats()
ZERO_SKIP = True  # module switch for the multiply's word and plane elision
_SINKS: list[SkipStats] = []


def _stats() -> SkipStats:
    return _SINKS[-1] if _SINKS else SKIP_STATS


@contextlib.contextmanager
def counts_into(stats: SkipStats):
    """Send the multiply's elision counts to ``stats`` instead of
    ``SKIP_STATS`` inside the scope (``nc_conv2d`` runs a layer's walk in
    one call but counts it per plan tile, as the reference runs it)."""
    _SINKS.append(stats)
    try:
        yield stats
    finally:
        _SINKS.pop()


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


def _nonzero_word(w: torch.Tensor) -> torch.Tensor:
    """OR over planes: bit ``l`` set iff lane ``l`` has any live bit."""
    out = w[0]
    for plane in w[1:]:
        out = out | plane
    return out


def _popcount32(w: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (SWAR; int64 holds the products)."""
    w = w - ((w >> 1) & 0x55555555)
    w = (w & 0x33333333) + ((w >> 2) & 0x33333333)
    w = (w + (w >> 4)) & 0x0F0F0F0F
    return ((w * 0x01010101) & _MASK) >> 24


def _columns(w: torch.Tensor, shape: tuple[int, ...],
             idx: torch.Tensor) -> torch.Tensor:
    """The word columns ``idx`` (flat indices into ``shape``) of ``w``
    ``(n, *s)`` broadcast against ``shape``, as ``(n, len(idx))``, without
    materializing the broadcast."""
    s = (1,) * (len(shape) - (w.ndim - 1)) + tuple(w.shape[1:])
    flat = torch.zeros_like(idx)
    rem = idx
    stride = 1
    for d in reversed(range(len(shape))):
        coord = rem % shape[d]
        rem = rem // shape[d]
        if s[d] != 1:
            flat = flat + coord * stride
            stride *= s[d]
    return w.reshape(w.shape[0], -1)[:, flat]


def _mul_words_dense(aw: torch.Tensor, bw: torch.Tensor,
                     shape: tuple[int, ...], stats: "SkipStats"):
    """Tag-predicated shifted-add multiply on broadcastable word tensors.

    A multiplier plane whose tag word has no set bit makes every lane's
    predicated write a no-op, so the step is skipped
    (``planes_skipped``); results are bit-identical."""
    na, nb = aw.shape[0], bw.shape[0]
    total = na + nb
    zero = torch.zeros(shape, dtype=torch.int64, device=aw.device)
    prod = [zero] * total
    stats.planes_total += nb
    for j in range(nb):
        tag = bw[j]
        if ZERO_SKIP and not bool(tag.any()):
            stats.planes_skipped += 1
            continue
        ntag = ~tag & _MASK
        carry = zero
        for i in range(total):
            # plane i of the multiplicand shifted up by j planes
            src = aw[i - j] if 0 <= i - j < na else zero
            s, carry = _word_full_adder(prod[i], src, carry)
            prod[i] = (tag & s) | (ntag & prod[i])
    return torch.stack([p.expand(shape) for p in prod])


def _mul_words(aw: torch.Tensor, bw: torch.Tensor) -> torch.Tensor:
    """Packed tag-predicated shifted-add multiply (§III-C): one step per
    multiplier plane, full-adding the plane-shifted multiplicand into the
    product under that plane's tag word.

    With ``ZERO_SKIP`` on and more than one word column, the columns whose
    32 lanes all carry a zero operand are counted, and when more than an
    eighth of them are dead only the live ones are multiplied (their
    product lanes are exactly zero); dead multiplier planes are skipped in
    either case.  Counted in ``SKIP_STATS`` as the reference's host walk
    counts them; results never change."""
    na, nb = aw.shape[0], bw.shape[0]
    total = na + nb
    shape = tuple(torch.broadcast_shapes(aw.shape[1:], bw.shape[1:]))
    n_words = _numel(shape)
    stats = _stats()
    if ZERO_SKIP and n_words > 1:
        active = (_nonzero_word(aw) & _nonzero_word(bw)).expand(shape)
        active = active.reshape(-1)
        live = active != 0
        n_live, n_set = (int(v) for v in torch.stack(
            [live.sum(), _popcount32(active).sum()]).tolist())
        stats.words_total += n_words
        stats.lanes_total += n_words * _WORD
        stats.lanes_zero += n_words * _WORD - n_set
        if n_live < n_words - n_words // 8:  # worth compressing
            stats.words_skipped += n_words - n_live
            idx = torch.nonzero(live).flatten()
            prod_c = _mul_words_dense(_columns(aw, shape, idx),
                                      _columns(bw, shape, idx), (n_live,),
                                      stats)
            prod = aw.new_zeros((total, n_words))
            prod[:, idx] = prod_c
            return prod.reshape((total,) + shape)
    return _mul_words_dense(aw, bw, shape, stats)


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
# Element-wise arithmetic (§III-B, §III-C).
# ---------------------------------------------------------------------------
def bitserial_add(a, b, out_bits: int | None = None):
    """Element-wise sum; ``out_bits`` defaults to the widest operand + 1.
    Returns ``(planes, cycles)``."""
    pa, packed_a = _coerce(a)
    pb, packed_b = _coerce(b)
    pa, pb = _align_pair(pa, pb)
    n = max(pa.n_planes, pb.n_planes)
    out_bits = out_bits if out_bits is not None else n + 1
    ow = _add_words(pa.words, pb.words, out_bits=out_bits)
    return _emit(ow, pa.lane_shape, packed_a or packed_b,
                 pa.row_lanes), add_cycles(n)


def bitserial_sub(a, b, out_bits: int | None = None):
    """``a - b`` in two's complement (width: the widest operand + 1 by
    default), the SRAM way: ``b``'s complement planes are read from BLB and
    the carry latch is preset to 1 (§III-B).  The result's MSB is the sign
    that drives the tag latch.  Returns ``(planes, cycles)``."""
    pa, packed_a = _coerce(a)
    pb, packed_b = _coerce(b)
    pa, pb = _align_pair(pa, pb)
    n = max(pa.n_planes, pb.n_planes)
    out_bits = out_bits if out_bits is not None else n + 1
    ow = _add_words(pa.words, pb.words, out_bits=out_bits, invert_b=True,
                    carry_one=True)
    return _emit(ow, pa.lane_shape, packed_a or packed_b,
                 pa.row_lanes), add_cycles(n)


def bitserial_multiply(a, b):
    """Element-wise product by tag-predicated shifted adds (§III-C): ``a``
    is the multiplicand, ``b`` the multiplier, the product has ``a_bits +
    b_bits`` planes.  Cycles ``n^2 + 5n - 2`` with ``n`` the wider
    operand's planes."""
    pa, packed_a = _coerce(a)
    pb, packed_b = _coerce(b)
    pa, pb = _align_pair(pa, pb)
    ow = _mul_words(pa.words, pb.words)
    n = max(pa.n_planes, pb.n_planes)
    return _emit(ow, pa.lane_shape, packed_a or packed_b,
                 pa.row_lanes), mul_cycles(n)


def bitserial_mac(acc, a, b):
    """``acc += a * b`` keeping the accumulator's width; cycles are the
    multiply's plus the add's.  Returns ``(planes, cycles)`` in ``acc``'s
    representation."""
    pacc, packed_acc = _coerce(acc)
    pa, _ = _coerce(a)
    pb, _ = _coerce(b)
    pa, pb = _align_pair(pa, pb)
    pacc, pa = _align_pair(pacc, pa)
    pacc, pb = _align_pair(pacc, pb)
    prod = _mul_words(pa.words, pb.words)
    n_mul = max(pa.n_planes, pb.n_planes)
    n_add = max(pacc.n_planes, prod.shape[0])
    out = _add_words(pacc.words, prod, out_bits=pacc.n_planes)
    cycles = mul_cycles(n_mul) + add_cycles(n_add)
    return _emit(out, pacc.lane_shape, packed_acc, pacc.row_lanes), cycles


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
                     acc_bits: int, engine: str | None = "walk"):
    """Fused row-aligned dot: ``sum_k x[row, k] * w[row, k]`` per row.

    ``xw``/``ww`` are word tensors ``(n_planes, *grid, row_words)`` whose
    grid axes broadcast (a window row packed once serves every filter).
    ``row_words`` covers rows of ``K`` lanes padded to ``P = next_pow2(K)``
    (``P < 32``: the last grid axis counts words of ``32/P`` rows each, and
    the result expands it back to rows).

    Returns ``(values int64, cycles_per_row)``.  Cycles follow
    :func:`dot_cycles` and are charged HERE, before dispatch, so no backend
    can perturb the cycle model.  ``engine`` names a registered backend
    (core/backends.py); the default is the exact walk, as the reference's
    is its host walk, and ``None`` resolves through ``NC_TORCH_BACKEND``,
    then ``gemm``."""
    from repro_torch.core import backends as _backends

    backend = _backends.get_backend(_backends.resolve_backend(engine))
    n_bits = max(xw.shape[0], ww.shape[0])
    cycles = dot_cycles(K, n_bits, acc_bits)
    return backend.dot_words(xw, ww, K=K, acc_bits=acc_bits), cycles


# ---------------------------------------------------------------------------
# Compressed (CSR per bit plane) filter store.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CompressedPlanes:
    """CSR-style per-bit-plane filter store (EIE-inspired).

    Instead of a dense ``(n_planes, n_columns, ...)`` word grid (one column
    per filter), each bit plane keeps only its live columns (filters with
    at least one set bit in that plane) as a sorted column index plus their
    words.  :meth:`dense` reconstructs the grid byte-identically, so the
    packed dot consumes exactly the words it would have seen uncompressed.
    Byte counts are those of the modeled store: 4 bytes per 32-bit word
    (the tensors hold them as int64) and a per-plane live-column bitmap of
    ``ceil(n_columns / 8)`` bytes for each live plane."""

    column_index: tuple  # per plane: sorted int64 live column ids
    columns: tuple  # per plane: (n_live, *tail) words
    n_columns: int  # dense column (filter) count
    tail_shape: tuple  # per-column word shape of the dense grid

    @property
    def n_planes(self) -> int:
        return len(self.column_index)

    @property
    def live_planes(self) -> int:
        """Planes with at least one live column (the only ones stored)."""
        return sum(1 for idx in self.column_index if idx.numel())

    @property
    def payload_bytes(self) -> int:
        """Bytes of packed words stored (live columns only)."""
        return sum(4 * c.numel() for c in self.columns)

    @property
    def index_bytes(self) -> int:
        """Per-plane live-column bitmap bytes (live planes only)."""
        return self.live_planes * (-(-self.n_columns // 8))

    @property
    def nbytes(self) -> int:
        return self.payload_bytes + self.index_bytes

    @classmethod
    def compress(cls, words: torch.Tensor) -> "CompressedPlanes":
        """Compress a dense per-plane filter word grid ``(n_planes,
        n_columns, ...)`` (on any device) into CSR-per-plane form."""
        if words.ndim < 2:
            raise ValueError(f"expected (n_planes, n_columns, ...) words, "
                             f"got {tuple(words.shape)}")
        live = cls.live_columns(words)
        index = tuple(torch.nonzero(live[p]).flatten()
                      for p in range(words.shape[0]))
        cols = tuple(words[p, index[p]].contiguous()
                     for p in range(words.shape[0]))
        return cls(column_index=index, columns=cols,
                   n_columns=int(words.shape[1]),
                   tail_shape=tuple(words.shape[2:]))

    @staticmethod
    def live_columns(words: torch.Tensor) -> torch.Tensor:
        """``(n_planes, n_columns)`` bool: the columns a plane stores."""
        tail = _numel(tuple(words.shape[2:]))
        return (words.reshape(words.shape[0], words.shape[1], tail) != 0).any(
            dim=2)

    @classmethod
    def split_bytes(cls, words: torch.Tensor,
                    bounds: list[tuple[int, int]]) -> tuple[int, int]:
        """``(payload, index)`` bytes summed over compressing each column
        slice ``words[:, m0:m1]`` of ``bounds`` on its own, without building
        the stores (a per-pass store, as an overlap plan keeps them)."""
        live = cls.live_columns(words).to(torch.int64)  # (n, C)
        tail = _numel(tuple(words.shape[2:]))
        edges = torch.tensor([0] + [m1 for _, m1 in bounds],
                             dtype=torch.int64, device=live.device)
        csum = torch.cat([live.new_zeros((live.shape[0], 1)),
                          live.cumsum(dim=1)], dim=1)
        per = csum[:, edges[1:]] - csum[:, edges[:-1]]  # (n, tiles) live cols
        widths = torch.tensor([-(-(m1 - m0) // 8) for m0, m1 in bounds],
                              dtype=torch.int64, device=live.device)
        payload = int(per.sum()) * tail * 4
        index = int(((per > 0).to(torch.int64) * widths[None, :]).sum())
        return payload, index

    def dense(self) -> torch.Tensor:
        """The dense ``(n_planes, n_columns, *tail_shape)`` word grid,
        byte-identical to what :meth:`compress` consumed (dead columns and
        planes come back as zero words, the multiply's identity)."""
        return self.dense_columns(0, self.n_columns)

    def dense_columns(self, start: int, stop: int) -> torch.Tensor:
        """Columns ``[start, stop)`` of the dense grid, without
        materializing the rest (two binary searches per plane)."""
        if not (0 <= start <= stop <= self.n_columns):
            raise ValueError(f"columns [{start}, {stop}) out of range for "
                             f"{self.n_columns}")
        ref = self.columns[0]
        grid = ref.new_zeros((self.n_planes, stop - start) + self.tail_shape)
        for p, (idx, cols) in enumerate(zip(self.column_index, self.columns)):
            if idx.numel():
                lo = int(torch.searchsorted(idx, start))
                hi = int(torch.searchsorted(idx, stop))
                if lo < hi:
                    grid[p, idx[lo:hi] - start] = cols[lo:hi]
        return grid


# ---------------------------------------------------------------------------
# ABFT integrity layer: checksum references over one pass's operands.
# ---------------------------------------------------------------------------
def abft_checksums(x_rows: torch.Tensor, w_rows: torch.Tensor):
    """ABFT reference sums for one pass over clean unsigned operands.

    The pass computes ``v[m, t] = w_m . x_t``; the column reference is
    ``col[t] = x_t . sum_m(w_m)`` and the row reference
    ``row[m] = sum_t(x_t) . w_m``.  Returns ``(col, row)`` as exact int64
    vectors on the operands' device.

    CUDA has no int64 matmul, so both products run in float64.  They are
    exact: every partial sum is an integer at most ``K * 255 * T * 255``
    (``T`` rows or filters summed), which at the largest full-width layer
    (K = 2592, batch-4 rows) stays below 2^53."""
    xr = x_rows.to(torch.float64)
    wr = w_rows.to(torch.float64)
    col = xr @ wr.sum(dim=0)
    row = wr @ xr.sum(dim=0)
    return col.to(torch.int64), row.to(torch.int64)


def checksum_cycles(k: int, n_bits: int, acc_bits: int, rows: int,
                    filters: int) -> int:
    """Cycles to verify one pass of ``rows`` window rows x ``filters``
    filter columns: one extra filter lane group dotted per row plus one
    extra window row dotted per filter, each at :func:`dot_cycles`."""
    return dot_cycles(k, n_bits, acc_bits) * (max(rows, 0) + max(filters, 0))


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


def bitserial_relu(x):
    """Two's-complement ReLU: zero the lanes whose sign plane is set
    (§IV-D).  Cycles ``n + 1``."""
    px, packed_x = _coerce(x)
    sign = px.words[-1]
    out = px.words & (~sign & _MASK)
    return _emit(out, px.lane_shape, packed_x, px.row_lanes), px.n_planes + 1


_resize_planes = _zext  # the reference's name for plane tensors


def bitserial_dot(x: torch.Tensor, w: torch.Tensor, n_bits: int = 8,
                  acc_bits: int = 24):
    """Per-lane dot product as an array column computes it: ``x``/``w``
    unsigned integer tensors ``[..., K]``, one ``n_bits`` MAC per lane into
    an ``acc_bits`` partial sum, then the §III-D log tree over the last
    axis.  Returns ``(values [...] int64, cycles)``."""
    xp = bitplane_pack(x, n_bits)
    wp = bitplane_pack(w, n_bits)
    acc = torch.zeros((acc_bits,) + tuple(x.shape), dtype=torch.uint8,
                      device=xp.device)
    acc, c_mac = bitserial_mac(acc, xp, wp)
    red, c_red = bitserial_reduce(acc)
    return bitplane_unpack(red)[..., 0], c_mac + c_red


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
