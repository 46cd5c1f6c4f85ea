"""Functional execution of DNN layers through the bit-serial engine.

The port of ``repro.core.nc_layers``: each layer is computed the way the
cache would — uint8 operands, bit-plane transposed layout, tag-predicated
MACs, in-array log-tree reduction, fixed-point requantization — with every
tensor on the caller's device.  Outputs, cycles and :class:`ConvStats` equal
the reference's.

A conv runs all of its planned row and filter tiles in ONE dot over
``[rows_total, live filters]``: values do not depend on tiling, and one
launch per layer keeps the GPU busy where one launch per planned tile would
not.  The plan's tiles are still reported
(``ConvStats.tiles``/``tile_pixels``/``tile_filters``).  On a CUDA tensor
an unchecked ``gemm`` layer hands its uint8 window and filter rows to the
bit-serial GEMM kernel directly (the rows route, :func:`_dot_rows`): the
row-aligned words would decode back to the same integers.  Everywhere else
the dot is one ``packed_dot_words`` call on the words (the word route);
only a backend with a grid cap (``walk``) splits the rows into chunks.
Overlap plans execute serially (results are byte-identical by the
reference's own contract) and report ``overlap`` as the reference does.

Compressed plans report the bytes of the
:class:`~repro_torch.core.bitserial.CompressedPlanes` store, counted from
the filter words (``CompressedPlanes.split_bytes``), and the dot reads
those words, which the store would give back byte for byte (or, on the
rows route, the rows they were packed from).  Integrity
plans and active fault scopes (``core/faults.py``) take the checked path
(:func:`_checked_passes`): all passes are verified at once against their
ABFT checksums, then walked in the reference's order so that fault draws,
retries, quarantines and every counter equal the reference's serial loop;
only a pass a fault hits runs again on its own.

The ``walk`` backend elides zero-operand words and dead planes as the
reference's ``host`` walk does, and ``ConvStats.engine_words_*`` and
``bitserial.SKIP_STATS`` count that elision as the reference's one call per
plan tile would (:func:`_tile_skip_counts`, reckoned from the tiles' word
grids), while the layer still runs in one call.  ``gemm`` elides nothing
and counts nothing on its native path.
"""
from __future__ import annotations

import dataclasses
from contextlib import nullcontext
from typing import Sequence

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core import backends as _backends
from repro_torch.core import bitserial as bs
from repro_torch.core import faults
from repro_torch.core import quantize as q
from repro_torch.core import schedule as sched
from repro_torch.core.cache_geometry import CacheGeometry, XEON_E5_35MB
from repro_torch.core.mapper import LayerSpec

__all__ = [
    "nc_dot",
    "nc_conv2d",
    "nc_maxpool2d",
    "nc_avgpool2d",
    "nc_minmax",
    "minmax_walk",
    "nc_relu_requant",
    "nc_fc",
    "ConvStats",
]


@dataclasses.dataclass(frozen=True)
class ConvStats:
    """Per-layer emulation accounting (fields as in the reference).

    ``engine_words_*`` count the word columns the ``walk`` backend's
    multiplier saw and elided (``bitserial.SKIP_STATS``), per plan tile as
    the reference's ``host`` counts them; ``gemm``'s native path leaves
    them 0."""

    lanes: int  # B*E*F*M*K MAC lanes
    zero_operand_lanes: int  # lanes a tag latch could predicate off
    tiles: int
    tile_pixels: int  # (image, pixel) rows per tile
    tile_filters: int
    serial_passes: int  # mapper's modeled pass count for the layer (per image)
    engine_words_total: int  # word columns the walk's multiplier saw
    engine_words_skipped: int  # word columns elided (all-zero operand)
    batch: int = 1
    filter_loads: int = 1  # times the filter word grid was packed (§VI-C)
    zero_filters: int = 0  # all-zero filters the sparse plan pruned
    skipped_passes: int = 0  # serialized passes the plan dropped (per image)
    overlap: bool = False  # the plan granted §IV-E double buffering
    integrity: bool = False
    verify_passes: int = 0
    reexec_passes: int = 0
    faults_detected: int = 0
    integrity_cycles: int = 0
    reexec_cycles: int = 0
    quarantined_slices: tuple = ()
    compressed: bool = False
    csr_payload_bytes: int = 0
    csr_index_bytes: int = 0
    plan: object = dataclasses.field(default=None, compare=False, repr=False)


def nc_dot(x_q: torch.Tensor, w_q: torch.Tensor, acc_bits: int = 24,
           n_bits: int = 8, *, engine: str | None = None):
    """Quantized dot products, one per bit-line group: ``x_q``/``w_q``
    ``[..., K]`` unsigned integers of the same shape; each lane does one
    ``n_bits`` MAC into an ``acc_bits`` partial sum and the lanes reduce
    through the in-array log tree.  Returns ``(int64 values [...],
    cycles)``, exact.  Both operands are packed row-aligned and go through
    one ``packed_dot_words`` call on ``engine`` (``None``: the backend
    precedence, default ``gemm``)."""
    K = x_q.shape[-1]
    P, wpr, r = bs._row_layout(K)
    xw = bs.pack_values(x_q, n_bits, row_align=True).words
    ww = bs.pack_values(w_q.to(x_q.device), n_bits, row_align=True).words
    if r == 1:
        xw = xw.reshape(n_bits, -1, wpr)
        ww = ww.reshape(n_bits, -1, wpr)
    vals, cycles = bs.packed_dot_words(xw, ww, K=K, acc_bits=acc_bits,
                                       engine=engine)
    n_rows = bs._numel(tuple(x_q.shape[:-1]))
    return vals.reshape(-1)[:n_rows].reshape(x_q.shape[:-1]), cycles


def nc_relu_requant(acc: torch.Tensor, real_multiplier: float,
                    out_zp: int = 0) -> torch.Tensor:
    """ReLU on the int32 accumulator, then the fixed-point requantization to
    uint8: the in-cache epilogue of every conv layer (the multiplier taken
    as float32, as the reference)."""
    acc = torch.clamp_min(acc, 0)  # MSB-masked zero write
    m, s = q.fixed_point_multiplier(q.f32(real_multiplier))
    return q.requantize_fixedpoint(acc, m, s,
                                   zero_point=out_zp).to(torch.uint8)


def _as_qp_list(qp, B: int) -> list[q.QuantParams]:
    """Normalize a QuantParams-or-per-image-sequence to a length-B list."""
    if isinstance(qp, q.QuantParams):
        return [qp] * B
    qps = list(qp)
    if len(qps) != B:
        raise ValueError(f"got {len(qps)} per-image QuantParams for batch {B}")
    if any(p.bits != qps[0].bits for p in qps):
        raise ValueError("per-image QuantParams must share a bit width")
    return qps


def _quantize_images(x4: torch.Tensor, qps: list[q.QuantParams]) -> torch.Tensor:
    """Per-image quantize of ``[B, H, W, C]``; integer inputs are already
    quantized (the resident-uint8 pipeline) and pass through."""
    if not torch.is_floating_point(x4):
        return x4.to(torch.int64)
    dev = x4.device
    scales = torch.tensor([p.scale for p in qps], dtype=torch.float32,
                          device=dev)
    zps = torch.tensor([int(p.zero_point) for p in qps], dtype=torch.int64,
                       device=dev)
    vals = torch.round(x4.to(torch.float32) / scales[:, None, None, None])
    vals = vals.to(torch.int64) + zps[:, None, None, None]
    return torch.clamp(vals, qps[0].qmin, qps[0].qmax)


def _same_pad(h: int, r: int, stride: int) -> tuple[int, int]:
    """TF SAME convention: total pad so out = ceil(h/stride); extra padding
    goes after (bottom/right)."""
    out = -(-h // stride)
    total = max((out - 1) * stride + r - h, 0)
    return total // 2, total - total // 2


def _extract_windows_batch(x4: torch.Tensor, R: int, S: int, stride: int):
    """[B, H, W, C] -> ([B, E, F, R*S*C] window tensor, E, F) (VALID)."""
    B, H, W, C = x4.shape
    E = (H - R) // stride + 1
    F = (W - S) // stride + 1
    dev = x4.device
    rows = (torch.arange(E, device=dev)[:, None] * stride
            + torch.arange(R, device=dev)[None, :])  # (E, R)
    cols = (torch.arange(F, device=dev)[:, None] * stride
            + torch.arange(S, device=dev)[None, :])  # (F, S)
    win = x4[:, rows][:, :, :, cols]  # (B, E, R, F, S, C)
    return (win.permute(0, 1, 3, 2, 4, 5).reshape(B, E, F, R * S * C),
            E, F)


def _pack_x_rows(rows: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Window rows (T, K) -> broadcastable word grid (n, 1, ...) shared by
    every filter."""
    K = rows.shape[-1]
    P, wpr, r = bs._row_layout(K)
    w = bs.pack_values(rows, n_bits, row_align=True).words
    if r == 1:
        return w.reshape(n_bits, 1, rows.shape[0], wpr)
    return w.reshape(n_bits, 1, -1)  # (n, 1, ceil(T/r)) — rows share words


def _pack_w_rows(rows: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Filter rows (M, K) -> broadcastable word grid (n, M, 1[, wpr]).

    For P < 32 each word of the dot grid holds 32/P pixel rows of one
    filter, so the filter's P-bit pattern is replicated across the word
    (the product is truncated to 32 bits, as the reference's uint32 cast)."""
    K = rows.shape[-1]
    P, wpr, r = bs._row_layout(K)
    if r == 1:
        w = bs.pack_values(rows, n_bits, row_align=True).words
        return w.reshape(n_bits, rows.shape[0], 1, wpr)
    rep = sum(1 << (j * P) for j in range(r))
    ks = torch.arange(K, dtype=torch.int64, device=rows.device)
    rows = rows.to(torch.int64)
    out = torch.stack([((((rows >> p) & 1) << ks).sum(dim=1) * rep)
                       & 0xFFFFFFFF for p in range(n_bits)])
    return out[:, :, None]


def _dot_rows(win_flat: torch.Tensor, w_rows: torch.Tensor,
              ww: torch.Tensor | None, *, x_bits: int, w_bits: int, K: int,
              acc_bits: int, engine: str) -> torch.Tensor:
    """All (row, filter) dots of a layer: ``[rows, M]`` int64 of the window
    rows ``win_flat`` and filter rows ``w_rows``.

    ``ww`` None is the rows route: one bit-serial GEMM on the rows' low
    ``x_bits``/``w_bits`` bits (``backends._gemm_dot_rows``).  Otherwise
    the word route, through the filter word grid ``ww`` (``_pack_w_rows``'s
    layout) in one ``packed_dot_words`` call unless the backend caps its
    grid.  On the card, where both routes run, the ``dot`` span is
    annotated with its ``route`` and counts the rows fed (``dot.rows``)."""
    T, M = win_flat.shape[0], w_rows.shape[0]
    if ww is None:
        with tracing.span("dot"):
            tracing.annotate("route", "rows")
            tracing.count("dot.rows", T)
            return _backends._gemm_dot_rows(win_flat, w_rows, x_bits, w_bits)
    P, wpr, r = bs._row_layout(K)
    cap = _backends.get_backend(engine).max_grid_words
    chunk = T
    if cap is not None:
        per_row = M * (wpr if r == 1 else 1.0 / r)
        chunk = max(r, int(cap // max(per_row, 1)) // r * r)
    out = torch.empty((T, M), dtype=torch.int64, device=win_flat.device)
    for t0 in range(0, T, chunk):
        t1 = min(t0 + chunk, T)
        with tracing.span("layer.pack"):
            xw = _pack_x_rows(win_flat[t0:t1], x_bits)
        with tracing.span("dot"):
            if win_flat.is_cuda:
                tracing.annotate("route", "words")
                tracing.count("dot.rows", t1 - t0)
            vals, _ = bs.packed_dot_words(xw, ww, K=K, acc_bits=acc_bits,
                                          engine=engine)
        out[t0:t1] = vals.reshape(M, -1)[:, : t1 - t0].t()
    return out


def _tile_skip_counts(win_flat: torch.Tensor, ww: torch.Tensor, *,
                      x_bits: int, K: int, tile_rows: int, tile_filters: int,
                      counted: np.ndarray) -> bs.SkipStats:
    """``SKIP_STATS`` as the reference's ``host`` walk counts a layer: one
    ``_mul_words`` call per plan tile, multiplying the tile's window-row
    words ``_pack_x_rows(win_flat[p0:p1])`` by its filter columns
    ``ww[:, m0:m1]``, for the tiles ``counted`` (``[row tiles, filter
    tiles]`` bool) marks.

    Reckoned from the word grids rather than by running the tiles: a
    tile's word column is live when the OR over its planes of the window
    word ANDed with that of the filter word is non-zero; the set lanes of
    those ANDs sum per reduce lane ``k`` as (rows with ``x[., k] != 0``) x
    (filters with ``w[., k] != 0``); a tile gathers its live columns when
    fewer than ``n - n // 8`` of its ``n`` columns live, and a multiplier
    plane is skipped when no (gathered) column of it is non-zero."""
    dev = win_flat.device
    T, M, nb = win_flat.shape[0], ww.shape[1], ww.shape[0]
    P, wpr, r = bs._row_layout(K)
    W = wpr if r == 1 else 1  # word positions a row's lanes span
    n_pt, n_mt = -(-T // tile_rows), -(-M // tile_filters)
    row_tile = torch.arange(T, device=dev) // tile_rows
    col_tile = torch.arange(M, device=dev) // tile_filters
    rows_in = torch.bincount(row_tile, minlength=n_pt)
    cols_in = torch.bincount(col_tile, minlength=n_mt)
    xnz = (win_flat.to(torch.int64) & ((1 << x_bits) - 1)) != 0  # (T, K)
    if r == 1:
        nzx = bs.pack_lanes(xnz[None], row_align=True).words[0].reshape(-1)
        g_tile = row_tile.repeat_interleave(wpr)
        wpos = torch.arange(T * wpr, device=dev) % wpr
        words_in = rows_in * wpr
    else:
        # rows share words tile by tile: row p0 + j*r + i sits in slot i of
        # the tile's word j
        seg = (xnz.to(torch.int64)
               << torch.arange(K, device=dev)).sum(dim=1)
        local = torch.arange(T, device=dev) % tile_rows
        words_in = -(-rows_in // r)
        start = torch.cumsum(words_in, 0) - words_in
        g = start[row_tile] + local // r
        nzx = torch.zeros(int(words_in.sum()), dtype=torch.int64,
                          device=dev).index_add_(
            0, g, seg << ((local % r) * P))
        g_tile = torch.repeat_interleave(
            torch.arange(n_pt, device=dev), words_in)
        wpos = torch.zeros_like(g_tile)
    wplanes = ww.reshape(nb, M, W)
    nzw = bs._nonzero_word(wplanes)  # (M, W)
    live_cnt = torch.zeros((M, n_pt), dtype=torch.int64, device=dev)
    live_at = torch.zeros((M, n_pt * W), dtype=torch.int64, device=dev)
    G = nzx.shape[0]
    step = max(1, (1 << 22) // max(M, 1))
    for g0 in range(0, G, step):
        sl = slice(g0, min(g0 + step, G))
        act = ((nzx[None, sl] & nzw[:, wpos[sl]]) != 0).to(torch.int64)
        live_cnt.index_add_(1, g_tile[sl], act)
        live_at.index_add_(1, g_tile[sl] * W + wpos[sl], act)
    live = torch.zeros((n_mt, n_pt), dtype=torch.int64,
                       device=dev).index_add_(0, col_tile, live_cnt).t()
    n_words = words_in[:, None] * cols_in[None, :]  # (n_pt, n_mt)
    # set lanes of the live ANDs, per tile (exact in float64: < 2^53)
    cx = torch.zeros((n_pt, K), dtype=torch.float64, device=dev).index_add_(
        0, row_tile, xnz.to(torch.float64))
    w_lanes = bs._unpack_bits32(nzw).reshape(M, -1)[:, :K] if r == 1 else (
        (nzw[:, 0, None] >> torch.arange(K, device=dev)) & 1)
    cw = torch.zeros((n_mt, K), dtype=torch.float64, device=dev).index_add_(
        0, col_tile, w_lanes.to(torch.float64))
    lanes_set = (cx @ cw.t()).to(torch.int64)
    # dead multiplier planes: over the tile's filter words (dense), or over
    # the filter words of its live columns (gathered)
    plane_nz = wplanes != 0  # (nb, M, W)
    dense_live = torch.zeros((nb, n_mt), dtype=torch.int64,
                             device=dev).index_add_(
        1, col_tile, plane_nz.any(dim=2).to(torch.int64)) > 0
    live_at = (live_at > 0).reshape(M, n_pt, W)
    gath_live = torch.stack([
        torch.zeros((n_mt, n_pt), dtype=torch.int64, device=dev).index_add_(
            0, col_tile, (plane_nz[j][:, None, :] & live_at).any(dim=2)
            .to(torch.int64)) > 0
        for j in range(nb)]).permute(0, 2, 1)  # (nb, n_pt, n_mt)
    out = bs.SkipStats()
    c = torch.as_tensor(counted, device=dev)
    if bs.ZERO_SKIP:
        seen = c & (n_words > 1)
        gathered = seen & (live < n_words - n_words // 8)
        dead = torch.where(gathered, nb - gath_live.sum(dim=0),
                           nb - dense_live.sum(dim=0)[None, :])
        words_seen = int(n_words[seen].sum())
        out.words_total = words_seen
        out.lanes_total = words_seen * bs._WORD
        out.lanes_zero = words_seen * bs._WORD - int(lanes_set[seen].sum())
        out.words_skipped = int((n_words - live)[gathered].sum())
        out.planes_skipped = int(dead[c].sum())
    out.planes_total = nb * int(c.sum())
    return out


def _checked_passes(vals: torch.Tensor, win_flat: torch.Tensor,
                    w_rows: torch.Tensor, ww_all: torch.Tensor, *,
                    p_tiles, m_tiles, tile_rows: int, tile_filters: int,
                    x_bits: int, K: int, acc_bits: int, engine: str,
                    per_dot: int, integrity_on: bool, fs, spec, geom, B: int,
                    plan):
    """The checked path: every planned pass, in the reference's order, under
    ABFT verification and/or fault injection.

    ``vals`` (``[rows, live filters]``) holds the layer's clean dots from one
    call; this verifies every pass at once against its checksum references
    (per-pass column and row sums) and then walks the passes serially as
    the reference does: the fault draws, retries, quarantine and re-plan
    happen pass by pass, but a pass whose operands and values nothing
    corrupted reads its slice of ``vals`` and its bulk verdict.  A pass
    that a fault hits runs alone through ``packed_dot_words`` (the
    corrupted execution and every re-execution), is verified on its own
    and writes its final values back into ``vals``.  Returns the counters,
    the effective plan and ``bulk`` (``[row tiles, filter tiles]`` bool):
    the passes whose first execution is the clean one call's."""
    dev = vals.device
    rows_total, M_live = vals.shape
    P_lay, _, r_lay = bs._row_layout(K)
    n_pt, n_mt = len(p_tiles), len(m_tiles)
    row_tile = torch.arange(rows_total, device=dev) // tile_rows
    col_tile = torch.arange(M_live, device=dev) // tile_filters
    x64 = win_flat.to(torch.int64)
    w64 = w_rows.to(torch.int64)
    wsum = torch.zeros((n_mt, K), dtype=torch.int64, device=dev).index_add_(
        0, col_tile, w64)
    # live lanes: where an activation-side flip meets a nonzero filter of
    # the pass, and where a filter-side flip meets a nonzero window row
    # riding bit slot 0 (the replica the injector flips when rows share
    # words)
    lanes_a_mask = (wsum > 0).cpu().numpy()
    slot0 = (torch.arange(rows_total, device=dev) % tile_rows) % r_lay == 0
    xsum0 = torch.zeros((n_pt, K), dtype=torch.int64, device=dev).index_add_(
        0, row_tile[slot0], x64[slot0])
    lanes_f_mask = (xsum0 > 0).cpu().numpy()
    if integrity_on:
        # the checksum references of every pass (bs.abft_checksums per
        # pass, in two float64 products; exact, see there) against the
        # observed column and row sums of the clean dots
        xsum = torch.zeros((n_pt, K), dtype=torch.int64,
                           device=dev).index_add_(0, row_tile, x64)
        col_ref = (win_flat.to(torch.float64)
                   @ wsum.t().to(torch.float64)).to(torch.int64)
        row_ref = (xsum.to(torch.float64)
                   @ w64.t().to(torch.float64)).to(torch.int64)
        col_obs = torch.zeros((rows_total, n_mt), dtype=torch.int64,
                              device=dev).index_add_(1, col_tile, vals)
        row_obs = torch.zeros((n_pt, M_live), dtype=torch.int64,
                              device=dev).index_add_(0, row_tile, vals)
        bad = torch.zeros((n_pt, n_mt), dtype=torch.int64, device=dev)
        bad.index_add_(0, row_tile, (col_obs != col_ref).to(torch.int64))
        bad.index_add_(1, col_tile, (row_obs != row_ref).to(torch.int64))
        bad = (bad > 0).cpu().numpy()
    lanes_f: dict = {}
    lanes_a: dict = {}
    x_cache: dict = {}

    def _x_tile(pi: int) -> torch.Tensor:
        xw = x_cache.get(pi)
        if xw is None:
            x_cache.clear()  # row tiles behind the walk are done
            p0, p1 = p_tiles[pi]
            xw = x_cache[pi] = _pack_x_rows(win_flat[p0:p1], x_bits)
        return xw

    def _lanes(cache, mask, i):
        got = cache.get(i)
        if got is None:
            got = cache[i] = np.flatnonzero(mask[i])
        return got

    n_tiles = verify_passes = reexec_passes = faults_detected = 0
    integrity_cycles = reexec_cycles = 0
    eff_plan = plan
    first_bulk = np.zeros((n_pt, n_mt), bool)
    max_retries = fs.profile.max_retries if fs is not None else 1
    t = -1
    for pi in range(n_pt):
        p0, p1 = p_tiles[pi]
        for mi in range(n_mt):
            t += 1
            m0, m1 = m_tiles[mi]
            bulk = vals[p0:p1, m0:m1].t()  # (filters, rows), as the engine
            attempts = execs = quarantine_rounds = 0
            while True:
                execs += 1
                xw = _x_tile(pi)
                ww = ww_all[:, m0:m1]
                corrupted = False
                if fs is not None:
                    fs.maybe_stall(spec.name, t)
                    ww2 = fs.corrupt_filter_words(
                        ww, spec.name, t,
                        lanes=_lanes(lanes_f, lanes_f_mask, pi),
                        filters=m1 - m0, P=P_lay, r=r_lay)
                    xw2 = fs.corrupt_act_words(
                        xw, spec.name, t,
                        lanes=_lanes(lanes_a, lanes_a_mask, mi),
                        rows=p1 - p0, P=P_lay, r=r_lay)
                    corrupted = ww2 is not ww or xw2 is not xw
                    xw, ww = xw2, ww2
                if corrupted or execs > 1:
                    out, _ = bs.packed_dot_words(xw, ww, K=K,
                                                 acc_bits=acc_bits,
                                                 engine=engine)
                    v2 = out[: m1 - m0, : p1 - p0]
                else:
                    v2 = bulk
                    first_bulk[pi, mi] = True
                if fs is not None:
                    v3 = fs.corrupt_values(v2, spec.name, t,
                                           filters=m1 - m0, rows=p1 - p0)
                    corrupted = corrupted or v3 is not v2
                    v2 = v3
                    if corrupted:
                        fs.note_corrupt_attempt()
                if execs == 1:
                    n_tiles += 1
                else:
                    reexec_passes += 1
                    reexec_cycles += per_dot * (p1 - p0) * (m1 - m0)
                    if fs is not None:
                        fs.note_reexecution()
                if not integrity_on:
                    break  # faults without checking: corruption flows through
                verify_passes += 1
                integrity_cycles += per_dot * ((p1 - p0) + (m1 - m0))
                if v2 is bulk:
                    ok = not bad[pi, mi]
                else:
                    ok = (bool((v2.sum(dim=0) == col_ref[p0:p1, mi]).all())
                          and bool((v2.sum(dim=1)
                                    == row_ref[pi, m0:m1]).all()))
                if ok:
                    break
                faults_detected += 1
                if fs is not None:
                    fs.note_detected()
                attempts += 1
                if attempts <= max_retries:
                    continue
                # retry budget exhausted: only a persistent (stuck-at) fault
                # survives clean re-execution, so quarantine the pass's
                # slice, re-plan over the survivors and grant one fresh
                # budget; unrecoverable passes raise
                sid = fs.slice_for(spec.name, t) if fs is not None else None
                can_quarantine = (
                    fs is not None and sid is not None
                    and sid not in fs.quarantined
                    and len(fs.quarantined) < geom.n_slices - 1
                    and quarantine_rounds < geom.n_slices)
                if not can_quarantine:
                    raise faults.IntegrityError(spec.name, t, attempts)
                fs.quarantine(sid)
                quarantine_rounds += 1
                eff_plan = sched.plan_layer(
                    spec, geom, batch=B, tile_pixels=tile_rows,
                    tile_filters=tile_filters, occupancy=plan.occupancy,
                    overlap=plan.overlap, integrity=True,
                    quarantined_slices=tuple(sorted(fs.quarantined)),
                    compressed=plan.compressed)
                attempts = 0
            if v2 is not bulk:
                vals[p0:p1, m0:m1] = v2.t()
    return dict(tiles=n_tiles, verify_passes=verify_passes,
                reexec_passes=reexec_passes, faults_detected=faults_detected,
                integrity_cycles=integrity_cycles,
                reexec_cycles=reexec_cycles, plan=eff_plan, bulk=first_bulk)


def nc_conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    x_qp: q.QuantParams | Sequence[q.QuantParams],
    w_qp: q.QuantParams,
    stride: int = 1,
    *,
    padding: str = "VALID",
    tile_pixels: int | None = None,
    tile_filters: int | None = None,
    geom: CacheGeometry = XEON_E5_35MB,
    layer_spec: LayerSpec | None = None,
    plan: sched.SlicePlan | None = None,
    occupancy: sched.LayerOccupancy | str | None = None,
    engine: str | None = None,
    overlap: bool = False,
    integrity: bool = False,
    compressed: bool = False,
    return_stats: bool = False,
):
    """Quantized conv through the array model, on ``x``'s device.

    ``x``: ``[H, W, C]`` or ``[B, H, W, C]`` float (quantized here with
    ``x_qp``, per image when it is a sequence) or integer (already
    quantized); ``w``: ``[R, S, C, M]`` float or integer.  Returns the int32
    staging accumulator ``[B?, E, F, M]`` and the modeled cycles (plus a
    :class:`ConvStats` with ``return_stats=True``), equal to the reference.

    Plans, sparsity (``occupancy``: pruned filters are filled from the
    affine identity ``zw * sum(x)``), overlap, integrity, compression and
    the backend pin follow the reference's rules and precedence (explicit
    ``engine=`` > the plan's ``backend`` > ``NC_TORCH_BACKEND`` > ``gemm``).
    Under ``integrity`` every pass is verified against its ABFT checksums;
    detected corruption is re-executed, and under an active fault scope a
    stuck slice is quarantined and the layer re-planned (``ConvStats.plan``
    is then the effective plan); an unrecoverable pass raises
    :class:`~repro_torch.core.faults.IntegrityError`."""
    batched = x.ndim == 4
    x4 = x if batched else x[None]
    dev = x4.device
    B = x4.shape[0]
    x_qps = _as_qp_list(x_qp, B)
    # operands: the filters' copy to the device, quantization, im2col
    with tracing.span("layer.pack"):
        if w.device != dev:
            w = tracing.fetch(w.to, dev)
        wq = (q.quantize(w, w_qp) if torch.is_floating_point(w)
              else w).to(torch.int64)
        xq = _quantize_images(x4, x_qps)
        R, S, Cw, M = wq.shape
        if xq.shape[3] != Cw:
            raise ValueError(f"input has {xq.shape[3]} channels, "
                             f"filters {Cw}")
        zxs = tracing.fetch(torch.tensor, [int(p.zero_point) for p in x_qps],
                            dtype=torch.int64, device=dev)
        if padding == "SAME":
            ph = _same_pad(xq.shape[1], R, stride)
            pw = _same_pad(xq.shape[2], S, stride)
            padded = zxs[:, None, None, None].expand(
                B, xq.shape[1] + sum(ph), xq.shape[2] + sum(pw), Cw).clone()
            padded[:, ph[0]:ph[0] + xq.shape[1],
                   pw[0]:pw[0] + xq.shape[2]] = xq
            xq = padded
        elif padding != "VALID":
            raise ValueError(f"padding must be VALID or SAME, got "
                             f"{padding!r}")
        H = xq.shape[1]
        n_bits = max(x_qps[0].bits, w_qp.bits)
        # engine operands are the low bytes (the reference's uint8 cast); the
        # affine correction below reads the windows' true (signed) values
        small = torch.uint8 if n_bits <= 8 else torch.int64
        win, E, F = _extract_windows_batch(
            xq if x_qps[0].signed else xq.to(small), R, S, stride)
        K = R * S * Cw
        acc_bits = 32

        spec = layer_spec or LayerSpec(
            name="nc_conv2d", kind="conv", H=H, R=R, S=S, C=Cw, M=M, E=E,
            stride=stride)
        rows_total = B * E * F
        win_flat = win.reshape(rows_total, K).to(small)
        w_rows = wq.reshape(K, M).t().to(small)
    zw_int = int(w_qp.zero_point)
    replan = plan is None or tile_pixels is not None or tile_filters is not None
    if occupancy is not None and not replan:
        raise ValueError("pass sparsity through the plan's occupancy, or "
                         "let nc_conv2d plan (occupancy= with an explicit "
                         "plan is ambiguous)")
    if overlap and not replan:
        raise ValueError("request overlap through the plan "
                         "(plan_layer(..., overlap=True)); overlap= with "
                         "an explicit plan is ambiguous")
    if integrity and not replan:
        raise ValueError("request integrity through the plan "
                         "(plan_layer(..., integrity=True)); integrity= "
                         "with an explicit plan is ambiguous")
    if compressed and not replan:
        raise ValueError("request compression through the plan "
                         "(plan_layer(..., compressed=True)); compressed= "
                         "with an explicit plan is ambiguous")
    if (engine is not None and plan is not None
            and plan.backend not in (None, engine)):
        raise ValueError("pick the backend through the plan "
                         "(plan_layer(..., backend=...)); engine= "
                         "contradicting a backend-carrying plan is "
                         "ambiguous")
    if replan:
        occ = occupancy
        if isinstance(occ, str):
            if occ != "detect":
                raise ValueError(f"occupancy must be a LayerOccupancy, "
                                 f"'detect' or None, got {occ!r}")
            occ = sched.LayerOccupancy.from_filter_rows(
                w_rows, w_qp.bits, zw_int)
        quarantined: tuple = ()
        backend_pin: str | None = None
        if plan is not None:
            if occ is None:
                occ = plan.occupancy
            overlap = overlap or plan.overlap
            integrity = integrity or plan.integrity
            compressed = compressed or plan.compressed
            backend_pin = plan.backend
            quarantined = plan.quarantined_slices
        plan = sched.plan_layer(spec, geom, batch=B, tile_pixels=tile_pixels,
                                tile_filters=tile_filters, occupancy=occ,
                                overlap=overlap, integrity=integrity,
                                quarantined_slices=quarantined,
                                compressed=compressed, backend=backend_pin)
    engine = _backends.resolve_backend(engine, plan.backend)
    tile_rows = max(1, min(plan.tile_rows, rows_total))
    tile_filters = max(1, min(plan.tile_filters, M))

    # the live filters: zero filters found and gathered out
    with tracing.span("layer.pack"):
        occ = plan.occupancy
        if occ is not None and occ.zero_filters:
            if occ.total_filters != M:
                raise ValueError(f"{spec.name}: occupancy covers "
                                 f"{occ.total_filters} filters, layer has {M}")
            zero_idx = tracing.fetch(torch.tensor, occ.zero_filters,
                                     dtype=torch.int64, device=dev)
            not_zero = ~(w_rows[zero_idx] == zw_int).all(dim=1)
            if tracing.fetch(bool, not_zero.any()):
                raise ValueError(
                    f"{spec.name}: occupancy marks filters "
                    f"{zero_idx[not_zero].tolist()} as zero but their weights "
                    f"are live (stale plan?)")
            zero_mask = torch.zeros(M, dtype=torch.bool, device=dev)
            # the scalar store copies its True from the host
            tracing.fetch(zero_mask.__setitem__, zero_idx, True)
            live_idx = tracing.fetch(torch.nonzero, ~zero_mask).flatten()
        else:
            zero_mask = live_idx = None

        w_rows_live = w_rows if live_idx is None else w_rows[live_idx]
    M_live = w_rows_live.shape[0]
    per_dot = bs.dot_cycles(K, n_bits, acc_bits)
    overlap_exec = bool(plan.overlap)
    compressed_exec = bool(plan.compressed)
    fs = faults.active()
    integrity_on = bool(plan.integrity)
    checked = integrity_on or fs is not None
    # the rows route: where nothing reads the words but the dot
    rows_route = (dev.type == "cuda" and engine == "gemm" and not checked
                  and _backends._gemm_operand_reason(
                      x_qps[0].bits, w_qp.bits, K=K,
                      acc_bits=acc_bits) is None)
    words0 = (bs.SKIP_STATS.words_total, bs.SKIP_STATS.words_skipped)
    p_tiles = ([(p0, min(p0 + tile_rows, rows_total))
                for p0 in range(0, rows_total, tile_rows)] if M_live else [])
    m_tiles = [(m0, min(m0 + tile_filters, M_live))
               for m0 in range(0, M_live, tile_filters)]
    out = torch.empty((rows_total, M), dtype=torch.int64, device=dev)
    csr_bytes = (0, 0)  # measured (payload, index) bytes of the CSR store
    run = dict(tiles=0, verify_passes=0, reexec_passes=0, faults_detected=0,
               integrity_cycles=0, reexec_cycles=0, plan=plan)
    if M_live:
        ww_all = None
        with tracing.span("layer.pack"):
            # filters packed once per layer per batch, where the words are
            # read: the word route's dot, the checked passes, the walk's
            # skip counts and the CSR store's bytes
            if not rows_route or compressed_exec:
                ww_all = _pack_w_rows(w_rows_live, w_qp.bits)
            if compressed_exec:
                # the CSR-per-bit-plane store's bytes, counted from the words
                # the dot reads (its reconstruction is those words): one
                # store for a serial plan, one per pass's filter columns for
                # an overlap plan, as the reference reports them
                csr_bytes = bs.CompressedPlanes.split_bytes(
                    ww_all, m_tiles if overlap_exec else [(0, M_live)])
        walk = engine == "walk"
        # the walk's own per-call counts are replaced by the per-tile ones
        with bs.counts_into(bs.SkipStats()) if walk else nullcontext():
            vals = _dot_rows(win_flat, w_rows_live,
                             None if rows_route else ww_all,
                             x_bits=x_qps[0].bits, w_bits=w_qp.bits, K=K,
                             acc_bits=acc_bits, engine=engine)
        if checked:
            run = _checked_passes(
                vals, win_flat, w_rows_live, ww_all, p_tiles=p_tiles,
                m_tiles=m_tiles, tile_rows=tile_rows,
                tile_filters=tile_filters, x_bits=x_qps[0].bits, K=K,
                acc_bits=acc_bits, engine=engine, per_dot=per_dot,
                integrity_on=integrity_on, fs=fs, spec=spec, geom=geom, B=B,
                plan=plan)
        else:
            # the plan's tiles, reported as planned; executed as one call
            run["tiles"] = len(p_tiles) * len(m_tiles)
            run["bulk"] = np.ones((len(p_tiles), len(m_tiles)), bool)
        if walk:
            bs.SKIP_STATS.add(_tile_skip_counts(
                win_flat, ww_all, x_bits=x_qps[0].bits, K=K,
                tile_rows=tile_rows, tile_filters=tile_filters,
                counted=run["bulk"]))
        if live_idx is None:
            out = vals
        else:
            out[:, live_idx] = vals
    total_cycles = per_dot * rows_total * M_live
    # checksum verifications and re-executed passes charge the same §III
    # formulas as the real work: an additive term, zero when unchecked
    total_cycles += run["integrity_cycles"] + run["reexec_cycles"]
    with tracing.span("layer.correct"):
        if zero_mask is not None:
            # pruned passes: an all-zero filter's dot is the affine constant
            # zw * sum_k(x_k) — exact, no engine lanes clocked for it.  The
            # boolean-mask store reads the mask's count to the host
            row_sums = win_flat.sum(dim=1, dtype=torch.int64)
            tracing.fetch(out.__setitem__, (slice(None), zero_mask),
                          zw_int * row_sums[:, None])

        # affine zero-point correction (exact integer identity, per image)
        sx = win.sum(dim=-1, dtype=torch.int64)  # (B, E, F)
        sw = wq.sum(dim=(0, 1, 2))  # (M,)
        zx = zxs[:, None, None, None]
        acc = (out.reshape(B, E, F, M) - zw_int * sx[..., None]
               - zx * sw[None, None, None, :] + K * zx * zw_int)
        result = (acc if batched else acc[0]).to(torch.int32)
        if not return_stats:
            return result, total_cycles
        # separable zero-operand count: sum_k nnz(windows_k) * nnz(w_k)
        cx = (win_flat != 0).sum(dim=0, dtype=torch.int64)
        cw = (w_rows != 0).sum(dim=0, dtype=torch.int64)
        live = tracing.fetch(int, (cx * cw).sum())
    eff_plan = run["plan"]
    stats = ConvStats(
        lanes=rows_total * M * K,
        zero_operand_lanes=rows_total * M * K - live,
        tiles=run["tiles"],
        tile_pixels=tile_rows,
        tile_filters=tile_filters,
        serial_passes=eff_plan.serial_passes,
        engine_words_total=bs.SKIP_STATS.words_total - words0[0],
        engine_words_skipped=bs.SKIP_STATS.words_skipped - words0[1],
        batch=B,
        filter_loads=1,
        zero_filters=M - M_live,
        skipped_passes=eff_plan.skipped_passes,
        overlap=overlap_exec and not checked,  # checked passes run serially
        integrity=integrity_on,
        verify_passes=run["verify_passes"],
        reexec_passes=run["reexec_passes"],
        faults_detected=run["faults_detected"],
        integrity_cycles=run["integrity_cycles"],
        reexec_cycles=run["reexec_cycles"],
        quarantined_slices=eff_plan.quarantined_slices,
        compressed=compressed_exec,
        csr_payload_bytes=csr_bytes[0],
        csr_index_bytes=csr_bytes[1],
        plan=eff_plan,
    )
    return result, total_cycles, stats


def nc_maxpool2d(x_q: torch.Tensor, window: int, stride: int,
                 padding: str = "VALID"):
    """uint8 max pooling via subtract + MSB-masked copies (§IV-D).
    Accepts ``[H, W, C]`` or ``[B, H, W, C]``; cycles are per pixel."""
    batched = x_q.ndim == 4
    xq = (x_q if batched else x_q[None]).to(torch.int64)
    if padding == "SAME":
        ph = _same_pad(xq.shape[1], window, stride)
        pw = _same_pad(xq.shape[2], window, stride)
        xq = torch.nn.functional.pad(xq, (0, 0) + pw + ph)  # uint8 min
    win, E, F = _extract_windows_batch(xq, window, window, stride)
    B, C = xq.shape[0], xq.shape[3]
    win = win.reshape(B, E, F, window * window, C)
    cur = bs.pack_values(win[:, :, :, 0], 8)
    cycles = 0
    for t in range(1, window * window):
        nxt = bs.pack_values(win[:, :, :, t], 8)
        cur, c = bs.bitserial_max(cur, nxt)
        cur = cur[:8]
        cycles += c * B * E * F
    out = bs.unpack_values(cur)  # (B, E, F, C)
    return (out if batched else out[0]).to(torch.uint8), cycles


def nc_avgpool2d(x_q: torch.Tensor, window: int, stride: int,
                 padding: str = "VALID"):
    """uint8 average pooling: in-array window sum via the §III-D log tree,
    then the §III-C bit-serial divide (rounded; SAME divides by the
    pad-excluded window population).  Cycles per output lane group: the
    widening sum tree plus one 8-bit divide."""
    batched = x_q.ndim == 4
    xq = (x_q if batched else x_q[None]).to(torch.int64)
    B, H, W, C = xq.shape
    ones = torch.ones((1, H, W, 1), dtype=torch.int64, device=xq.device)
    if padding == "SAME":
        ph = _same_pad(H, window, stride)
        pw = _same_pad(W, window, stride)
        xq = torch.nn.functional.pad(xq, (0, 0) + pw + ph)
        ones = torch.nn.functional.pad(ones, (0, 0) + pw + ph)
    win, E, F = _extract_windows_batch(xq, window, window, stride)
    w2 = window * window
    rows = win.reshape(B, E, F, w2, C).permute(0, 1, 2, 4, 3)  # (B,E,F,C,W2)
    pp = bs.pack_values(rows, 8, row_align=True)
    red, c_red = bs.bitserial_reduce(pp)
    sums = bs.unpack_values(red)[..., 0]  # (B, E, F, C)
    counts, _, _ = _extract_windows_batch(ones, window, window, stride)
    counts = counts.reshape(E, F, w2, 1).sum(dim=2)  # (E, F, 1)
    out = torch.div(sums + counts // 2, counts, rounding_mode="floor")
    cycles = int(B * E * F * (c_red + bs.div_cycles(8)))
    out = torch.clamp(out, 0, 255)
    return (out if batched else out[0]).to(torch.uint8), cycles


def minmax_walk(rows: torch.Tensor, bits: int,
                signed: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The bit-serial log tree of :func:`nc_minmax` in packed word space,
    on ``rows``' device: per row of int64 ``[rows, K]`` the min and max of
    the ``bits``-wide values, int64 ``[rows]``.  Rows are padded to the
    next power of two with copies of their first lane (neutral for both);
    ``signed`` biases two's complement values by ``2^(bits-1)`` on the way
    in and out.  The CPU's route, and the plain version of the card's
    kernel (``kernels.minmax_rows``)."""
    K = rows.shape[-1]
    bias = (1 << (bits - 1)) if signed else 0
    u = (rows + bias) & ((1 << bits) - 1)
    P = 1 << max(0, (K - 1).bit_length())
    padded = u[:, :1].expand(u.shape[0], P).clone()  # neutral pad
    padded[:, :K] = u
    pp = bs.pack_values(padded, bits, row_align=True)
    (mn_pp, mx_pp), _ = bs.bitserial_minmax(pp)
    return (bs.unpack_values(mn_pp).reshape(-1) - bias,
            bs.unpack_values(mx_pp).reshape(-1) - bias)


def nc_minmax(x_q: torch.Tensor, bits: int = 32, signed: bool = False):
    """§IV-D in-cache dynamic range: min AND max over the LAST axis of
    ``bits``-wide values, two's complement when ``signed``.  Returns
    ``(mins, maxs, cycles)`` shaped like the leading axes.

    On a CUDA tensor the values come from ``kernels.ops.minmax_rows``, one
    hand-written kernel that reads each value once; on a CPU tensor from
    :func:`minmax_walk`.  Both are exact, so the cycles are charged from
    the shape: the tree's halving steps over the last axis, plus 2 for the
    bias on the way in and out when ``signed``."""
    with tracing.span("minmax"):
        lead = tuple(x_q.shape[:-1])
        K = x_q.shape[-1] if x_q.ndim else 1
        rows = x_q.reshape(-1, K).to(torch.int64)
        with tracing.span("minmax.tree"):
            if rows.is_cuda:
                from repro_torch.kernels import ops

                tracing.annotate("route", "kernel")
                mn, mx = ops.minmax_rows(rows.contiguous(), bits, signed)
            else:
                mn, mx = minmax_walk(rows, bits, signed)
        cycles = bs.minmax_cycles(K, bits) + (2 if signed else 0)
        return mn.reshape(lead), mx.reshape(lead), cycles


def nc_fc(x: torch.Tensor, w: torch.Tensor,
          x_qp: q.QuantParams | Sequence[q.QuantParams],
          w_qp: q.QuantParams, **conv_kwargs):
    """FC as a 1x1 conv over a 1x1 image (§IV-D).  ``x``: ``[K]`` or
    batched ``[B, K]``; keyword arguments pass through to
    :func:`nc_conv2d`."""
    w4 = w[None, None, :, :]
    if x.ndim == 2:
        res = nc_conv2d(x[:, None, None, :], w4, x_qp, w_qp, **conv_kwargs)
        return (res[0][:, 0, 0],) + tuple(res[1:])
    res = nc_conv2d(x[None, None, :], w4, x_qp, w_qp, **conv_kwargs)
    return (res[0][0, 0],) + tuple(res[1:])
