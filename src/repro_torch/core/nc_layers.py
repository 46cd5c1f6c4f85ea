"""Functional execution of DNN layers through the bit-serial engine.

The port of ``repro.core.nc_layers``: each layer is computed the way the
cache would — uint8 operands, bit-plane transposed layout, tag-predicated
MACs, in-array log-tree reduction, fixed-point requantization — with every
tensor on the caller's device.  Outputs, cycles and :class:`ConvStats` equal
the reference's.

A conv runs all of its planned row and filter tiles in ONE
``packed_dot_words`` call over ``[rows_total, live filters]``: values do not
depend on tiling, and one launch per layer keeps the GPU busy where one
launch per planned tile would not.  The plan's tiles are still reported
(``ConvStats.tiles``/``tile_pixels``/``tile_filters``).  Only a backend with
a grid cap (``walk``) splits the rows into chunks.  Overlap plans execute
serially (results are byte-identical by the reference's own contract) and
report ``overlap`` as the reference does.  ABFT integrity and compressed
filter residency are not part of this package yet and raise.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core import backends as _backends
from repro_torch.core import bitserial as bs
from repro_torch.core import quantize as q
from repro_torch.core import schedule as sched
from repro_torch.core.cache_geometry import CacheGeometry, XEON_E5_35MB
from repro_torch.core.mapper import LayerSpec

__all__ = [
    "nc_conv2d",
    "nc_maxpool2d",
    "nc_avgpool2d",
    "nc_minmax",
    "nc_fc",
    "ConvStats",
]


@dataclasses.dataclass(frozen=True)
class ConvStats:
    """Per-layer emulation accounting (fields as in the reference).

    ``engine_words_*`` count the reference host walk's zero-word elision,
    which this package does not perform: they stay 0, as they do for the
    reference's compiled engine."""

    lanes: int  # B*E*F*M*K MAC lanes
    zero_operand_lanes: int  # lanes a tag latch could predicate off
    tiles: int
    tile_pixels: int  # (image, pixel) rows per tile
    tile_filters: int
    serial_passes: int  # mapper's modeled pass count for the layer (per image)
    engine_words_total: int
    engine_words_skipped: int
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


def _quantize_weights(w: torch.Tensor, qp: q.QuantParams) -> torch.Tensor:
    """float32 divide + round-half-even + clip, as int64."""
    vals = torch.round(w.to(torch.float32) / q.f32(qp.scale))
    vals = vals.to(torch.int64) + int(qp.zero_point)
    return torch.clamp(vals, qp.qmin, qp.qmax)


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


def _dot_rows(win_flat: torch.Tensor, w_rows: torch.Tensor, x_bits: int,
              w_bits: int, K: int, acc_bits: int, engine: str) -> torch.Tensor:
    """All (row, filter) dots of a layer: ``[rows, M]`` int64, in one
    ``packed_dot_words`` call unless the backend caps its grid."""
    T, M = win_flat.shape[0], w_rows.shape[0]
    P, wpr, r = bs._row_layout(K)
    ww = _pack_w_rows(w_rows, w_bits)
    cap = _backends.get_backend(engine).max_grid_words
    chunk = T
    if cap is not None:
        per_row = M * (wpr if r == 1 else 1.0 / r)
        chunk = max(r, int(cap // max(per_row, 1)) // r * r)
    out = torch.empty((T, M), dtype=torch.int64, device=win_flat.device)
    for t0 in range(0, T, chunk):
        t1 = min(t0 + chunk, T)
        xw = _pack_x_rows(win_flat[t0:t1], x_bits)
        vals, _ = bs.packed_dot_words(xw, ww, K=K, acc_bits=acc_bits,
                                      engine=engine)
        out[t0:t1] = vals.reshape(M, -1)[:, : t1 - t0].t()
    return out


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
    affine identity ``zw * sum(x)``), overlap and the backend pin follow
    the reference's rules and precedence (explicit ``engine=`` > the plan's
    ``backend`` > ``NC_TORCH_BACKEND`` > ``gemm``)."""
    batched = x.ndim == 4
    x4 = x if batched else x[None]
    dev = x4.device
    B = x4.shape[0]
    x_qps = _as_qp_list(x_qp, B)
    w = w.to(dev)
    wq = (w.to(torch.int64) if not torch.is_floating_point(w)
          else _quantize_weights(w, w_qp))
    xq = _quantize_images(x4, x_qps)
    R, S, Cw, M = wq.shape
    if xq.shape[3] != Cw:
        raise ValueError(f"input has {xq.shape[3]} channels, filters {Cw}")
    zxs = torch.tensor([int(p.zero_point) for p in x_qps], dtype=torch.int64,
                       device=dev)
    if padding == "SAME":
        ph = _same_pad(xq.shape[1], R, stride)
        pw = _same_pad(xq.shape[2], S, stride)
        padded = zxs[:, None, None, None].expand(
            B, xq.shape[1] + sum(ph), xq.shape[2] + sum(pw), Cw).clone()
        padded[:, ph[0]:ph[0] + xq.shape[1], pw[0]:pw[0] + xq.shape[2]] = xq
        xq = padded
    elif padding != "VALID":
        raise ValueError(f"padding must be VALID or SAME, got {padding!r}")
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
    if plan.integrity:
        raise NotImplementedError(
            "ABFT integrity checking comes with the port's faults/integrity "
            "slice; plan without integrity=True")
    if plan.compressed:
        raise NotImplementedError(
            "compressed (CSR bit-plane) filter residency comes with the "
            "port's CompressedPlanes slice; plan without compressed=True")
    engine = _backends.resolve_backend(engine, plan.backend)
    tile_rows = max(1, min(plan.tile_rows, rows_total))
    tile_filters = max(1, min(plan.tile_filters, M))

    occ = plan.occupancy
    if occ is not None and occ.zero_filters:
        if occ.total_filters != M:
            raise ValueError(f"{spec.name}: occupancy covers "
                             f"{occ.total_filters} filters, layer has {M}")
        zero_idx = torch.tensor(occ.zero_filters, dtype=torch.int64,
                                device=dev)
        not_zero = ~(w_rows[zero_idx] == zw_int).all(dim=1)
        if bool(not_zero.any()):
            raise ValueError(
                f"{spec.name}: occupancy marks filters "
                f"{zero_idx[not_zero].tolist()} as zero but their weights "
                f"are live (stale plan?)")
        zero_mask = torch.zeros(M, dtype=torch.bool, device=dev)
        zero_mask[zero_idx] = True
        live_idx = torch.nonzero(~zero_mask).flatten()
    else:
        zero_mask = live_idx = None

    w_rows_live = w_rows if live_idx is None else w_rows[live_idx]
    M_live = w_rows_live.shape[0]
    per_dot = bs.dot_cycles(K, n_bits, acc_bits)
    out = torch.empty((rows_total, M), dtype=torch.int64, device=dev)
    n_tiles = 0
    if M_live:
        # the plan's tiles, reported as planned; executed as one dot call
        n_tiles = -(-rows_total // tile_rows) * -(-M_live // tile_filters)
        vals = _dot_rows(win_flat, w_rows_live, x_qps[0].bits, w_qp.bits, K,
                         acc_bits, engine)
        if live_idx is None:
            out = vals
        else:
            out[:, live_idx] = vals
    if zero_mask is not None:
        # pruned passes: an all-zero filter's dot is the affine constant
        # zw * sum_k(x_k) — exact, no engine lanes clocked for it
        row_sums = win_flat.sum(dim=1, dtype=torch.int64)
        out[:, zero_mask] = zw_int * row_sums[:, None]
    total_cycles = per_dot * rows_total * M_live

    # affine zero-point correction (exact integer identity, per image)
    sx = win.sum(dim=-1, dtype=torch.int64)  # (B, E, F)
    sw = wq.sum(dim=(0, 1, 2))  # (M,)
    zx = zxs[:, None, None, None]
    acc = (out.reshape(B, E, F, M) - zw_int * sx[..., None]
           - zx * sw[None, None, None, :] + K * zx * zw_int)
    result = (acc if batched else acc[0]).to(torch.int32)
    if not return_stats:
        return result, total_cycles
    # separable zero-operand count: sum_k (#nonzero windows_k)(#nonzero w_k)
    cx = (win_flat != 0).sum(dim=0, dtype=torch.int64)
    cw = (w_rows != 0).sum(dim=0, dtype=torch.int64)
    live = int((cx * cw).sum())
    stats = ConvStats(
        lanes=rows_total * M * K,
        zero_operand_lanes=rows_total * M * K - live,
        tiles=n_tiles,
        tile_pixels=tile_rows,
        tile_filters=tile_filters,
        serial_passes=plan.serial_passes,
        engine_words_total=0,
        engine_words_skipped=0,
        batch=B,
        filter_loads=1,
        zero_filters=M - M_live,
        skipped_passes=plan.skipped_passes,
        overlap=bool(plan.overlap),
        quarantined_slices=plan.quarantined_slices,
        plan=plan,
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


def nc_minmax(x_q: torch.Tensor, bits: int = 32, signed: bool = False):
    """§IV-D in-cache dynamic range: min AND max over the LAST axis via the
    bit-serial log tree, in packed word space.  Rows are pre-padded to the
    next power of two with copies of their first lane; ``signed`` biases
    ``bits``-wide two's complement values by ``2^(bits-1)`` on the way in
    and out (+2 cycles).  Returns ``(mins, maxs, cycles)`` shaped like the
    leading axes."""
    lead = tuple(x_q.shape[:-1])
    K = x_q.shape[-1] if x_q.ndim else 1
    rows = x_q.reshape(-1, K).to(torch.int64)
    bias = (1 << (bits - 1)) if signed else 0
    u = (rows + bias) & ((1 << bits) - 1)
    P = 1 << max(0, (K - 1).bit_length())
    padded = u[:, :1].expand(u.shape[0], P).clone()  # neutral pad
    padded[:, :K] = u
    pp = bs.pack_values(padded, bits, row_align=True)
    (mn_pp, mx_pp), cycles = bs.bitserial_minmax(pp)
    mn = bs.unpack_values(mn_pp).reshape(-1) - bias
    mx = bs.unpack_values(mx_pp).reshape(-1) - bias
    if signed:
        cycles += 2
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
