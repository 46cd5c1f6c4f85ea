"""Inception v3 — the paper's evaluation workload (Table I), in PyTorch.

The port of ``repro.models.inception``.  One structure definition drives:

* ``inception_v3_specs()`` — the per-branch LayerSpec list consumed by the
  mapper, scheduler and simulator (equal to the reference's),
* ``init_params`` / ``apply`` — the float forward pass (NHWC activations,
  HWIO filters, BN folded into a per-channel scale/bias), and
* ``nc_forward`` — the same network executed through the bit-serial
  emulation (core/nc_layers.py) on the GPU, with a per-layer report pairing
  the emulation's arithmetic cycles with the analytic model's pass cycles.

``FULL`` is the paper's 299x299, 1001-class network; ``reduced_config()``
shrinks image size, channel widths, class count and mixed stages.
``params_from_jax`` carries the reference's parameters across.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import backends as _backends
from repro_torch.core import bitserial as bs
from repro_torch.core import nc_layers as nc
from repro_torch.core import quantize as q
from repro_torch.core import schedule as sched
from repro_torch.core import simulator as sim
from repro_torch.core.cache_geometry import CacheGeometry, XEON_E5_35MB
from repro_torch.core.mapper import LayerSpec
from repro_torch.device import resolve_device

# ---------------------------------------------------------------------------
# Structure: op = ("conv", R, S, M, stride, pad) | ("maxpool"|"avgpool", R, stride, pad)
# A block is either a single op or a list of branches (each a list of ops).
# ---------------------------------------------------------------------------
STEM = [
    ("Conv2d_1a_3x3", ("conv", 3, 3, 32, 2, "VALID")),
    ("Conv2d_2a_3x3", ("conv", 3, 3, 32, 1, "VALID")),
    ("Conv2d_2b_3x3", ("conv", 3, 3, 64, 1, "SAME")),
    ("MaxPool_3a_3x3", ("maxpool", 3, 2, "VALID")),
    ("Conv2d_3b_1x1", ("conv", 1, 1, 80, 1, "VALID")),
    ("Conv2d_4a_3x3", ("conv", 3, 3, 192, 1, "VALID")),
    ("MaxPool_5a_3x3", ("maxpool", 3, 2, "VALID")),
]


def _inception_a(pool_proj: int):  # Mixed_5x (35x35)
    return [
        [("conv", 1, 1, 64, 1, "SAME")],
        [("conv", 1, 1, 48, 1, "SAME"), ("conv", 5, 5, 64, 1, "SAME")],
        [
            ("conv", 1, 1, 64, 1, "SAME"),
            ("conv", 3, 3, 96, 1, "SAME"),
            ("conv", 3, 3, 96, 1, "SAME"),
        ],
        [("avgpool", 3, 1, "SAME"), ("conv", 1, 1, pool_proj, 1, "SAME")],
    ]


def _reduction_a():  # Mixed_6a (35 -> 17)
    return [
        [("conv", 3, 3, 384, 2, "VALID")],
        [
            ("conv", 1, 1, 64, 1, "SAME"),
            ("conv", 3, 3, 96, 1, "SAME"),
            ("conv", 3, 3, 96, 2, "VALID"),
        ],
        [("maxpool", 3, 2, "VALID")],
    ]


def _inception_b(c7: int):  # Mixed_6b..6e (17x17)
    return [
        [("conv", 1, 1, 192, 1, "SAME")],
        [
            ("conv", 1, 1, c7, 1, "SAME"),
            ("conv", 1, 7, c7, 1, "SAME"),
            ("conv", 7, 1, 192, 1, "SAME"),
        ],
        [
            ("conv", 1, 1, c7, 1, "SAME"),
            ("conv", 7, 1, c7, 1, "SAME"),
            ("conv", 1, 7, c7, 1, "SAME"),
            ("conv", 7, 1, c7, 1, "SAME"),
            ("conv", 1, 7, 192, 1, "SAME"),
        ],
        [("avgpool", 3, 1, "SAME"), ("conv", 1, 1, 192, 1, "SAME")],
    ]


def _reduction_b():  # Mixed_7a (17 -> 8)
    return [
        [("conv", 1, 1, 192, 1, "SAME"), ("conv", 3, 3, 320, 2, "VALID")],
        [
            ("conv", 1, 1, 192, 1, "SAME"),
            ("conv", 1, 7, 192, 1, "SAME"),
            ("conv", 7, 1, 192, 1, "SAME"),
            ("conv", 3, 3, 192, 2, "VALID"),
        ],
        [("maxpool", 3, 2, "VALID")],
    ]


def _inception_c():  # Mixed_7b/7c (8x8); nested split branches flattened
    return [
        [("conv", 1, 1, 320, 1, "SAME")],
        [("conv", 1, 1, 384, 1, "SAME"), ("split", [("conv", 1, 3, 384, 1, "SAME")], [("conv", 3, 1, 384, 1, "SAME")])],
        [
            ("conv", 1, 1, 448, 1, "SAME"),
            ("conv", 3, 3, 384, 1, "SAME"),
            ("split", [("conv", 1, 3, 384, 1, "SAME")], [("conv", 3, 1, 384, 1, "SAME")]),
        ],
        [("avgpool", 3, 1, "SAME"), ("conv", 1, 1, 192, 1, "SAME")],
    ]


MIXED = [
    ("Mixed_5b", _inception_a(32)),
    ("Mixed_5c", _inception_a(64)),
    ("Mixed_5d", _inception_a(64)),
    ("Mixed_6a", _reduction_a()),
    ("Mixed_6b", _inception_b(128)),
    ("Mixed_6c", _inception_b(160)),
    ("Mixed_6d", _inception_b(160)),
    ("Mixed_6e", _inception_b(192)),
    ("Mixed_7a", _reduction_b()),
    ("Mixed_7b", _inception_c()),
    ("Mixed_7c", _inception_c()),
]

IMG = 299


# ---------------------------------------------------------------------------
# Workload configuration: the full paper network, or a reduced-but-complete
# miniature for emulation-scale end-to-end runs.
# ---------------------------------------------------------------------------
def _scale_op(op, div: int):
    if op[0] == "conv":
        _, r, s, m, stride, pad = op
        return ("conv", r, s, max(1, m // div), stride, pad)
    if op[0] == "split":
        return ("split",) + tuple(
            [_scale_op(o, div) for o in sub] for sub in op[1:])
    return op


def _scale_blocks(blocks, div: int):
    if div == 1:
        return blocks
    out = []
    for name, entry in blocks:
        if isinstance(entry, tuple):  # single op (stem)
            out.append((name, _scale_op(entry, div)))
        else:  # list of branches
            out.append((name, [[_scale_op(o, div) for o in br]
                               for br in entry]))
    return out


@dataclasses.dataclass(frozen=True)
class InceptionConfig:
    """Workload geometry: image size, channel-width divisor, classes, and
    the stem/mixed structure (pre-scaled by :func:`_scale_blocks`)."""

    img: int = IMG
    classes: int = 1001
    stem: tuple = tuple((n, op) for n, op in STEM)
    mixed: tuple = tuple((n, br) for n, br in MIXED)

    @property
    def name(self) -> str:
        return f"inception_v3_{self.img}px_{self.classes}cls"


FULL = InceptionConfig()

_STAGE_BLOCKS = {
    "a": ("Mixed_5b",),
    "ra": ("Mixed_6a",),
    "b": ("Mixed_6b",),
    "rb": ("Mixed_7a",),
    "c": ("Mixed_7b",),
}


def reduced_config(img: int = 79, width_div: int = 4, classes: int = 32,
                   stages: Sequence[str] = ("a", "ra", "b", "rb", "c"),
                   ) -> InceptionConfig:
    """A miniature Inception v3: same topology, ``width_div``-narrower
    channels, one mixed block per requested stage.

    The default (79px, /4 widths) keeps every block type and both spatial
    reductions (7x7 -> 3x3 -> 1x1 mixed grids) while staying tractable for
    the bit-serial emulation; ``stages=("a",)`` with a smaller image is the
    test-sized variant.  Note Mixed_6a/7a need a >=7px mixed grid."""
    keep = [b for s in stages for b in _STAGE_BLOCKS[s]]
    mixed = tuple((n, br) for n, br in MIXED if n in keep)
    return InceptionConfig(
        img=img, classes=classes,
        stem=tuple(_scale_blocks(STEM, width_div)),
        mixed=tuple(_scale_blocks(mixed, width_div)),
    )


REDUCED = reduced_config()


def _out_size(h: int, r: int, stride: int, pad: str) -> int:
    if pad == "SAME":
        return math.ceil(h / stride)
    return (h - r) // stride + 1


# ---------------------------------------------------------------------------
# Spec generation for the mapper/simulator
# ---------------------------------------------------------------------------
def _op_specs(name, block, op, h, c, specs):
    """Append LayerSpecs for one op; return (out_h, out_c)."""
    if op[0] == "conv":
        _, r, s, m, stride, pad = op
        e = _out_size(h, max(r, s), stride, pad)
        specs.append(
            LayerSpec(name=name, kind="conv", H=h, R=r, S=s, C=c, M=m, E=e,
                      stride=stride, block=block)
        )
        return e, m
    if op[0] in ("maxpool", "avgpool"):
        _, r, stride, pad = op
        e = _out_size(h, r, stride, pad)
        specs.append(
            LayerSpec(name=name, kind=op[0], H=h, R=r, S=r, C=0, M=c, E=e,
                      stride=stride, block=block)
        )
        return e, c
    if op[0] == "split":
        out_c = 0
        e = h
        for i, sub in enumerate(op[1:]):
            hh, cc = h, c
            for j, sop in enumerate(sub):
                hh, cc = _op_specs(f"{name}_s{i}_{j}", block, sop, hh, cc, specs)
            out_c += cc
            e = hh
        return e, out_c
    raise ValueError(op)


def inception_v3_specs(config: InceptionConfig = FULL) -> list[LayerSpec]:
    specs: list[LayerSpec] = []
    h, c = config.img, 3
    for name, op in config.stem:
        h, c = _op_specs(name, name, op, h, c, specs)
    for bname, branches in config.mixed:
        out_c = 0
        out_h = h
        for bi, branch in enumerate(branches):
            hh, cc = h, c
            for oi, op in enumerate(branch):
                hh, cc = _op_specs(f"{bname}_b{bi}_{oi}", bname, op, hh, cc, specs)
            out_c += cc
            out_h = hh
        h, c = out_h, out_c
    # global average pool (8x8 window) + FC-as-1x1-conv (§IV-D)
    specs.append(LayerSpec("AvgPool", "avgpool", H=h, R=h, S=h, C=0, M=c, E=1,
                           stride=1, block="AvgPool"))
    specs.append(LayerSpec("FullyConnected", "fc", H=1, R=1, S=1, C=c,
                           M=config.classes, E=1, stride=1,
                           block="FullyConnected"))
    return specs



# ---------------------------------------------------------------------------
# Parameters: {name: {"w": [R, S, C, M], "scale": [M], "bias": [M]}} float32
# tensors (HWIO filters, BN folded into a per-channel scale/bias).
# ---------------------------------------------------------------------------
def _iter_convs(config: InceptionConfig = FULL):
    """Yield (path, r, s, c, m) for every conv in definition order."""
    for sp in inception_v3_specs(config):
        if sp.kind in ("conv", "fc"):
            yield sp.name, sp.R, sp.S, sp.C, sp.M


def init_params(generator: torch.Generator,
                config: InceptionConfig = FULL,
                device: str | torch.device | None = None) -> dict:
    """He-normal filters, unit scale, zero bias, drawn on the CPU from
    ``generator`` (so a seed gives the same weights on every device) and
    moved to ``device`` (default ``"cuda"``)."""
    dev = resolve_device(device)
    params = {}
    for name, r, s, c, m in _iter_convs(config):
        w = torch.randn((r, s, c, m), generator=generator,
                        dtype=torch.float32) * (2.0 / (r * s * c)) ** 0.5
        params[name] = {"w": w.to(dev),
                        "scale": torch.ones(m, dtype=torch.float32, device=dev),
                        "bias": torch.zeros(m, dtype=torch.float32, device=dev)}
    return params


def params_from_jax(params: dict,
                    device: str | torch.device | None = None) -> dict:
    """The JAX package's parameter dict (``{name: {"w", "scale", "bias"}}``,
    numpy-convertible arrays, HWIO) as the port's float32 tensors on
    ``device`` (default ``"cuda"``)."""
    dev = resolve_device(device)
    return {name: {k: torch.from_numpy(np.array(v, np.float32)).to(dev)
                   for k, v in p.items()}
            for name, p in params.items()}


# ---------------------------------------------------------------------------
# Float forward (rung 3 of the serving ladder).  NHWC activations.
# ---------------------------------------------------------------------------
def _pad_nhwc(x, h_pad, w_pad, value=0.0):
    return torch.nn.functional.pad(x, (0, 0) + tuple(w_pad) + tuple(h_pad),
                                   value=value)


def _conv(x, p, stride, pad):
    r, s = p["w"].shape[:2]
    if pad == "SAME":
        x = _pad_nhwc(x, nc._same_pad(x.shape[1], r, stride),
                      nc._same_pad(x.shape[2], s, stride))
    y = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2),
                                   p["w"].permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1) * p["scale"] + p["bias"]


def _pool(x, kind, r, stride, pad):
    hp = nc._same_pad(x.shape[1], r, stride) if pad == "SAME" else (0, 0)
    wp = nc._same_pad(x.shape[2], r, stride) if pad == "SAME" else (0, 0)
    if kind == "maxpool":
        xp = _pad_nhwc(x, hp, wp, value=-math.inf).permute(0, 3, 1, 2)
        return torch.nn.functional.max_pool2d(xp, r, stride).permute(0, 2, 3, 1)
    ones = _pad_nhwc(torch.ones_like(x[..., :1]), hp, wp).permute(0, 3, 1, 2)
    xp = _pad_nhwc(x, hp, wp).permute(0, 3, 1, 2)
    s = torch.nn.functional.avg_pool2d(xp, r, stride, divisor_override=1)
    n = torch.nn.functional.avg_pool2d(ones, r, stride, divisor_override=1)
    return (s / n).permute(0, 2, 3, 1)


def _apply_op(x, name, op, params):
    if op[0] == "conv":
        _, r, s, m, stride, pad = op
        return torch.relu(_conv(x, params[name], stride, pad))
    if op[0] in ("maxpool", "avgpool"):
        _, r, stride, pad = op
        return _pool(x, op[0], r, stride, pad)
    if op[0] == "split":
        outs = []
        for i, sub in enumerate(op[1:]):
            y = x
            for j, sop in enumerate(sub):
                y = _apply_op(y, f"{name}_s{i}_{j}", sop, params)
            outs.append(y)
        return torch.cat(outs, dim=-1)
    raise ValueError(op)


def apply(params: dict, x: torch.Tensor,
          config: InceptionConfig = FULL) -> torch.Tensor:
    """Float forward pass.  ``x``: ``[N, H, W, 3]`` float32 in [0, 1] on the
    parameters' device; returns ``[N, classes]``.

    Sets ``torch.backends.cudnn.allow_tf32`` and
    ``torch.backends.cuda.matmul.allow_tf32`` to False (process-wide): the
    float reference runs in full float32, not TF32, on the GPU."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for name, op in config.stem:
        x = _apply_op(x, name, op, params)
    for bname, branches in config.mixed:
        outs = []
        for bi, branch in enumerate(branches):
            y = x
            for oi, op in enumerate(branch):
                y = _apply_op(y, f"{bname}_b{bi}_{oi}", op, params)
            outs.append(y)
        x = torch.cat(outs, dim=-1)
    x = x.mean(dim=(1, 2))  # global average pool
    p = params["FullyConnected"]
    return x @ p["w"][0, 0] * p["scale"] + p["bias"]


# ---------------------------------------------------------------------------
# Quantized forward THROUGH THE EMULATION (§IV-D pipeline): every conv/pool/
# fc runs on the packed bit-serial engine; activations stay quantized uint8
# residents on the device between layers.  Each layer's dynamic range comes
# from the in-cache nc_minmax log tree — only two integer scalars per image
# reach the host, which answers with a fixed-point multiplier + zero point.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class NCLayerReport:
    """One emulated layer: arithmetic cycles charged by the engine next to
    the analytic model's serialized-pass cycles (fields as the reference)."""

    name: str
    kind: str
    out_shape: tuple
    emulated_cycles: int
    modeled_cycles: float
    serial_passes: int
    modeled_s: float
    lanes: int = 0
    zero_operand_lanes: int = 0
    batch: int = 1
    minmax_cycles: int = 0
    filter_loads: int = 0
    skipped_passes: int = 0
    zero_filters: int = 0
    overlap: bool = False
    integrity: bool = False
    reexec_passes: int = 0
    faults_detected: int = 0
    quarantined_slices: tuple = ()
    live_output_bytes: int = 0


@dataclasses.dataclass(frozen=True)
class NCForwardReport:
    config_name: str
    layers: tuple[NCLayerReport, ...]
    batch: int = 1
    concat_requant_cycles: int = 0

    @property
    def total_emulated_cycles(self) -> int:
        return sum(l.emulated_cycles for l in self.layers)

    @property
    def total_modeled_cycles(self) -> float:
        return sum(l.modeled_cycles for l in self.layers)

    @property
    def total_modeled_s(self) -> float:
        return sum(l.modeled_s for l in self.layers)

    @property
    def total_zero_operand_lanes(self) -> int:
        return sum(l.zero_operand_lanes for l in self.layers)

    @property
    def total_skipped_passes(self) -> int:
        return sum(l.skipped_passes for l in self.layers)


_REQUANT_PASS_CYCLES = bs.mul_cycles(32) + bs.add_cycles(32)  # per lockstep pass


def prepare_conv_weights(params: dict, config: InceptionConfig) -> dict:
    """Offline weight quantization: BN scale folds into the filter, the
    bias is applied as an integer add in the requant epilogue.  Returns
    ``{name: (wq uint8 [R, S, C, M], QuantParams, bias float32 [M])}`` on
    the parameters' device."""
    packed = {}
    for name, _, _, _, _ in _iter_convs(config):
        p = params[name]
        wf = p["w"].to(torch.float32) * p["scale"].to(torch.float32)
        w_qp = q.choose_qparams(float(wf.min()), float(wf.max()))
        wq = nc._quantize_weights(wf, w_qp).to(torch.uint8)
        packed[name] = (wq, w_qp, p["bias"].to(torch.float32))
    return packed


RELU_ZERO_FRACTION = 0.5  # prior for post-ReLU zeros (symmetric preactivation)


def _op_act_est(name, op, p_in, est):
    """Record a conv's INPUT sparsity estimate, return the output's."""
    if op[0] == "conv":
        est[name] = p_in
        return RELU_ZERO_FRACTION
    if op[0] in ("maxpool", "avgpool"):
        _, r, stride, pad = op
        return float(p_in) ** (r * r)
    if op[0] == "split":
        outs = []
        for i, sub in enumerate(op[1:]):
            p = p_in
            for j, sop in enumerate(sub):
                p = _op_act_est(f"{name}_s{i}_{j}", sop, p, est)
            outs.append(p)
        return sum(outs) / len(outs)
    raise ValueError(op)


def activation_sparsity_estimates(config: InceptionConfig = REDUCED) -> dict:
    """ReLU-chain estimates of each conv/fc layer's zero INPUT fraction."""
    est: dict[str, float] = {}
    p = 0.0  # raw image pixels
    for name, op in config.stem:
        p = _op_act_est(name, op, p, est)
    for bname, branches in config.mixed:
        outs = []
        for bi, branch in enumerate(branches):
            pb = p
            for oi, op in enumerate(branch):
                pb = _op_act_est(f"{bname}_b{bi}_{oi}", op, pb, est)
            outs.append(pb)
        p = sum(outs) / len(outs)
    est["FullyConnected"] = 0.0  # global avg of non-negative values
    return est


def _filter_rows(wq: torch.Tensor) -> torch.Tensor:
    r, s, c, m = wq.shape
    return wq.to(torch.int64).reshape(r * s * c, m).t()


def network_occupancy(wpack: dict, config: InceptionConfig = REDUCED) -> dict:
    """Per-layer :class:`~repro_torch.core.schedule.LayerOccupancy` from the
    quantized resident weights, with the ReLU-chain activation estimates."""
    est = activation_sparsity_estimates(config)
    occ = {}
    for name, r, s, c, m in _iter_convs(config):
        wq, w_qp, _ = wpack[name]
        occ[name] = sched.LayerOccupancy.from_filter_rows(
            _filter_rows(wq), w_qp.bits, int(w_qp.zero_point),
            activation_sparsity=est.get(name, 0.0))
    return occ


def observed_occupancy(wpack: dict, config: InceptionConfig,
                       report: NCForwardReport) -> dict:
    """Measured per-layer occupancy from a completed forward (warmup
    re-planning): input sparsity from the engine's zero-operand lane counts
    and ``live_outputs`` from the measured non-zero-point output bytes."""
    est = activation_sparsity_estimates(config)
    by_name = {l.name: l for l in report.layers}
    occ = {}
    for name, r, s, c, m in _iter_convs(config):
        wq, w_qp, _ = wpack[name]
        rep = by_name.get(name)
        act = est.get(name, 0.0)
        live_out = None
        if rep is not None and rep.kind == "conv":
            if rep.lanes:
                act = rep.zero_operand_lanes / rep.lanes
            live_out = int(rep.live_output_bytes)
        base = sched.LayerOccupancy.from_filter_rows(
            _filter_rows(wq), w_qp.bits, int(w_qp.zero_point),
            activation_sparsity=act)
        occ[name] = dataclasses.replace(base, live_outputs=live_out)
    return occ


def prune_wpack(wpack: dict, fraction: float = 0.5) -> dict:
    """Zero out (set to the quantized zero point) the LAST
    ``round(M * fraction)`` filters of every conv — the last-k rule of
    ``schedule.prune_occupancy``."""
    pruned = {}
    for name, (wq, w_qp, bias) in wpack.items():
        wq = wq.clone()
        k = int(round(wq.shape[-1] * fraction))
        if k:
            wq[..., wq.shape[-1] - k:] = int(w_qp.zero_point)
        pruned[name] = (wq, w_qp, bias)
    return pruned


def _requant_image(acc_b: torch.Tensor, real_multiplier: float,
                   zero_point: int) -> torch.Tensor:
    """In-cache fixed-point requantization of one image's staging
    (integer multiply + round-shift in int64, bit-exact with the shifter)."""
    mult, shift = q.fixed_point_multiplier(real_multiplier)
    rounded = (acc_b.to(torch.int64) * mult + (1 << (shift - 1))) >> shift
    return torch.clamp(rounded + zero_point, 0, 255).to(torch.uint8)


def _nc_run_conv(name, actq, act_qps, op, wpack, spec, plan, geom, const,
                 engine, records):
    _, r, s, m_, stride, pad = op
    wq, w_qp, bias = wpack[name]
    acc, cycles, stats = nc.nc_conv2d(
        actq, wq, act_qps, w_qp, stride, padding=pad, geom=geom,
        layer_spec=spec, plan=plan, engine=engine, return_stats=True)
    acc = acc.to(torch.int64)  # [B, E, F, M] int32 staging
    B = acc.shape[0]
    # §IV-D epilogue in-cache: integer bias add, ReLU, min/max tree, requant
    sxw = [q.f32(qp.scale * w_qp.scale) for qp in act_qps]  # float32 products
    sxw_t = torch.tensor(sxw, dtype=torch.float64, device=acc.device)
    bias_q = torch.round(bias.to(torch.float64)[None, :] / sxw_t[:, None])
    acc = torch.clamp_min(acc + bias_q.to(torch.int64)[:, None, None, :], 0)
    mn, mx, c_mm = nc.nc_minmax(acc.reshape(B, -1), bits=32, signed=True)
    cycles += int(c_mm)
    mn, mx = mn.tolist(), mx.tolist()  # the two scalars per image
    yq, out_qps = [], []
    for b in range(B):
        qp = q.choose_qparams(mn[b] * sxw[b], mx[b] * sxw[b])
        yq.append(_requant_image(acc[b], sxw[b] / qp.scale,
                                 int(qp.zero_point)))
        out_qps.append(qp)
    yq = torch.stack(yq)
    cycles += B * plan.quant_passes * _REQUANT_PASS_CYCLES
    live_out = max(int((yq[b] != int(out_qps[b].zero_point)).sum())
                   for b in range(B))
    modeled = sim.modeled_layer_cycles(plan, geom, const)
    records.append(NCLayerReport(
        name=name, kind="conv", out_shape=tuple(yq.shape),
        emulated_cycles=int(cycles),
        modeled_cycles=modeled["total_cycles"],
        serial_passes=modeled["serial_passes"], modeled_s=modeled["total_s"],
        lanes=stats.lanes, zero_operand_lanes=stats.zero_operand_lanes,
        batch=B, minmax_cycles=int(c_mm), filter_loads=stats.filter_loads,
        skipped_passes=modeled["skipped_passes"],
        zero_filters=stats.zero_filters, overlap=stats.overlap,
        integrity=stats.integrity, reexec_passes=stats.reexec_passes,
        faults_detected=stats.faults_detected,
        quarantined_slices=stats.quarantined_slices,
        live_output_bytes=live_out))
    return yq, out_qps


def _nc_run_pool(name, actq, act_qps, op, spec, geom, const, records):
    kind, r, stride, pad = op
    if kind == "maxpool":
        out_q, cycles = nc.nc_maxpool2d(actq, r, stride, padding=pad)
    else:
        out_q, cycles = nc.nc_avgpool2d(actq, r, stride, padding=pad)
    modeled = sim.modeled_layer_cycles(spec, geom, const)  # pools never skip
    records.append(NCLayerReport(
        name=name, kind=kind, out_shape=tuple(out_q.shape),
        emulated_cycles=int(cycles), modeled_cycles=modeled["total_cycles"],
        serial_passes=modeled["serial_passes"], modeled_s=modeled["total_s"],
        batch=out_q.shape[0]))
    # pooling is order/affine-transparent: quantization passes through
    return out_q, act_qps


def _nc_concat(outs, state):
    """Concatenate branch outputs along channels, requantizing every branch
    to a per-image common scale in-cache (only the qparams reach the host)."""
    B = outs[0][0].shape[0]
    cat_qps = []
    pieces = [[None] * B for _ in outs]
    for b in range(B):
        # (qmin - zp) * scale as float32 products, like the reference
        lo = min(q.f32((qp.qmin - int(qp.zero_point)) * qp.scale)
                 for _, qps in outs for qp in (qps[b],))
        hi = max(q.f32((qp.qmax - int(qp.zero_point)) * qp.scale)
                 for _, qps in outs for qp in (qps[b],))
        qp_c = q.choose_qparams(lo, hi)
        for i, (yq, qps) in enumerate(outs):
            qp_i = qps[b]
            accq = yq[b].to(torch.int64) - int(qp_i.zero_point)
            pieces[i][b] = _requant_image(accq, qp_i.scale / qp_c.scale,
                                          int(qp_c.zero_point))
        cat_qps.append(qp_c)
    state["concat_requant_cycles"] += B * len(outs) * _REQUANT_PASS_CYCLES
    return torch.cat([torch.stack(p) for p in pieces], dim=-1), cat_qps


def _nc_apply_op(actq, act_qps, name, op, wpack, specs, plans, geom, const,
                 engine, records, state):
    if op[0] == "conv":
        return _nc_run_conv(name, actq, act_qps, op, wpack, specs[name],
                            plans[name], geom, const, engine, records)
    if op[0] in ("maxpool", "avgpool"):
        return _nc_run_pool(name, actq, act_qps, op, specs[name], geom,
                            const, records)
    if op[0] == "split":
        outs = []
        for i, sub in enumerate(op[1:]):
            yq, qps = actq, act_qps
            for j, sop in enumerate(sub):
                yq, qps = _nc_apply_op(yq, qps, f"{name}_s{i}_{j}", sop,
                                       wpack, specs, plans, geom, const,
                                       engine, records, state)
            outs.append((yq, qps))
        return _nc_concat(outs, state)
    raise ValueError(op)


def _nc_stage_gen(x4, config, wpack, specs, plans, geom, const, engine,
                  records, state):
    """Generator over the network's serial stages: one yield per stem op,
    per mixed block, and for the final pool + FC.  ``state["logits"]``
    holds the float logits after exhaustion."""
    B = x4.shape[0]
    # §IV-D input quantization: uint8 pixels over a static [0, 1] range
    actq = torch.clamp(torch.round(x4 * 255.0), 0, 255).to(torch.uint8)
    act_qps = [q.QuantParams(scale=q.f32(1.0 / 255.0), zero_point=0)] * B
    for name, op in config.stem:
        actq, act_qps = _nc_apply_op(actq, act_qps, name, op, wpack, specs,
                                     plans, geom, const, engine, records,
                                     state)
        yield name
    for bname, branches in config.mixed:
        outs = []
        for bi, branch in enumerate(branches):
            yq, qps = actq, act_qps
            for oi, op in enumerate(branch):
                yq, qps = _nc_apply_op(yq, qps, f"{bname}_b{bi}_{oi}", op,
                                       wpack, specs, plans, geom, const,
                                       engine, records, state)
            outs.append((yq, qps))
        actq, act_qps = _nc_concat(outs, state)
        yield bname
    # global average pool through the array, then FC as a 1x1 conv
    h = actq.shape[1]
    actq, act_qps = _nc_run_pool("AvgPool", actq, act_qps,
                                 ("avgpool", h, 1, "VALID"),
                                 specs["AvgPool"], geom, const, records)
    actq = actq.reshape(B, -1)
    wq, w_qp, fc_bias = wpack["FullyConnected"]
    plan = plans["FullyConnected"]
    acc, cycles, stats = nc.nc_fc(actq, wq[0, 0], act_qps, w_qp, geom=geom,
                                  layer_spec=specs["FullyConnected"],
                                  plan=plan, engine=engine, return_stats=True)
    sxw = torch.tensor([q.f32(qp.scale * w_qp.scale) for qp in act_qps],
                       dtype=torch.float32, device=acc.device)
    # two separate float32 operations, as the reference computes them
    logits = acc.to(torch.float32) * sxw[:, None]
    logits = logits + fc_bias[None, :]
    modeled = sim.modeled_layer_cycles(plan, geom, const)
    records.append(NCLayerReport(
        name="FullyConnected", kind="fc", out_shape=tuple(logits.shape),
        emulated_cycles=int(cycles),
        modeled_cycles=modeled["total_cycles"],
        serial_passes=modeled["serial_passes"], modeled_s=modeled["total_s"],
        lanes=stats.lanes, zero_operand_lanes=stats.zero_operand_lanes,
        batch=B, filter_loads=stats.filter_loads,
        skipped_passes=modeled["skipped_passes"],
        zero_filters=stats.zero_filters, overlap=stats.overlap,
        integrity=stats.integrity, reexec_passes=stats.reexec_passes,
        faults_detected=stats.faults_detected,
        quarantined_slices=stats.quarantined_slices))
    state["logits"] = logits
    yield "FullyConnected"


def nc_forward(params: dict, x,
               config: InceptionConfig = REDUCED,
               geom: CacheGeometry = XEON_E5_35MB,
               const: sim.SimConstants = sim.SimConstants(),
               engine: str | None = None,
               schedule: sched.NetworkSchedule | None = None,
               wpack: dict | None = None,
               sparse: bool = False,
               overlap: bool = False,
               integrity: bool = False,
               compressed: bool = False,
               device: str | torch.device | None = None):
    """Quantized Inception forward pass through the bit-serial emulation.

    ``x``: ``[H, W, 3]`` or ``[B, H, W, 3]`` float32 in [0, 1] (numpy or
    tensor), moved to ``device`` (default ``"cuda"``; raises without a GPU
    unless ``device="cpu"``).  Every conv, pool and the FC run on the packed
    word engine with the batch folded into the lane axis; activations stay
    quantized uint8 on the device; each layer's dynamic range comes from
    the in-cache ``nc_minmax`` tree.  Quantization is per image, so batched
    logits equal single-image runs byte for byte.

    ``engine`` names a registered backend (core/backends.py);
    ``engine=None`` resolves as the schedule's ``backend`` pin >
    ``NC_TORCH_BACKEND`` > ``gemm``.  ``schedule``, ``wpack``, ``sparse``
    and ``overlap`` behave as in the reference (overlap plans execute
    serially, with identical results).  ``integrity`` and ``compressed``
    are not part of this package yet and raise.

    Returns ``(logits [B?, classes] float32 on the device, NCForwardReport)``
    equal to the reference's."""
    dev = resolve_device(device)
    x4 = torch.as_tensor(np.asarray(x, np.float32) if not torch.is_tensor(x)
                         else x).to(dev, torch.float32)
    batched = x4.ndim == 4
    x4 = x4 if batched else x4[None]
    if x4.ndim != 4:
        raise ValueError("nc_forward takes [H, W, 3] or [B, H, W, 3]")
    B = x4.shape[0]
    if integrity or (schedule is not None and schedule.integrity):
        raise NotImplementedError(
            "ABFT integrity checking comes with the port's faults/integrity "
            "slice")
    if compressed or (schedule is not None and schedule.compressed):
        raise NotImplementedError(
            "compressed filter residency comes with the port's "
            "CompressedPlanes slice")
    if (engine is not None and schedule is not None
            and schedule.backend not in (None, engine)):
        raise ValueError("pick the backend through the schedule "
                         "(plan_network(..., backend=...)); engine= "
                         "contradicting a backend-carrying schedule is "
                         "ambiguous")
    if schedule is not None and overlap:
        raise ValueError("request overlap through the schedule "
                         "(plan_network(..., overlap=True)); overlap= with "
                         "an explicit schedule is ambiguous")
    engine = _backends.resolve_backend(
        engine, schedule.backend if schedule is not None else None)
    specs_list = inception_v3_specs(config)
    specs = {s.name: s for s in specs_list}
    if wpack is None:
        wpack = prepare_conv_weights(params, config)
    if schedule is None:
        occ = network_occupancy(wpack, config) if sparse else None
        schedule = sched.plan_network(specs_list, geom, batch=B,
                                      occupancy=occ, overlap=overlap)
    plans = {p.spec.name: p for p in schedule.layers}
    records: list[NCLayerReport] = []
    state = {"concat_requant_cycles": 0}
    for _ in _nc_stage_gen(x4, config, wpack, specs, plans, geom, const,
                           engine, records, state):
        pass
    report = NCForwardReport(config.name, tuple(records), batch=B,
                             concat_requant_cycles=state["concat_requant_cycles"])
    logits = state["logits"]
    return (logits if batched else logits[0]), report
