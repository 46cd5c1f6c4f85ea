"""Three-term roofline model of one step (the port of
``repro.distributed.roofline``).

    compute term    = FLOPs / (chips x peak_FLOP/s)
    memory term     = bytes / (chips x HBM_bw)
    collective term = collective_bytes / (chips x link_bw)

:func:`repro_torch.distributed.trace_analysis.analyze_step` reports
*per-device* FLOPs, bytes and wire bytes (the local operations of one
rank), so each term is formed as per-device quantity / per-chip rate —
algebraically the formulas above with chips multiplied through.

Hardware constants are NVIDIA's H100 SXM5 80GB datasheet figures, not
measurements: 989.4 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s
HBM3, 450 GB/s of NVLink a direction (900 GB/s both ways) and 80 GiB of
HBM.  The collective term prices every byte at the NVLink rate.  That holds
inside one eight-card node; a (16, 16) mesh spans 32 such nodes whose
InfiniBand links are slower, so across nodes the term is a lower bound (the
reference's one-bandwidth model has the same limit).

MODEL_FLOPS uses the standard 6*N*D training rule (N = params, D = tokens;
forward-only steps use 2*N*D) with N = active params for MoE.  The ratio
MODEL_FLOPS / counted FLOPs measures how much counted compute is useful —
remat recompute, dispatch einsums and attention (not counted in 6ND) push
it below 1.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.distributed.trace_analysis import CollectiveStats

__all__ = ["HardwareSpec", "H100_SXM", "RooflineReport", "roofline",
           "model_flops"]


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float        # per chip, bf16
    hbm_bw: float            # bytes/s per chip
    ici_bw: float            # bytes/s per link (NVLink here)
    hbm_bytes: float         # capacity per chip


# NVIDIA H100 SXM5 80GB datasheet values (not measured): dense bf16 tensor
# core peak, HBM3 bandwidth, NVLink 4 per direction, HBM capacity.
H100_SXM = HardwareSpec(
    name="h100-sxm",
    peak_flops=989.4e12,
    hbm_bw=3.35e12,
    ici_bw=450e9,
    hbm_bytes=80 * 2**30,
)


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """6*N_active*D for train, 2*N_active*D for forward-only steps.

    Decode steps process one token per sequence (D = global_batch).
    """
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch  # decode: one new token per seq


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    # raw (per-device) measurements; the names are the reference's
    hlo_flops_per_device: float
    hlo_bytes_per_device: float
    collective_wire_bytes_per_device: float
    # the three terms, in seconds
    t_compute: float
    t_memory: float
    t_collective: float
    dominant: str
    model_flops_total: float
    useful_flops_ratio: float
    peak_memory_per_device: float | None = None

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the step that is the compute term (1.0 = perfectly
        compute-limited)."""
        t = self.bound_time
        return self.t_compute / t if t > 0 else 0.0

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["bound_time_s"] = self.bound_time
        d["roofline_fraction"] = self.roofline_fraction
        return d


def roofline(arch: str, shape: str, mesh_name: str, chips: int,
             cost: dict, coll: CollectiveStats, cfg: ModelConfig,
             spec: ShapeSpec, hw: HardwareSpec = H100_SXM,
             peak_memory: float | None = None) -> RooflineReport:
    flops = float(cost.get("flops", 0.0))
    nbytes = float(cost.get("bytes accessed", 0.0))
    cbytes = float(coll.total_wire_bytes)

    t_c = flops / hw.peak_flops
    t_m = nbytes / hw.hbm_bw
    t_n = cbytes / hw.ici_bw

    dominant = max(
        (("compute", t_c), ("memory", t_m), ("collective", t_n)),
        key=lambda kv: kv[1],
    )[0]
    mf = model_flops(cfg, spec)
    ratio = mf / (flops * chips) if flops > 0 else 0.0
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops_per_device=flops,
        hlo_bytes_per_device=nbytes,
        collective_wire_bytes_per_device=cbytes,
        t_compute=t_c, t_memory=t_m, t_collective=t_n,
        dominant=dominant,
        model_flops_total=mf,
        useful_flops_ratio=ratio,
        peak_memory_per_device=peak_memory,
    )
