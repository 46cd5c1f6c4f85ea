"""The port's roofline against ``repro.distributed.roofline``.

``model_flops`` and ``roofline`` equal the reference's exactly for every
arch x shape, on the same cost dict and collective statistics, with a
``HardwareSpec`` built from the reference's ``TPU_V5E`` fields (taken from
the reference here: the port holds no TPU constant).  ``H100_SXM``'s
datasheet values are pinned.
"""
import dataclasses
import sys

import pytest
import torch

from repro.configs import REGISTRY as RREG
from repro.configs import get_config as rget
from repro.configs import shapes_for as rshapes
from repro.distributed.hlo_analysis import CollectiveStats as RStats
from repro.distributed.roofline import TPU_V5E
from repro.distributed.roofline import model_flops as r_model_flops
from repro.distributed.roofline import roofline as r_roofline
from repro_torch.configs import get_config as tget
from repro_torch.configs import shapes_for as tshapes
import repro_torch.distributed.roofline  # noqa: F401  (the module)
from repro_torch.distributed.trace_analysis import CollectiveStats

torch.set_num_threads(1)
TR = sys.modules["repro_torch.distributed.roofline"]

HW = TR.HardwareSpec(**dataclasses.asdict(TPU_V5E))


def _stats(cls, n):
    st = cls()
    st.add("all-gather", 3_000_000 * n, 16)
    st.add("all-reduce", 1_000_003 * n, 256)
    st.add("all-to-all", 12_345 * n, 16)
    st.add("collective-permute", 777, 2)
    return st


@pytest.mark.parametrize("arch", sorted(RREG))
def test_model_flops_and_roofline_equal_reference(arch):
    rcfg, tcfg = rget(arch), tget(arch)
    for i, (rs, ts) in enumerate(zip(rshapes(rcfg), tshapes(tcfg))):
        assert TR.model_flops(tcfg, ts) == r_model_flops(rcfg, rs)
        cost = {"flops": 1.7e14 * (i + 1), "bytes accessed": 3.1e11 / (i + 1)}
        for chips, peak in ((256, None), (512, 1.5e10)):
            want = r_roofline(arch, rs.name, "m", chips, cost,
                              _stats(RStats, i + 1), rcfg, rs, TPU_V5E,
                              peak_memory=peak)
            got = TR.roofline(arch, ts.name, "m", chips, cost,
                              _stats(CollectiveStats, i + 1), tcfg, ts, HW,
                              peak_memory=peak)
            assert got.as_dict() == want.as_dict()
            assert got.bound_time == want.bound_time
            assert got.roofline_fraction == want.roofline_fraction


def test_zero_flops_and_dominance_as_reference():
    rcfg, tcfg = rget("olmo-1b"), tget("olmo-1b")
    rs, ts = rshapes(rcfg)[0], tshapes(tcfg)[0]
    for cost in ({}, {"flops": 0.0, "bytes accessed": 5e9},
                 {"flops": 1e9, "bytes accessed": 0.0}):
        want = r_roofline("a", "s", "m", 4, cost, RStats(), rcfg, rs,
                          TPU_V5E)
        got = TR.roofline("a", "s", "m", 4, cost, CollectiveStats(), tcfg,
                          ts, HW)
        assert got.as_dict() == want.as_dict()


def test_h100_datasheet_values_pinned():
    h = TR.H100_SXM
    assert h.peak_flops == 989.4e12  # dense bf16, tensor cores
    assert h.hbm_bw == 3.35e12  # HBM3
    assert h.ici_bw == 450e9  # NVLink 4, one direction
    assert h.hbm_bytes == 80 * 2**30
    assert TR.roofline.__defaults__[0] is h


def test_no_tpu_constant_in_the_port():
    assert not hasattr(TR, "TPU_V5E")
    import repro_torch.distributed as D
    assert not hasattr(D, "TPU_V5E") and D.H100_SXM is TR.H100_SXM
