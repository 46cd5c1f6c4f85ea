"""The plain reference against the program on the CPU, and the yardstick's
layer table against the program's."""
import pytest
import torch

from ncbench import roofline
from ncbench.builders import inception as builder
from ncbench.conftest import TINY
from ncbench.references import inception as ref

CPU = torch.device("cpu")


def _cfg(prune):
    return dict(TINY, prune_fraction=prune, geometry="XEON_E5_35MB",
                backend="gemm", engine=dict(sparse=True, overlap=True,
                                            integrity=False,
                                            compressed=bool(prune)))


@pytest.mark.parametrize("prune", [0.0, 0.5])
def test_reference_equals_nc_forward_byte_for_byte(prune):
    from repro_torch.models import inception

    cfg = _cfg(prune)
    gen = torch.Generator(device=CPU).manual_seed(2 ** 31 + 7)
    params = builder.make_params(cfg, gen, CPU)
    x = builder.make_images(cfg, 2, gen, CPU)
    occ = prune and inception.network_occupancy(
        inception.prepare_conv_weights(params, builder.network_config(cfg)),
        builder.network_config(cfg))
    if prune:  # the pruned filters quantize to the zero point: zero filters
        assert all(len(o.zero_filters) == o.total_filters // 2
                   for name, o in occ.items() if name != "FullyConnected")
    got, _ = inception.nc_forward(params, x, config=builder.network_config(cfg),
                                  sparse=True, compressed=bool(prune),
                                  device=CPU)
    want = ref.logits(params, x, cfg, block=1)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # four bits, the control's precision, reads a gap
    assert not torch.equal(ref.logits(params, x, cfg, bits=4), want)


def test_layer_table_equals_the_program_specs_at_full_width():
    from repro_torch.models import inception

    cfg = {"img": 299, "classes": 1001, "width_div": 1, "mixed": "all"}
    specs = [(s.name, s.R, s.S, s.C, s.M, s.E, s.E)
             for s in inception.inception_v3_specs(inception.FULL)
             if s.kind in ("conv", "fc")]
    assert ref.layer_shapes(cfg) == specs
    assert len(specs) == 95
    macs = sum(s.E * s.E * s.R * s.S * s.C * s.M
               for s in inception.inception_v3_specs(inception.FULL)
               if s.kind in ("conv", "fc"))
    assert roofline.macs_per_image(ref.layer_shapes(cfg)) == macs
    # pruning halves every conv's filters, never the FC's
    pruned = roofline.gemms(ref.layer_shapes(cfg), 1, 0.5)
    assert pruned[-1] == (1, 1001, 2048)
    assert pruned[0] == (149 * 149, 16, 27)


def test_network_config_matches_the_program_reduced_config():
    from repro_torch.models import inception

    assert builder.network_config(TINY) == inception.reduced_config(
        img=47, width_div=4, classes=10, stages=("a",))
    assert builder.network_config(
        {"img": 299, "classes": 1001, "width_div": 1, "mixed": "all"}
    ) == inception.FULL


def test_host_filters_are_handed_over_on_the_host():
    """``"filters": "host"``: the engine gets the float filters and their
    scales on the host and the biases where they were made; otherwise the
    weights as they are."""
    cfg = dict(_cfg(0.5), filters="host")
    params = builder.make_params(cfg, torch.Generator(device=CPU)
                                 .manual_seed(3), CPU)
    got = builder.engine_params(params, cfg)
    assert set(got) == set(params)
    for name, p in params.items():
        assert got[name]["w"].device == got[name]["scale"].device == CPU
        assert torch.equal(got[name]["w"], p["w"])
        assert got[name]["bias"] is p["bias"]
    assert builder.engine_params(params, _cfg(0.5)) is params
