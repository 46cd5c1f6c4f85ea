"""The distributed layer of the port: sharding rules and their DTensor
placements, the H100 roofline, the per-device step analysis and the GPipe
schedule (the counterparts of ``repro.distributed``)."""
from repro_torch.distributed.sharding import (
    make_param_shardings,
    make_batch_sharding,
    make_cache_shardings,
    spec_for_param,
    to_placements,
    ShardingReport,
)
from repro_torch.distributed.trace_analysis import (analyze_step,
                                                    CollectiveStats, StepCost)
from repro_torch.distributed.roofline import roofline, RooflineReport, H100_SXM
