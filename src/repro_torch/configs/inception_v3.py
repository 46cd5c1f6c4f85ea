"""inception-v3 — the paper's own evaluation workload (not an LM cell).

Maps onto the Neural Cache simulator and the bit-serial emulation
(``repro_torch.models.inception``)."""
from repro_torch.models.inception import inception_v3_specs  # noqa: F401

NAME = "inception-v3"
