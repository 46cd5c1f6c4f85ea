"""mamba2-2.7b [ssm]: SSD (state-space duality) [arXiv:2405.21060; unverified].

Attention-free: every layer is a Mamba-2 mixer (d_ff=0).  Runs long_500k —
decode state is O(1) in sequence length.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    norm="rmsnorm",
)
