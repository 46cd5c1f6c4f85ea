"""hymba-1.5b [hybrid]: parallel attn+mamba heads [arXiv:2411.13676; hf].

Sliding-window attention everywhere except three full-attention layers
(first / middle / last, per the paper); runs long_500k — SWA caches are
window-bounded and SSM state is O(1).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    norm="rmsnorm",
    act="swiglu",
    attn_window=1024,
    global_layers=(0, 15, 31),
)
