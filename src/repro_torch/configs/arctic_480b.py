"""arctic-480b [moe]: 128 experts top-2 + dense residual MLP
[hf:Snowflake/snowflake-arctic-base; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,  # per expert
    vocab_size=32000,
    n_experts=128,
    top_k=2,
    moe_dense_residual=True,
    dense_ff=10752,  # parallel dense path (Arctic dense-MoE hybrid)
    norm="rmsnorm",
    act="swiglu",
)
