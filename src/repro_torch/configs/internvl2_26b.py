"""internvl2-26b [vlm]: InternViT + InternLM2 [arXiv:2404.16821; hf].

LM backbone only — the InternViT patch frontend is a stub; input_specs()
provides precomputed patch embeddings interleaved with text tokens.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,  # GQA
    d_ff=16384,
    vocab_size=92553,
    norm="rmsnorm",
    act="swiglu",
    frontend="vision_patch",
)
