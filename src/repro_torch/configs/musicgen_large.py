"""musicgen-large [audio]: decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

Backbone only — the EnCodec frontend is a stub; input_specs() provides the
token stream (vocab 2048 = one codebook) / precomputed frame embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,  # MHA
    d_ff=8192,
    vocab_size=2048,
    norm="layernorm",
    act="gelu",
    frontend="audio_tokens",
)
