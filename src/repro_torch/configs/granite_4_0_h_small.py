"""granite-4.0-h-small-ep8 [hybrid]: IBM Granite 4.0-H Small (32B-A9B,
``granitemoehybrid``), one chip's share of an 8-way expert-parallel
deployment.

Published values, from
https://huggingface.co/ibm-granite/granite-4.0-h-small/blob/main/config.json:
40 layers of d_model 4096, Mamba-2 mixers (expand 2, 128 heads of 64,
d_state 128, one group, conv 4 with bias, chunk 256, no projection bias)
on 36 of them and GQA attention (32 query heads, 8 KV heads of 128, no
bias, ``position_embedding_type: nope``) on layers 5, 15, 25 and 35; on
every layer a MoE of 72 SwiGLU experts of width 768, top 10 (softmax over
the 10 chosen logits), beside a shared SwiGLU of width 1536; RMSNorm eps
1e-5; tied embedding over 100,352 ids; ``embedding_multiplier`` 12,
``residual_multiplier`` 0.22, ``attention_multiplier`` 0.0078125,
``logits_scaling`` 16.

The cut: eight chips divide each layer's 72 experts, nine to a chip, with
attention, Mamba and the shared expert replicated; this chip holds share
0.  The router keeps its 72 outputs and its top 10; the layer computes
and adds the part its nine experts give.  Every width, all 40 layers and
the whole vocabulary are kept: 8.43 B parameters held (16.9 GB in bf16)
of the published 32.2 B.
"""
from repro_torch.configs.base import MixedLayerConfig

_PERIOD = ("mamba",) * 5 + ("attention",) + ("mamba",) * 4

CONFIG = MixedLayerConfig(
    name="granite-4.0-h-small-ep8",
    family="hybrid",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=768,  # per routed expert
    vocab_size=100352,
    tie_embeddings=True,
    n_experts=72,
    top_k=10,
    moe_impl="dropless",
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_chunk=256,
    norm="rmsnorm",
    act="swiglu",
    layer_types=_PERIOD * 4,
    shared_ff=1536,
    experts_held=9,
    expert_share=0,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    attention_multiplier=0.0078125,
    logits_scaling=16.0,
    position_embedding="nope",
    norm_eps=1e-5,
)
