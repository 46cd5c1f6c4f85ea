"""The work of the LM cells, counted from the configuration file's shapes
and the program's counters (``tokens.prefill``, ``tokens.decode``,
``moe.assigned``, ``attn.prefill_pairs``, ``attn.decode_pairs``), never
from the program's code.

Peaks are NVIDIA's data-sheet figures for one H100 SXM (dense, no
sparsity, at the 700 W limit): 989 TFLOP/s in bf16, 3.35 TB/s of HBM.
Model FLOPs count two per multiply-accumulate of every linear layer a
token passes through (the Mamba and attention projections, the router,
the shared expert, and each held expert the token was routed to), the
attention's four per (query, key) pair and head dimension, and the tied
head at every position whose logits are computed (each prefill's last
and each decode step).  The SSD's own products (the chunked scan, about
3% of the prefill's FLOPs at Granite's shapes) are left out, so the
share is a floor.
"""
from __future__ import annotations

BF16_FLOPS_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12


def shapes(cfg: dict) -> dict:
    """The widths and layer counts of a Granite-style configuration file."""
    d, H = int(cfg["hidden_size"]), int(cfg["num_attention_heads"])
    nh, P = int(cfg["mamba_n_heads"]), int(cfg["mamba_d_head"])
    N = int(cfg["mamba_d_state"])
    kinds = list(cfg["layer_types"])
    return dict(d=d, H=H, Hkv=int(cfg["num_key_value_heads"]), D=d // H,
                di=nh * P, proj=2 * nh * P + 2 * N + nh,
                n_mamba=kinds.count("mamba"),
                n_attn=kinds.count("attention"), layers=len(kinds),
                vocab=int(cfg["vocab_size"]), ff=int(cfg["intermediate_size"]),
                shared=int(cfg["shared_intermediate_size"]),
                experts=int(cfg["experts_published"]))


def dense_flops_per_token(cfg: dict) -> int:
    """FLOPs of the linear layers every token takes (all but the routed
    experts and the head)."""
    s = shapes(cfg)
    d, D = s["d"], s["D"]
    mamba = d * s["proj"] + s["di"] * d
    attn = 2 * d * s["H"] * D + 2 * d * s["Hkv"] * D
    mlp = d * s["experts"] + 3 * d * s["shared"]
    return 2 * (s["n_mamba"] * mamba + s["n_attn"] * attn
                + s["layers"] * mlp)


def model_flops(cfg: dict, c: dict, requests: int) -> float:
    """The model FLOPs of ``requests`` prefills and the counters ``c``
    (totals over the window)."""
    s = shapes(cfg)
    tokens = c.get("tokens.prefill", 0) + c.get("tokens.decode", 0)
    pairs = c.get("attn.prefill_pairs", 0) + c.get("attn.decode_pairs", 0)
    return float(tokens * dense_flops_per_token(cfg)
                 + c.get("moe.assigned", 0) * 6 * s["d"] * s["ff"]
                 + 4 * s["H"] * s["D"] * pairs
                 + 2 * s["d"] * s["vocab"]
                 * (requests + c.get("tokens.decode", 0)))


def flash_least_s(cfg: dict, pairs: int, prefill_tokens: int) -> float:
    """The least time of the prefills' attention (kernel 4): the larger of
    its operations (4 H D a causal pair) at the bf16 peak and its bytes
    (q, k, v read once and the output written once, bf16, on every
    attention layer) at the HBM peak."""
    s = shapes(cfg)
    ops = 4.0 * s["H"] * s["D"] * pairs
    nbytes = (2.0 * prefill_tokens * s["n_attn"]
              * (2 * s["H"] + 2 * s["Hkv"]) * s["D"])
    return max(ops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)
