"""Plain reference of Granite 4.0-H Small's forward (``granitemoehybrid``)
for the CPU tests: one sequence, float32, no cache, no batching, the
Mamba-2 SSD as its sequential recurrence.

Written in plain PyTorch from the published description
(https://huggingface.co/ibm-granite/granite-4.0-h-small/blob/main/config.json
and the Mamba-2 paper, arXiv:2405.21060); it imports nothing of the
program.  It takes the configuration file's keys (``ncbench/configs/``)
and the per-layer weights the benchmark's builder hands the reference
(``ncbench/builders/granite.py``: ``make_params``).

    h = embedding_multiplier * E[ids]
    per layer l:  h += residual_multiplier * mixer_l(rms(h))
                  v = rms(h)
                  h += residual_multiplier * (moe(v) + shared(v))
    logits = rms(h) @ E.T / logits_scaling

Attention layers (``layer_types``) have no positional encoding, GQA, and
scores scaled by ``attention_multiplier``.  Mamba-2 layers (one group):
``in_proj`` to (z, xBC, dt), a causal depthwise conv with bias and SiLU
on xBC, ``dt = softplus(dt + dt_bias)``, ``h_t = exp(dt_t A) h_{t-1} + dt_t
x_t B_t^T``, ``y_t = h_t C_t + D x_t``, ``A = -exp(A_log)``, then
``rms(y * silu(z))`` and ``out_proj``.  The router takes the top
``num_experts_per_tok`` logits and a softmax over them; experts are
SwiGLU.

Departure from the published model: only the held experts (from
``first_expert``) add their part of the MoE, as in the program; with every
expert held (``first_expert`` 0, all of them given) this is the uncut
layer.  ``ncbench/references/granite.py`` is the benchmark's copy, which
computes in blocks and runs the SSD in the paper's chunked form.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_F32 = torch.float32


def rms(x, w, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.to(_F32)


def swiglu(v, p: dict):
    return (F.silu(v @ p["gate"].to(_F32)) * (v @ p["up"].to(_F32))) \
        @ p["down"].to(_F32)


def mamba(cfg: dict, lp: dict, x):
    """x [T, d] -> [T, d], the SSD step by step."""
    T = x.shape[0]
    nh, P = int(cfg["mamba_n_heads"]), int(cfg["mamba_d_head"])
    N, K = int(cfg["mamba_d_state"]), int(cfg["mamba_d_conv"])
    di = nh * P
    zxbcdt = x @ lp["in_proj"].to(_F32)
    z, xBC, dt = (zxbcdt[:, :di], zxbcdt[:, di:2 * di + 2 * N],
                  zxbcdt[:, 2 * di + 2 * N:])
    w = lp["conv_weight"].to(_F32)  # [C, K]
    xp = F.pad(xBC, (0, 0, K - 1, 0))
    conv = sum(xp[k:k + T] * w[:, k] for k in range(K))
    xBC = F.silu(conv + lp["conv_bias"].to(_F32))
    xs = xBC[:, :di].reshape(T, nh, P)
    Bm, Cm = xBC[:, di:di + N], xBC[:, di + N:]
    dt = F.softplus(dt + lp["dt_bias"].to(_F32))
    A = -torch.exp(lp["A_log"].to(_F32))
    D = lp["D"].to(_F32)
    h = torch.zeros(nh, P, N)
    ys = []
    for t in range(T):
        h = (h * torch.exp(dt[t] * A)[:, None, None]
             + (dt[t][:, None] * xs[t])[..., None] * Bm[t])
        ys.append(h @ Cm[t] + D[:, None] * xs[t])
    y = torch.stack(ys).reshape(T, di)
    y = rms(y * F.silu(z), lp["norm"], float(cfg["rms_norm_eps"]))
    return y @ lp["out_proj"].to(_F32)


def attention(cfg: dict, lp: dict, x):
    """x [T, d] -> [T, d]: causal GQA, no positional encoding."""
    T = x.shape[0]
    H, Hkv = int(cfg["num_attention_heads"]), int(cfg["num_key_value_heads"])
    D = int(cfg["hidden_size"]) // H
    q = (x @ lp["q"].to(_F32)).reshape(T, H, D)
    k = (x @ lp["k"].to(_F32)).reshape(T, Hkv, D)
    v = (x @ lp["v"].to(_F32)).reshape(T, Hkv, D)
    out = torch.empty(T, H, D)
    for i in range(H):
        g = i // (H // Hkv)
        s = (q[:, i] @ k[:, g].T) * float(cfg["attention_multiplier"])
        s = s.masked_fill(~torch.ones(T, T, dtype=torch.bool).tril(),
                          -torch.inf)
        out[:, i] = torch.softmax(s, dim=-1) @ v[:, g]
    return out.reshape(T, H * D) @ lp["o"].to(_F32)


def moe(cfg: dict, lp: dict, v):
    """The held experts' part of the routed MoE, token by token."""
    top, idx = torch.topk(v @ lp["router"].to(_F32),
                          int(cfg["num_experts_per_tok"]), dim=-1)
    gates = torch.softmax(top, dim=-1)
    ex = lp["experts"]
    held = range(lp["first_expert"], lp["first_expert"] + ex["gate"].shape[0])
    out = torch.zeros_like(v)
    for t in range(v.shape[0]):
        for e, g in zip(idx[t].tolist(), gates[t]):
            if e in held:
                j = e - lp["first_expert"]
                out[t] += g * swiglu(v[t], {n: ex[n][j] for n in ex})
    return out


def layer(cfg: dict, lp: dict, h):
    eps, r = float(cfg["rms_norm_eps"]), float(cfg["residual_multiplier"])
    x = rms(h, lp["input_norm"], eps)
    h = h + r * (attention if lp["kind"] == "attention" else mamba)(cfg, lp, x)
    v = rms(h, lp["post_norm"], eps)
    return h + r * (moe(cfg, lp, v) + swiglu(v, lp["shared"]))


def forward(params: dict, tokens, cfg: dict) -> torch.Tensor:
    """Logits ``[T, vocab]`` of one sequence ``tokens`` (a list of ids)."""
    E = params["embed"].to(_F32)
    with torch.no_grad():
        h = E[torch.as_tensor(tokens)] * float(cfg["embedding_multiplier"])
        for lp in params["layers"]:
            h = layer(cfg, lp, h)
        h = rms(h, params["final_norm"], float(cfg["rms_norm_eps"]))
        return h @ E.T / float(cfg["logits_scaling"])
