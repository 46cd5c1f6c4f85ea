"""Plain reference of Granite 4.0-H Small's forward
(``granitemoehybrid``), computed in blocks so that it fits on the card
beside the program.

Written in plain PyTorch from the published description
(https://huggingface.co/ibm-granite/granite-4.0-h-small/blob/main/config.json
and the Mamba-2 paper, arXiv:2405.21060); it imports nothing of the
program.  Float32 throughout, TF32 off.  No cache and no batching: each
sequence's full forward over its prompt and continuation, the logits read
at the requested positions.  Blocks: ``block`` sequences at a time go
through the layers in order, each layer's weights taken to the device in
float32 once for them, wherever the caller keeps them (the benchmark's
builder keeps them on the host).

The layer equations (for the configuration file's keys):

    h = embedding_multiplier * E[ids]
    per layer l:  h += residual_multiplier * mixer_l(rms(h))
                  v = rms(h)
                  h += residual_multiplier * (moe(v) + shared(v))
    logits = rms(h) @ E.T / logits_scaling

``rms`` is RMSNorm (``rms_norm_eps``) times its weight.  The mixer is
attention where ``layer_types[l]`` says so, with no positional encoding,
GQA and scores scaled by ``attention_multiplier``; elsewhere Mamba-2 with
one group: ``in_proj`` to (z, xBC, dt), a causal depthwise conv (with
bias) and SiLU on xBC, ``dt = softplus(dt + dt_bias)``, the SSD
recurrence ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T``, ``y_t = h_t C_t
+ D x_t`` with ``A = -exp(A_log)``, computed here in the published chunked
form (``ssd_minimal_discrete`` of the paper's listing, chunk
``mamba_chunk_size``), then ``rms(y * silu(z))`` and ``out_proj``.  The
router takes the top ``num_experts_per_tok`` of its logits and a softmax
over them; each expert and the shared expert are SwiGLU,
``down(silu(gate(v)) * up(v))``.

Departures from the published model: the configuration's cut, one chip's
share of an expert-parallel deployment.  The router keeps all its outputs,
but only the held experts (``first_expert`` onward) add their part; the
other experts' part is left out, as it is in the program.  Weights are the
seeded random ones the benchmark draws, not the published checkpoint.

``bits`` below 16 is the control of the benchmark's comparison: every
weight matrix (the embedding, the projections, the router and the
experts) rounded to float8 e4m3, each scaled by its largest magnitude
over 448, the nearest precision below the configuration's 16 bits.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

_F32 = torch.float32
E4M3_MAX = 448.0


@contextlib.contextmanager
def _exact_float32():
    """TF32 off for matrix products and convolutions while open."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _weight(w: torch.Tensor, bits: int) -> torch.Tensor:
    """``w`` in float32; below 16 bits, rounded to float8 e4m3 at the
    scale that maps its largest magnitude to 448."""
    w = w.to(_F32)
    if bits >= 16:
        return w
    s = w.abs().amax().clamp_min(1e-30) / E4M3_MAX
    return (w / s).to(torch.float8_e4m3fn).to(_F32) * s


def _rms(x, w, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.to(_F32)


def _swiglu(v, gate, up, down):
    return (F.silu(v @ gate) * (v @ up)) @ down


def _segsum(x):
    """``[..., T] -> [..., T, T]``: entry (i, j) the sum of x over (j, i],
    -inf above the diagonal (the paper's stable segment sum)."""
    T = x.shape[-1]
    x = x[..., None].expand(*x.shape, T)
    below = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device), -1)
    x = x.masked_fill(~below, 0)
    out = torch.cumsum(x, dim=-2)
    diag = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device), 0)
    return out.masked_fill(~diag, -torch.inf)


def ssd_chunked(X, A, B, C, chunk: int):
    """The paper's ``ssd_minimal_discrete``: X [b, l, h, p] (x times dt),
    A [b, l, h] (dt times A), B and C [b, l, h, n]; l a multiple of
    ``chunk``.  Returns Y [b, l, h, p] from a zero initial state."""
    b, l, h, p = X.shape
    c = l // chunk

    def blocks(t):
        return t.reshape(b, c, chunk, *t.shape[2:])

    X, A, B, C = blocks(X), blocks(A), blocks(B), blocks(C)
    A = A.permute(0, 3, 1, 2)  # b h c l
    A_cumsum = torch.cumsum(A, dim=-1)
    L = torch.exp(_segsum(A))
    # 1. within each chunk (the diagonal blocks)
    Y_diag = torch.einsum("bclhn,bcshn,bhcls,bcshp->bclhp", C, B, L, X)
    # 2. each chunk's final state
    decay_states = torch.exp(A_cumsum[:, :, :, -1:] - A_cumsum)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", B, decay_states, X)
    # 3. the recurrence across chunk boundaries
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    decay_chunk = torch.exp(_segsum(F.pad(A_cumsum[:, :, :, -1], (1, 0))))
    states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)[:, :-1]
    # 4. the states' contribution to each chunk's outputs
    Y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", C, states,
                         torch.exp(A_cumsum))
    return (Y_diag + Y_off).reshape(b, l, h, p)


# the weight matrices, which the control rounds (with the embedding and
# every expert's)
_MATRICES = ("in_proj", "out_proj", "q", "k", "v", "o", "router")


def _on_device(lp: dict, dev, bits: int) -> dict:
    """Layer ``lp``'s weights in float32 on ``dev``, the weight matrices
    (:func:`_weight`) rounded where ``bits`` is below 16."""
    out = {}
    for name, w in lp.items():
        if isinstance(w, dict):  # experts, shared expert: all matrices
            out[name] = {n: _weight(t.to(dev), bits) for n, t in w.items()}
        elif isinstance(w, torch.Tensor):
            out[name] = (_weight(w.to(dev), bits) if name in _MATRICES
                         else w.to(dev, _F32))
        else:
            out[name] = w
    return out


def _mamba(cfg: dict, lp: dict, x):
    """x [T, d] -> [T, d]."""
    T = x.shape[0]
    nh, P = int(cfg["mamba_n_heads"]), int(cfg["mamba_d_head"])
    N, K = int(cfg["mamba_d_state"]), int(cfg["mamba_d_conv"])
    di = nh * P
    zxbcdt = x @ lp["in_proj"]
    z, xBC, dt = zxbcdt[:, :di], zxbcdt[:, di:2 * di + 2 * N], zxbcdt[:, 2 * di + 2 * N:]
    conv = F.conv1d(xBC.T[None], lp["conv_weight"][:, None, :],
                    lp["conv_bias"], padding=K - 1,
                    groups=xBC.shape[1])[0, :, :T].T
    xBC = F.silu(conv)
    xs = xBC[:, :di].reshape(T, nh, P)
    Bm, Cm = xBC[:, di:di + N], xBC[:, di + N:]
    dt = F.softplus(dt + lp["dt_bias"])  # [T, nh]
    A = -torch.exp(lp["A_log"])
    Q = int(cfg["mamba_chunk_size"])
    pad = (-T) % Q
    X = F.pad(xs * dt[..., None], (0, 0, 0, 0, 0, pad))[None]
    Ad = F.pad(dt * A, (0, 0, 0, pad))[None]
    Bh = F.pad(Bm, (0, 0, 0, pad))[None, :, None].expand(1, T + pad, nh, N)
    Ch = F.pad(Cm, (0, 0, 0, pad))[None, :, None].expand(1, T + pad, nh, N)
    y = ssd_chunked(X, Ad, Bh, Ch, Q)[0, :T]
    y = y + lp["D"][None, :, None] * xs
    y = _rms(y.reshape(T, di) * F.silu(z), lp["norm"], float(cfg["rms_norm_eps"]))
    return y @ lp["out_proj"]


def _attention(cfg: dict, lp: dict, x):
    """x [T, d] -> [T, d]: causal GQA, no positional encoding."""
    T = x.shape[0]
    H, Hkv = int(cfg["num_attention_heads"]), int(cfg["num_key_value_heads"])
    D = int(cfg["hidden_size"]) // H
    q = (x @ lp["q"]).reshape(T, H, D).transpose(0, 1)
    k = (x @ lp["k"]).reshape(T, Hkv, D).transpose(0, 1)
    v = (x @ lp["v"]).reshape(T, Hkv, D).transpose(0, 1)
    k = k.repeat_interleave(H // Hkv, dim=0)
    v = v.repeat_interleave(H // Hkv, dim=0)
    s = (q @ k.transpose(1, 2)) * float(cfg["attention_multiplier"])
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    p = torch.softmax(s.masked_fill(~causal, -torch.inf), dim=-1)
    return (p @ v).transpose(0, 1).reshape(T, H * D) @ lp["o"]


def _moe(cfg: dict, lp: dict, v):
    """The held experts' part of the routed MoE, v [T, d] -> [T, d]."""
    logits = v @ lp["router"]
    top, idx = torch.topk(logits, int(cfg["num_experts_per_tok"]), dim=-1)
    gates = torch.softmax(top, dim=-1)
    ex = lp["experts"]
    out = torch.zeros_like(v)
    for j in range(ex["gate"].shape[0]):
        rows, slot = torch.nonzero(idx == lp["first_expert"] + j,
                                   as_tuple=True)
        if rows.numel():
            y = _swiglu(v[rows], ex["gate"][j], ex["up"][j], ex["down"][j])
            out.index_add_(0, rows, y * gates[rows, slot, None])
    return out


def _layer(cfg: dict, lp: dict, h):
    eps, r = float(cfg["rms_norm_eps"]), float(cfg["residual_multiplier"])
    x = _rms(h, lp["input_norm"], eps)
    mix = _attention if lp["kind"] == "attention" else _mamba
    h = h + r * mix(cfg, lp, x)
    v = _rms(h, lp["post_norm"], eps)
    sh = lp["shared"]
    shared = _swiglu(v, sh["gate"], sh["up"], sh["down"])
    return h + r * (_moe(cfg, lp, v) + shared)


def _requests(rows: torch.Tensor):
    """``(tokens, positions)`` of each request's row: its prompt and
    continuation, and the positions whose logits are kept (step k at the
    prompt's last position plus k)."""
    out = []
    for row in rows.tolist():
        n, s = row[0], row[1]
        steps = row[2:2 + s]
        toks = [t for t in row[2 + s:] if t >= 0]
        out.append((toks, [n - 1 + k for k in steps]))
    return out


def logits(params, rows: torch.Tensor, cfg: dict, bits: int = 16,
           block: int = 4) -> torch.Tensor:
    """``[n, steps, vocab]`` float32 logits of the requests ``rows`` (the
    builder's rows) at their kept steps, from each request's full forward
    over its prompt and continuation, on ``rows``' device.  ``params``:
    ``embed`` [V, d], ``final_norm`` [d] and ``layers``, each layer's
    weights in this file's names, on any device."""
    reqs = _requests(rows)
    dev = rows.device
    eps = float(cfg["rms_norm_eps"])
    out = []
    with torch.no_grad(), _exact_float32():
        for b0 in range(0, len(reqs), block):
            group = reqs[b0:b0 + block]
            E = _weight(params["embed"].to(dev), bits)
            hs = [E[torch.tensor(t, device=dev)]
                  * float(cfg["embedding_multiplier"]) for t, _ in group]
            for lp in params["layers"]:
                w = _on_device(lp, dev, bits)
                hs = [_layer(cfg, w, h) for h in hs]
                del w
            fn = params["final_norm"].to(dev, _F32)
            for h, (_, pos) in zip(hs, group):
                out.append(_rms(h[pos], fn, eps) @ E.T
                           / float(cfg["logits_scaling"]))
            del E, hs
    return torch.stack(out)
