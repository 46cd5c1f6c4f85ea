"""Mamba-2 (SSD, state-space duality) mixer (the port of
``repro.models.mamba2``).

Three execution forms, as in the reference:
  * :func:`ssd_chunked`   - the blocked algorithm (prefill): quadratic
    within a chunk, a linear recurrence across chunk boundaries (a Python
    loop over the chunks takes the place of ``lax.scan``);
  * :func:`ssd_recurrent` - the step-by-step recurrence (the tests' oracle);
  * :func:`mamba_step`    - one-token decode from ``(conv, ssm)`` state.

State layout: h ``[B, n_heads, head_dim (P), state (N)]``; B and C are
shared across heads (ngroups 1).  The SSD math runs in float32 whatever
the model dtype.  The reference's three-operand einsums are written as two
pairwise products each, so no ``[B, nc, Q, Q, nh, P]`` temporary forms
(``torch.einsum`` contracts left to right without ``opt_einsum``).  Like
the reference, every function returns new state; the model copies it into
its cache (``models/transformer.py``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, rms_norm

__all__ = ["mamba_init", "mamba_apply", "mamba_step", "mamba_cache_init",
           "ssd_chunked", "ssd_recurrent"]

_F32 = torch.float32


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------
def mamba_init(cfg: ModelConfig, generator, device=None) -> dict:
    """The reference's parameters, drawn from ``generator``: ``A_log``,
    ``D`` and ``dt_bias`` float32, the rest in ``cfg.dtype``."""
    dt = cfg.jdtype
    d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh = cfg.ssm_heads
    conv_ch = di + 2 * N
    in_proj = dense_init(generator, d, 2 * di + 2 * N + nh, dt, device)
    conv_w = (torch.randn((cfg.ssm_conv, conv_ch), generator=generator,
                          dtype=_F32, device=device)
              / math.sqrt(cfg.ssm_conv)).to(dt)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros(conv_ch, dtype=dt, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=_F32,
                                          device=device)),
        "D": torch.ones(nh, dtype=_F32, device=device),
        "dt_bias": torch.full((nh,), -2.0, dtype=_F32, device=device),
        "norm_w": torch.ones(di, dtype=dt, device=device),
        "out_proj": dense_init(generator, di, d, dt, device),
    }


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, without torch's
    ``threshold=20`` shortcut."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(x, w, b):
    """Depthwise causal conv.  x: [B,T,C], w: [K,C]."""
    K, T = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = sum(xp[:, i:i + T] * w[i] for i in range(K))
    return out + b


def _segsum_decay(a):
    """a: [..., Q] log-decays -> L [..., Q, Q] with L[i,j]=exp(sum_{j<k<=i}
    a_k), zero above the diagonal."""
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    Q = a.shape[-1]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=a.device))
    return torch.exp(torch.where(mask, diff, -torch.inf))


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------
def ssd_recurrent(x, dt, A, Bm, Cm, D, h0=None):
    """Oracle recurrence.  x:[B,T,nh,P] dt:[B,T,nh] A:[nh] B/C:[B,T,N].
    Returns (y [B,T,nh,P], h_final [B,nh,P,N])."""
    Bsz, T, nh, P = x.shape
    N = Bm.shape[-1]
    h = (torch.zeros((Bsz, nh, P, N), dtype=_F32, device=x.device)
         if h0 is None else h0)
    ys = []
    for t in range(T):
        xt, dtt, bt, ct = x[:, t], dt[:, t], Bm[:, t], Cm[:, t]
        decay = torch.exp(dtt * A[None, :])  # [B,nh]
        upd = (xt * dtt[..., None])[..., None] * bt[:, None, None, :]
        h = h * decay[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", h, ct)
                  + D[None, :, None] * xt)
    return torch.stack(ys, dim=1), h


def ssd_chunked(x, dt, A, Bm, Cm, D, chunk: int, h0=None):
    """Blocked SSD (Mamba-2 §6): quadratic attention within chunks, linear
    recurrence across chunk boundaries.  Same signature as
    :func:`ssd_recurrent`."""
    Bsz, T, nh, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, T)
    pad = (-T) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nc = x.shape[1] // Q

    xc = x.reshape(Bsz, nc, Q, nh, P)
    dtc = dt.reshape(Bsz, nc, Q, nh)
    Bc = Bm.reshape(Bsz, nc, Q, N)
    Cc = Cm.reshape(Bsz, nc, Q, N)

    a_h = (dtc * A).permute(0, 1, 3, 2)  # [B,nc,nh,Q] log-decay per step
    cs = torch.cumsum(a_h, dim=-1)  # inclusive
    L = _segsum_decay(a_h)  # [B,nc,nh,Q,Q]

    # intra-chunk (diagonal blocks): (scores * L) then the product with xdt
    scores = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)  # [B,nc,Q,Q]
    xdt = xc * dtc[..., None]  # [B,nc,Q,nh,P]
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", scores[:, :, None] * L, xdt)

    # chunk-final states: xdt weighted by the decay to the chunk's end
    decay_end = torch.exp(cs[..., -1:] - cs)  # [B,nc,nh,Q]
    S = torch.einsum("bckhp,bckn->bchpn",
                     xdt * decay_end.permute(0, 1, 3, 2)[..., None], Bc)

    # inter-chunk recurrence over the nc chunks
    a_sum = torch.exp(cs[..., -1])  # [B,nc,nh] total chunk decay
    h = (torch.zeros((Bsz, nh, P, N), dtype=_F32, device=x.device)
         if h0 is None else h0)
    h_in = []
    for c in range(nc):
        h_in.append(h)  # the state *entering* chunk c
        h = h * a_sum[:, c, :, None, None] + S[:, c]
    h_in = torch.stack(h_in, dim=1)  # [B,nc,nh,P,N]

    # inter-chunk contribution: C.h_in, then the decay from the chunk start
    decay_in = torch.exp(cs).permute(0, 1, 3, 2)  # [B,nc,Q,nh]
    y_off = torch.einsum("bcqn,bchpn->bcqhp", Cc, h_in) * decay_in[..., None]

    y = (y_diag + y_off).reshape(Bsz, nc * Q, nh, P)[:, :T]
    y = y + D[None, None, :, None] * x[:, :T]
    return y, h


# ---------------------------------------------------------------------------
# full mixer
# ---------------------------------------------------------------------------
def _split_proj(cfg: ModelConfig, zxbcdt):
    di, N = cfg.d_inner, cfg.ssm_state
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:2 * di + 2 * N]
    dt = zxbcdt[..., 2 * di + 2 * N:]
    return z, xBC, dt


def mamba_apply(cfg: ModelConfig, p: dict, u, cache=None):
    """u: [B,T,d] -> ([B,T,d], new cache or None).  Given ``cache``
    (prefill), the new cache holds the last K-1 pre-conv inputs (left-padded
    with zeros when T < K-1) and the final SSM state."""
    Bsz, T, _ = u.shape
    di, N, nh, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    zxbcdt = u @ p["in_proj"]
    z, xBC_pre, dt_raw = _split_proj(cfg, zxbcdt)
    xBC = F.silu(_causal_conv(xBC_pre, p["conv_w"], p["conv_b"]))
    x = xBC[..., :di].reshape(Bsz, T, nh, P).to(_F32)
    Bm = xBC[..., di:di + N].to(_F32)
    Cm = xBC[..., di + N:].to(_F32)
    dt = _softplus(dt_raw.to(_F32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, h_last = ssd_chunked(x, dt, A, Bm, Cm, p["D"], cfg.ssm_chunk)
    y = y.reshape(Bsz, T, di).to(u.dtype)
    y = rms_norm(y * F.silu(z), p["norm_w"])
    out = y @ p["out_proj"]
    new_cache = None
    if cache is not None:
        K = cfg.ssm_conv
        tail = xBC_pre[:, -(K - 1):]  # pre-conv stream feeds the decode conv
        pad = (K - 1) - tail.shape[1]
        if pad > 0:
            tail = F.pad(tail, (0, 0, pad, 0))
        new_cache = {"conv": tail.to(cfg.jdtype), "ssm": h_last}
    return out, new_cache


def mamba_step(cfg: ModelConfig, p: dict, u, cache):
    """u: [B,1,d], cache: {conv [B,K-1,ch], ssm [B,nh,P,N]} -> (out, new
    cache)."""
    Bsz = u.shape[0]
    di, N, nh, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xBC, dt_raw = _split_proj(cfg, u[:, 0] @ p["in_proj"])

    conv_in = torch.cat([cache["conv"].to(_F32), xBC[:, None].to(_F32)],
                        dim=1)
    xBC_c = (conv_in * p["conv_w"].to(_F32)).sum(dim=1)
    xBC_c = F.silu(xBC_c + p["conv_b"].to(_F32))

    x = xBC_c[:, :di].reshape(Bsz, nh, P)
    Bm = xBC_c[:, di:di + N]
    Cm = xBC_c[:, di + N:]
    dt = _softplus(dt_raw.to(_F32) + p["dt_bias"])  # [B,nh]
    A = -torch.exp(p["A_log"])

    decay = torch.exp(dt * A[None, :])
    upd = (x * dt[..., None])[..., None] * Bm[:, None, None, :]
    h = cache["ssm"] * decay[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", h, Cm) + p["D"][None, :, None] * x
    y = y.reshape(Bsz, di).to(u.dtype)
    y = rms_norm(y * F.silu(z), p["norm_w"])
    out = (y @ p["out_proj"])[:, None]
    new_conv = torch.cat([cache["conv"][:, 1:],
                          xBC[:, None].to(cfg.jdtype)], dim=1)
    return out, {"conv": new_conv, "ssm": h}


def mamba_cache_init(cfg: ModelConfig, batch: int, device=None) -> dict:
    di, N = cfg.d_inner, cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, di + 2 * N),
                            dtype=cfg.jdtype, device=device),
        "ssm": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                            cfg.ssm_state), dtype=_F32, device=device),
    }
