"""Transformer building blocks (the port of ``repro.models.layers``).

Parameters are plain dicts of tensors, as the reference's pytrees.  On the
CPU, :func:`flash_attention` is the reference's tiled scan (causal, banded
``window``, ``q_offset``, ``kv_valid``); on a CUDA device the LM's full
prefill (``window == 0``, ``q_offset == 0``, no ``kv_valid``) runs the
hand-written flash-attention kernel through
:func:`repro_torch.kernels.ops.flash_attention`, and any other argument
raises.  KV caches are bfloat16 (``cfg.kv_dtype``) dicts ``{"k", "v"}`` of
``[B, Hkv, W, D]``; prefill and decode write them in place (and return
them) instead of building new arrays as the reference does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops

__all__ = ["dense_init", "embed_init", "rms_norm", "layer_norm", "norm_init",
           "apply_norm", "rope_freqs", "apply_rope", "attention_init",
           "flash_attention", "decode_attention", "attention_apply",
           "attention_cache_init", "mlp_init", "mlp_apply"]

_HYBRID_ITEM = ("ROADMAP Queue 1, the hybrid/SWA slice (banded attention, "
                "ring-buffer decode, the int8 KV cache)")
_F32 = torch.float32


# ---------------------------------------------------------------------------
# init helpers: drawn in float32 from ``generator``, then cast to ``dtype``
# ---------------------------------------------------------------------------
def _normal(generator, shape, device):
    return torch.randn(shape, generator=generator, dtype=_F32, device=device)


def dense_init(generator, d_in: int, d_out: int, dtype, device=None):
    return (_normal(generator, (d_in, d_out), device)
            / math.sqrt(d_in)).to(dtype)


def embed_init(generator, v: int, d: int, dtype, device=None):
    return (_normal(generator, (v, d), device) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rms_norm(x, w, eps: float = 1e-6):
    xf = x.to(_F32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * w.to(_F32)).to(x.dtype)


def layer_norm(x, w=None, b=None, eps: float = 1e-5):
    xf = x.to(_F32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    if w is not None:
        out = out * w.to(_F32)
    if b is not None:
        out = out + b.to(_F32)
    return out.to(x.dtype)


def norm_init(cfg: ModelConfig, device=None) -> dict:
    dt = cfg.jdtype
    if cfg.norm == "rmsnorm":
        return {"w": torch.ones(cfg.d_model, dtype=dt, device=device)}
    if cfg.norm == "layernorm":
        return {"w": torch.ones(cfg.d_model, dtype=dt, device=device),
                "b": torch.zeros(cfg.d_model, dtype=dt, device=device)}
    if cfg.norm == "layernorm_np":  # OLMo: non-parametric
        return {}
    raise ValueError(cfg.norm)


def apply_norm(cfg: ModelConfig, p: dict, x):
    if cfg.norm == "rmsnorm":
        return rms_norm(x, p["w"])
    if cfg.norm == "layernorm":
        return layer_norm(x, p["w"], p["b"])
    return layer_norm(x)


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------
def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=_F32, device=device)
                            / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, H, T, D]; positions: [B, T] or [T]."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    if positions.ndim == 1:
        positions = positions[None, :]
    angles = positions[..., None].to(_F32) * freqs  # [B, T, D/2]
    cos = torch.cos(angles)[:, None, :, :]
    sin = torch.sin(angles)[:, None, :, :]
    x1, x2 = torch.chunk(x.to(_F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def attention_init(cfg: ModelConfig, generator, device=None) -> dict:
    dt = cfg.jdtype
    d, hd, H, Hkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": dense_init(generator, d, H * hd, dt, device),
        "wk": dense_init(generator, d, Hkv * hd, dt, device),
        "wv": dense_init(generator, d, Hkv * hd, dt, device),
        "wo": dense_init(generator, H * hd, d, dt, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(H * hd, dtype=dt, device=device)
        p["bk"] = torch.zeros(Hkv * hd, dtype=dt, device=device)
        p["bv"] = torch.zeros(Hkv * hd, dtype=dt, device=device)
    return p


def _qkv(cfg: ModelConfig, p: dict, x, positions):
    B, T, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, T, H, hd).transpose(1, 2)
    k = k.reshape(B, T, Hkv, hd).transpose(1, 2)
    v = v.reshape(B, T, Hkv, hd).transpose(1, 2)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _einsum_f32(eq, a, b):
    """``einsum`` of two operands with float32 accumulation and result (the
    reference's ``preferred_element_type=float32``)."""
    return torch.einsum(eq, a.to(_F32), b.to(_F32))


def _tile_attn(q, k, v, qpos, kpos, window: int):
    """One (Q-tile, KV-strip) flash step.  q:[B,Hkv,G,qc,D] k/v:[B,Hkv,kc,D].
    Returns (scores-max m, exp-sum l, weighted acc)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = _einsum_f32("bhgqd,bhkd->bhgqk", q, k) * scale
    mask = kpos[None, :] <= qpos[:, None]
    if window > 0:
        mask &= kpos[None, :] > qpos[:, None] - window
    s = torch.where(mask[None, None, None], s, -torch.inf)
    m = torch.amax(s, dim=-1)
    # guard fully-masked rows (padding tiles)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isfinite(s), p, 0.0)
    l = torch.sum(p, dim=-1)
    acc = _einsum_f32("bhgqk,bhkd->bhgqd", p.to(v.dtype), v)
    return m_safe, l, acc


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset=0, kv_valid=None, q_chunk: int = 1024,
                    kv_chunk: int = 1024):
    """Tiled flash attention (GQA): q [B, H, Tq, D], k/v [B, Hkv, Tk, D].

    On a CUDA device only the full prefill (``window == 0``,
    ``q_offset == 0``, ``kv_valid is None``) is available, through the
    flash-attention kernel; anything else raises ``NotImplementedError``.
    On the CPU this is the reference's scan; ``window > 0`` takes the
    banded path (a fixed ``window + q_chunk`` KV strip per Q tile).
    """
    if q.device.type != "cpu":
        if window > 0 or not _is_zero(q_offset) or kv_valid is not None:
            raise NotImplementedError(
                "on a GPU, flash_attention runs the full causal/non-causal "
                "prefill only (window=0, q_offset=0, kv_valid=None); the "
                f"other variants wait for {_HYBRID_ITEM}")
        return ops.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=causal).to(v.dtype)
    B, H, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    G = H // Hkv
    q_chunk = min(q_chunk, Tq)
    kv_chunk = min(kv_chunk, Tk)

    pad_q = (-Tq) % q_chunk
    if pad_q:
        q = F.pad(q, (0, 0, 0, pad_q))
    Tqp = q.shape[2]
    qg = q.reshape(B, Hkv, G, Tqp, D)
    nq = Tqp // q_chunk
    kv_valid = Tk if kv_valid is None else kv_valid
    big = torch.iinfo(torch.int32).max
    tiles = []

    if window > 0:
        # banded: strip width rounded up to kv_chunk multiple
        strip = int(math.ceil((window + q_chunk) / kv_chunk)) * kv_chunk
        strip = min(strip, Tk)
        for i in range(nq):
            qi = qg[:, :, :, i * q_chunk:(i + 1) * q_chunk]
            qpos = i * q_chunk + torch.arange(q_chunk) + q_offset
            start = int(min(max(i * q_chunk + q_offset - (strip - q_chunk), 0),
                            Tk - strip))
            ks, vs = k[:, :, start:start + strip], v[:, :, start:start + strip]
            kpos = start + torch.arange(strip)
            kpos = torch.where(kpos < kv_valid, kpos, big)
            m, l, acc = _tile_attn(qi, ks, vs, qpos, kpos, window)
            tiles.append(acc / torch.clamp_min(l, 1e-30)[..., None])
    else:
        pad_k = (-Tk) % kv_chunk
        if pad_k:
            k = F.pad(k, (0, 0, 0, pad_k))
            v = F.pad(v, (0, 0, 0, pad_k))
        nk = k.shape[2] // kv_chunk
        for i in range(nq):
            qi = qg[:, :, :, i * q_chunk:(i + 1) * q_chunk]
            qpos = i * q_chunk + torch.arange(q_chunk) + q_offset
            if not causal:
                qpos = torch.full_like(qpos, big // 2)
            m = torch.full((B, Hkv, G, q_chunk), -torch.inf, dtype=_F32)
            l = torch.zeros((B, Hkv, G, q_chunk), dtype=_F32)
            acc = torch.zeros((B, Hkv, G, q_chunk, D), dtype=_F32)
            for j in range(nk):
                kj = k[:, :, j * kv_chunk:(j + 1) * kv_chunk]
                vj = v[:, :, j * kv_chunk:(j + 1) * kv_chunk]
                kpos = j * kv_chunk + torch.arange(kv_chunk)
                kpos = torch.where(kpos < kv_valid, kpos, big)
                mj, lj, accj = _tile_attn(qi, kj, vj, qpos, kpos, 0)
                m_new = torch.maximum(m, mj)
                c1 = torch.exp(m - m_new)
                c2 = torch.exp(mj - m_new)
                m, l = m_new, l * c1 + lj * c2
                acc = acc * c1[..., None] + accj * c2[..., None]
            tiles.append(acc / torch.clamp_min(l, 1e-30)[..., None])

    out = torch.cat(tiles, dim=3)  # [B, Hkv, G, Tqp, D]
    out = out.reshape(B, H, Tqp, D)[:, :, :Tq]
    return out.to(v.dtype)


def _is_zero(x) -> bool:
    return bool(torch.all(torch.as_tensor(x) == 0))


def _decode_mask(pos, S: int, window: int = 0):
    """Causal key mask for single-token decode: ``[1,1,1,1,S]`` for a
    scalar position shared by the batch, ``[B,1,1,1,S]`` for an int32
    ``[B]`` vector of per-row positions (continuous batching decodes
    each slot at its OWN position)."""
    pos = torch.as_tensor(pos)
    kpos = torch.arange(S, device=pos.device)
    if pos.ndim > 0:
        mask = kpos[None, :] <= pos[:, None]
        if window > 0:
            mask &= kpos[None, :] > pos[:, None] - window
        return mask[:, None, None, None, :]
    mask = kpos <= pos
    if window > 0:
        mask &= kpos > pos - window
    return mask[None, None, None, None]


def _cache_row_update(cache_arr, new_vals, slot):
    """Write each batch row's single-position update at its OWN cache slot,
    in place: ``cache_arr`` [B,Hkv,W,*], ``new_vals`` [B,Hkv,1,*], ``slot``
    int32 [B] (clamped to the cache like the reference's
    ``dynamic_update_slice``).  Returns ``cache_arr``."""
    B, _, W = cache_arr.shape[:3]
    slot = torch.clamp(slot.to(torch.int64), 0, W - 1).to(cache_arr.device)
    rows = torch.arange(B, device=cache_arr.device)
    cache_arr[rows, :, slot] = new_vals[:, :, 0].to(cache_arr.dtype)
    return cache_arr


def decode_attention(q, k_cache, v_cache, pos, window: int = 0):
    """Single-token attention over a [B,Hkv,S,D] cache; pos = current
    index (scalar, or int32 [B] per-row positions)."""
    B, H, _, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, 1, D)
    scale = 1.0 / math.sqrt(D)
    s = _einsum_f32("bhgqd,bhkd->bhgqk", qg, k_cache) * scale
    s = torch.where(_decode_mask(pos, S, window).to(s.device), s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    out = _einsum_f32("bhgqk,bhkd->bhgqd", p.to(v_cache.dtype), v_cache)
    return out.reshape(B, H, 1, D).to(v_cache.dtype)


def attention_apply(cfg, p, x, positions, *, window=0, cache=None,
                    cache_pos=None):
    """Returns (out [B,T,d], cache or None).

    cache: dict(k=[B,Hkv,W,D], v=...), written in place — decode writes
    position ``cache_pos`` (an int, or an int32 ``[B]`` vector of per-slot
    positions); prefill writes the prompt's keys and values from slot 0.
    """
    if cfg.kv_dtype == "int8":
        raise NotImplementedError(
            f"the int8 KV cache waits for {_HYBRID_ITEM}")
    if cache is not None and window > 0:
        raise NotImplementedError(
            f"sliding-window (ring) caches wait for {_HYBRID_ITEM}")
    B, T, _ = x.shape
    q, k, v = _qkv(cfg, p, x, positions)
    if cache is not None and T == 1:
        per_row = torch.as_tensor(cache_pos).ndim > 0
        if per_row:
            slot = torch.as_tensor(cache_pos, dtype=torch.int32).reshape(-1)
            _cache_row_update(cache["k"], k, slot)
            _cache_row_update(cache["v"], v, slot)
        else:
            W = cache["k"].shape[2]
            s0 = min(max(int(cache_pos), 0), W - 1)
            cache["k"][:, :, s0:s0 + 1] = k.to(cache["k"].dtype)
            cache["v"][:, :, s0:s0 + 1] = v.to(cache["v"].dtype)
        out = decode_attention(q, cache["k"], cache["v"], cache_pos, window=0)
    else:
        out = flash_attention(q, k, v, causal=True, window=window,
                              q_chunk=cfg.attn_chunk_q,
                              kv_chunk=cfg.attn_chunk_kv)
        if cache is not None:  # prefill into cache
            cache["k"][:, :, :T] = k.to(cache["k"].dtype)
            cache["v"][:, :, :T] = v.to(cache["v"].dtype)
    Tq = out.shape[2]
    out = out.transpose(1, 2).reshape(B, Tq, cfg.n_heads * cfg.hd)
    return out @ p["wo"], cache


def attention_cache_init(cfg: ModelConfig, batch: int, seq_len: int,
                         window: int, device=None) -> dict:
    if cfg.kv_dtype == "int8":
        raise NotImplementedError(
            f"the int8 KV cache waits for {_HYBRID_ITEM}")
    W = min(window, seq_len) if window > 0 else seq_len
    shape = (batch, cfg.n_kv_heads, W, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.jdtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.jdtype, device=device)}


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def mlp_init(cfg: ModelConfig, generator, d_ff: int | None = None,
             device=None) -> dict:
    dt = cfg.jdtype
    ff = d_ff or cfg.d_ff
    if cfg.act == "swiglu":
        return {
            "wi": dense_init(generator, cfg.d_model, ff, dt, device),
            "wg": dense_init(generator, cfg.d_model, ff, dt, device),
            "wo": dense_init(generator, ff, cfg.d_model, dt, device),
        }
    return {
        "wi": dense_init(generator, cfg.d_model, ff, dt, device),
        "wo": dense_init(generator, ff, cfg.d_model, dt, device),
    }


def mlp_apply(cfg: ModelConfig, p: dict, x):
    if cfg.act == "swiglu":
        return (F.silu(x @ p["wg"]) * (x @ p["wi"])) @ p["wo"]
    return F.gelu(x @ p["wi"], approximate="tanh") @ p["wo"]
