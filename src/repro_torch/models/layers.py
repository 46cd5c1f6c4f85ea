"""Transformer building blocks (the port of ``repro.models.layers``).

Parameters are plain dicts of tensors, as the reference's pytrees.
:func:`flash_attention` is the reference's tiled scan (causal, banded
``window``, ``q_offset``, ``kv_valid``) on the CPU, and the banded
(sliding-window) prefill on any device; on a CUDA device the full prefill
(``window == 0``, ``q_offset == 0``, no ``kv_valid``) runs the hand-written
flash-attention kernel through :func:`repro_torch.kernels.ops.flash_attention`,
and ``q_offset`` or ``kv_valid`` raise; a forward that needs the gradient
takes the scan on every device.  KV caches are dicts ``{"k", "v"}``
of ``[B, Hkv, W, D]`` in ``cfg.dtype`` or, for ``cfg.kv_dtype == "int8"``,
int8 payloads with float32 per-(position, head) scales ``{"ks", "vs"}`` of
``[B, Hkv, W, 1]``; a sliding-window layer's cache is a ring of
``W = min(window, seq_len)`` slots (absolute position p at slot p % W).
Prefill and decode write the caches in place (and return them) instead of
building new arrays as the reference does.

On DTensor operands (a step sharded over a mesh) :func:`flash_attention`,
:func:`decode_attention_q8` and, over a cache whose length is not split,
the bf16 decode attention run through ``local_map`` on each rank's batch
and head shards (:func:`_local_heads`): heads and batch rows are
independent, so each rank's local attention is exact, and the CUDA kernel
runs on the local shard.  A cache split along its length (sequence
parallelism) is attended by DTensor's own ops (a softmax over the split).
Cache writes into a DTensor cache go to each rank's own part of the slot
range (:func:`_write_slots`).
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import is_dtensor
from repro_torch.distributed.trace_analysis import note_loop
from repro_torch.kernels import ops

__all__ = ["dense_init", "embed_init", "rms_norm", "layer_norm", "norm_init",
           "apply_norm", "rope_freqs", "apply_rope", "attention_init",
           "flash_attention", "decode_attention", "attention_apply",
           "attention_cache_init", "kv_quantize", "decode_attention_q8",
           "mlp_init", "mlp_apply"]

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
        return rms_norm(x, p["w"], cfg.norm_eps)
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


def _split_heads(t, B: int, T: int, n: int, hd: int):
    """``[B, T, n * hd]`` -> ``[B, n, T, hd]``.  A DTensor split on its
    last dim over a mesh dim whose size does not divide ``n`` (qwen2-7b's
    28 heads, or 4 KV heads, over a 16-wide ``model`` axis) is first
    gathered on that mesh dim: DTensor cannot view a split dim into heads
    that cross shard boundaries, where GSPMD reshards in the reference."""
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate

        mesh = t.device_mesh
        pls = [Replicate() if p.is_shard(t.ndim - 1) and n % mesh.size(i)
               else p for i, p in enumerate(t.placements)]
        if pls != list(t.placements):
            t = t.redistribute(mesh, pls)
    return t.reshape(B, T, n, hd).transpose(1, 2)


def _merge_heads(out, n: int, wo):
    """``[B, n, T, hd]`` -> ``[B, T, n * hd]``.  On a DTensor whose heads
    :func:`_split_heads` gathered over a mesh dim that splits the rows of
    ``wo`` (the output projection), the merged dim is split there again: a
    local slice, whose backward gathers the gradient before it is viewed
    back into heads (DTensor cannot view a gradient split off the head
    boundaries)."""
    B, _, T, hd = out.shape
    out = out.transpose(1, 2).reshape(B, T, n * hd)
    if is_dtensor(out) and is_dtensor(wo):
        from torch.distributed.tensor import Shard

        mesh = out.device_mesh
        pls = [Shard(2) if po.is_replicate() and pw.is_shard(wo.ndim - 2)
               and n % mesh.size(i) else po
               for i, (po, pw) in enumerate(zip(out.placements,
                                                wo.placements))]
        if pls != list(out.placements):
            out = out.redistribute(mesh, pls)
    return out


def _qkv(cfg: ModelConfig, p: dict, x, positions):
    B, T, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = _split_heads(q, B, T, H, hd)
    k = _split_heads(k, B, T, Hkv, hd)
    v = _split_heads(v, B, T, Hkv, hd)
    if cfg.position_embedding == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _einsum_f32(eq, a, b):
    """``einsum`` of two operands with float32 accumulation and result (the
    reference's ``preferred_element_type=float32``)."""
    return torch.einsum(eq, a.to(_F32), b.to(_F32))


def _tile_attn(q, k, v, qpos, kpos, window: int, scale=None):
    """One (Q-tile, KV-strip) flash step.  q:[B,Hkv,G,qc,D] k/v:[B,Hkv,kc,D].
    Returns (scores-max m, exp-sum l, weighted acc)."""
    if scale is None:
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
                    kv_chunk: int = 1024, scale: float | None = None):
    """Tiled flash attention (GQA): q [B, H, Tq, D], k/v [B, Hkv, Tk, D];
    the scores scaled by ``scale`` (None: ``1/sqrt(D)``).

    On a CUDA device the full prefill (``window == 0``) runs the
    flash-attention kernel, and ``q_offset`` or ``kv_valid`` raise
    ``NotImplementedError`` (``meta`` tensors, the dry run's, take the
    same path).  Otherwise this is the reference's scan, on the operands'
    device; ``window > 0`` takes the banded path (a fixed
    ``window + q_chunk`` KV strip per Q tile), which the reference also
    computes outside its Pallas kernel.

    Under grad mode with an operand that requires grad (a training
    forward) the scan runs on every device: the kernel has no backward,
    as the reference's Pallas kernel has none, and the reference's train
    step differentiates this same scan.  The kernel wrapper refuses such
    operands, so no path can detach attention from its gradient.
    """
    if is_dtensor(q):
        return _local_heads(functools.partial(
            flash_attention, causal=causal, window=window, q_offset=q_offset,
            kv_valid=kv_valid, q_chunk=q_chunk, kv_chunk=kv_chunk,
            scale=scale), q, k, v)
    dev = q.device
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    if dev.type != "cpu" and not needs_grad:
        if not _is_zero(q_offset) or kv_valid is not None:
            raise NotImplementedError(
                "on a GPU, flash_attention runs the prefill from position 0 "
                "over every key (q_offset=0, kv_valid=None)")
        if window == 0:
            # the scale only where the caller sets one: the kernel's own
            # default is 1/sqrt(D)
            kw = {} if scale is None else {"scale": scale}
            return ops.flash_attention(q.contiguous(), k.contiguous(),
                                       v.contiguous(), causal=causal,
                                       **kw).to(v.dtype)
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

    def arange(n):
        return torch.arange(n, device=dev)

    if window > 0:
        # banded: strip width rounded up to kv_chunk multiple
        strip = int(math.ceil((window + q_chunk) / kv_chunk)) * kv_chunk
        strip = min(strip, Tk)
        note_loop("flash_attention/q_tiles", nq)
        for i in range(nq):
            qi = qg[:, :, :, i * q_chunk:(i + 1) * q_chunk]
            qpos = i * q_chunk + arange(q_chunk) + q_offset
            start = int(min(max(i * q_chunk + q_offset - (strip - q_chunk), 0),
                            Tk - strip))
            ks, vs = k[:, :, start:start + strip], v[:, :, start:start + strip]
            kpos = start + arange(strip)
            kpos = torch.where(kpos < kv_valid, kpos, big)
            m, l, acc = _tile_attn(qi, ks, vs, qpos, kpos, window, scale)
            tiles.append(acc / torch.clamp_min(l, 1e-30)[..., None])
    else:
        pad_k = (-Tk) % kv_chunk
        if pad_k:
            k = F.pad(k, (0, 0, 0, pad_k))
            v = F.pad(v, (0, 0, 0, pad_k))
        nk = k.shape[2] // kv_chunk
        note_loop("flash_attention/q_tiles", nq)
        note_loop("flash_attention/kv_tiles", nk)
        for i in range(nq):
            qi = qg[:, :, :, i * q_chunk:(i + 1) * q_chunk]
            qpos = i * q_chunk + arange(q_chunk) + q_offset
            if not causal:
                qpos = torch.full_like(qpos, big // 2)
            m = torch.full((B, Hkv, G, q_chunk), -torch.inf, dtype=_F32,
                           device=dev)
            l = torch.zeros((B, Hkv, G, q_chunk), dtype=_F32, device=dev)
            acc = torch.zeros((B, Hkv, G, q_chunk, D), dtype=_F32,
                              device=dev)
            for j in range(nk):
                kj = k[:, :, j * kv_chunk:(j + 1) * kv_chunk]
                vj = v[:, :, j * kv_chunk:(j + 1) * kv_chunk]
                kpos = j * kv_chunk + arange(kv_chunk)
                kpos = torch.where(kpos < kv_valid, kpos, big)
                mj, lj, accj = _tile_attn(qi, kj, vj, qpos, kpos, 0, scale)
                m_new = torch.maximum(m, mj)
                c1 = torch.exp(m - m_new)
                c2 = torch.exp(mj - m_new)
                m, l = m_new, l * c1 + lj * c2
                acc = acc * c1[..., None] + accj * c2[..., None]
            tiles.append(acc / torch.clamp_min(l, 1e-30)[..., None])

    out = torch.cat(tiles, dim=3)  # [B, Hkv, G, Tqp, D]
    out = out.reshape(B, H, Tqp, D)[:, :, :Tq]
    return out.to(v.dtype)



def _local_heads(fn, q, *kv, **kwargs):
    """``fn(q, *kv, **kwargs)`` on each rank's local shards, through
    ``local_map``: a mesh dim that splits q's batch (dim 0) or, where every
    operand's head count divides, its heads (dim 1) keeps that split for
    all the operands; every other mesh dim is replicated (sequence and
    head-size splits are gathered).  Rows and heads are independent, so
    the local results are the global result's shards.  The output is laid
    out like q's batch and head split."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    heads = [q.shape[1]] + [t.shape[1] for t in kv]
    target = []
    for i, pl in enumerate(q.placements):
        n = mesh.size(i)
        if pl == Shard(0):
            target.append(Shard(0))
        elif pl == Shard(1) and all(h % n == 0 for h in heads):
            heads = [h // n for h in heads]
            target.append(Shard(1))
        else:
            target.append(Replicate())
    return local_map(functools.partial(fn, **kwargs), out_placements=target,
                     in_placements=(target,) * (1 + len(kv)),
                     device_mesh=mesh, redistribute_inputs=True)(q, *kv)


def _splits(x, dim: int) -> bool:
    """A DTensor ``x`` is split on ``dim`` by some mesh dim."""
    from torch.distributed.tensor import Shard

    return is_dtensor(x) and Shard(dim) in x.placements


def _write_slots(dst, start: int, src) -> None:
    """``dst[:, :, start:start + n] = src`` in place (n = src.shape[2]),
    cast to dst's dtype.  A DTensor ``dst`` whose slot dim is sharded
    takes, on each rank, the part of the range its local shard holds."""
    n = src.shape[2]
    if not is_dtensor(dst):
        dst[:, :, start:start + n] = src.to(dst.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    mesh = dst.device_mesh
    want = tuple(Replicate() if p == Shard(2) or not p.is_shard() else p
                 for p in dst.placements)
    src = src.redistribute(mesh, want).to_local().to(dst.dtype)
    local = dst.to_local()
    shape, offset = compute_local_shape_and_global_offset(
        dst.shape, mesh, dst.placements)
    lo, hi = max(start, offset[2]), min(start + n, offset[2] + shape[2])
    if lo < hi:
        local[:, :, lo - offset[2]:hi - offset[2]] = \
            src[:, :, lo - start:hi - start]


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


def _ring_mask(ring_slot, ring_len, S: int):
    """Slot-age mask for SWA ring caches, scalar or per-row ``[B]``
    vector: the slot ``ring_slot`` holds the newest key, and the
    ``ring_len`` newest slots (ages ``(ring_slot - slot) mod S``, floor
    modulo) are attended."""
    ring_slot = torch.as_tensor(ring_slot)
    ring_len = torch.as_tensor(ring_len, device=ring_slot.device)
    kpos = torch.arange(S, device=ring_slot.device)
    if ring_slot.ndim > 0:
        age = torch.remainder(ring_slot[:, None] - kpos[None, :], S)
        return (age < ring_len[:, None])[:, None, None, None, :]
    age = torch.remainder(ring_slot - kpos, S)  # 0 = newest
    return (age < ring_len)[None, None, None, None]


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


def _cache_write(cache: dict, new: dict, slot) -> None:
    """Write the single-position leaves ``new`` ([B,Hkv,1,*] each) into
    ``cache`` in place, at ``slot``: an int shared by every row (clamped to
    the cache like ``dynamic_update_slice``) or an int32 ``[B]`` vector."""
    for name, val in new.items():
        if torch.is_tensor(slot):
            if is_dtensor(cache[name]):
                raise NotImplementedError(
                    "per-row decode positions on a sharded cache")
            _cache_row_update(cache[name], val, slot)
        else:
            W = cache[name].shape[2]
            _write_slots(cache[name], min(max(slot, 0), W - 1), val)


def _attend(q, k_cache, v_cache, mask, scale):
    """Single-token attention of q [B,H,1,D] over a [B,Hkv,S,D] cache
    under ``mask`` (broadcast to [B,Hkv,G,1,S]); float32 scores and
    products, the probabilities rounded to the cache's dtype for P.V;
    returns float32 [B,H,1,D]."""
    B, H, _, D = q.shape
    Hkv = k_cache.shape[1]
    qg = q.reshape(B, Hkv, H // Hkv, 1, D)
    s = _einsum_f32("bhgqd,bhkd->bhgqk", qg, k_cache) * scale
    s = torch.where(mask.to(s.device), s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    out = _einsum_f32("bhgqk,bhkd->bhgqd", p.to(v_cache.dtype), v_cache)
    return out.reshape(B, H, 1, D)


def decode_attention(q, k_cache, v_cache, pos, window: int = 0,
                     scale: float | None = None):
    """Single-token attention over a [B,Hkv,S,D] cache; pos = current
    index (scalar, or int32 [B] per-row positions); the scores scaled by
    ``scale`` (None: ``1/sqrt(D)``)."""
    if is_dtensor(q) and not _splits(k_cache, 2):
        return _local_heads(decode_attention, q, k_cache, v_cache, pos=pos,
                            window=window, scale=scale)
    S, D = k_cache.shape[2], q.shape[-1]
    out = _attend(q, k_cache, v_cache, _decode_mask(pos, S, window),
                  1.0 / math.sqrt(D) if scale is None else scale)
    return out.to(v_cache.dtype)


def attention_apply(cfg, p, x, positions, *, window=0, cache=None,
                    cache_pos=None):
    """Returns (out [B,T,d], cache or None).

    The cache (``attention_cache_init``) is written in place.  Decode
    writes position ``cache_pos`` (an int, or an int32 ``[B]`` vector of
    per-slot positions) at slot ``cache_pos % W`` of a sliding-window ring
    and at slot ``cache_pos`` otherwise.  Prefill writes the prompt's keys
    and values from slot 0; into a ring shorter than the prompt it writes
    the last W, rolled by ``T % W`` so that position p lies at slot p % W.
    An int8 cache takes ``kv_quantize`` of them.  The scores are scaled by
    ``cfg.attention_multiplier`` where the config sets one, else by
    ``1/sqrt(hd)``.  While tracing is on, a full-attention prefill counts
    its causal (query, key) pairs (``attn.prefill_pairs``) and a decode
    step the keys its rows attend (``attn.decode_pairs``).
    """
    B, T, _ = x.shape
    q, k, v = _qkv(cfg, p, x, positions)
    kv8 = cfg.kv_dtype == "int8"
    scale = cfg.attention_multiplier or None
    if cache is not None and T == 1:
        W = cache["k"].shape[2]
        if torch.as_tensor(cache_pos).ndim > 0:  # int32 [B] per-slot
            cache_pos = torch.as_tensor(cache_pos, dtype=torch.int32)
            cache_pos = cache_pos.reshape(-1).to(x.device)
            slot, ring_len = cache_pos, None
            if window > 0:
                slot = torch.remainder(cache_pos, W)
                ring_len = torch.clamp_max(cache_pos + 1, min(window, W))
        else:
            slot = cache_pos = int(cache_pos)
            ring_len = None
            if window > 0:
                slot, ring_len = cache_pos % W, min(cache_pos + 1, window, W)
        if kv8:
            kq, ks1 = kv_quantize(k)
            vq, vs1 = kv_quantize(v)
            _cache_write(cache, {"k": kq, "v": vq, "ks": ks1, "vs": vs1},
                         slot)
            ring = (dict(ring_slot=slot, ring_len=ring_len) if window > 0
                    else {})
            attend = decode_attention_q8
            if is_dtensor(q):
                attend = functools.partial(_local_heads, decode_attention_q8)
            out = attend(q, cache["k"], cache["ks"], cache["v"],
                         cache["vs"], pos=cache_pos, scale=scale, **ring)
        else:
            _cache_write(cache, {"k": k, "v": v}, slot)
            if window > 0:
                # ring buffer: positions are implicit; mask by slot age
                attend = _attend
                if is_dtensor(q) and not _splits(cache["k"], 2):
                    attend = functools.partial(_local_heads, _attend)
                out = attend(q, cache["k"], cache["v"],
                             mask=_ring_mask(slot, ring_len, W),
                             scale=scale or 1.0 / math.sqrt(cfg.hd))
            else:
                out = decode_attention(q, cache["k"], cache["v"], cache_pos,
                                       scale=scale)
                if tracing.enabled():
                    tracing.count("attn.decode_pairs", B * (cache_pos + 1)
                                  if isinstance(cache_pos, int)
                                  else (cache_pos + 1).sum())
        out = out.to(x.dtype)
    else:
        out = flash_attention(q, k, v, causal=True, window=window,
                              q_chunk=cfg.attn_chunk_q,
                              kv_chunk=cfg.attn_chunk_kv, scale=scale)
        if window == 0:
            tracing.count("attn.prefill_pairs", B * T * (T + 1) // 2)
        if cache is not None:  # prefill into cache
            W = cache["k"].shape[2]
            if window > 0 and W < T:
                # ring layout: absolute position p lives at slot p % W
                k = torch.roll(k[:, :, -W:], T % W, dims=2)
                v = torch.roll(v[:, :, -W:], T % W, dims=2)
            new = {"k": k, "v": v}
            if kv8:
                kq, ks1 = kv_quantize(k)
                vq, vs1 = kv_quantize(v)
                new = {"k": kq, "v": vq, "ks": ks1, "vs": vs1}
            for name, val in new.items():
                _write_slots(cache[name], 0, val)
    out = _merge_heads(out, cfg.n_heads, p["wo"])
    return out @ p["wo"], cache


def attention_cache_init(cfg: ModelConfig, batch: int, seq_len: int,
                         window: int, device=None) -> dict:
    W = min(window, seq_len) if window > 0 else seq_len
    shape = (batch, cfg.n_kv_heads, W, cfg.hd)
    if cfg.kv_dtype == "int8":
        # the paper's in-cache 8-bit layout for the KV cache: int8 payload
        # + per-(position, head) f32 scales (~1.5% overhead at hd=128)
        scales = shape[:3] + (1,)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "ks": torch.zeros(scales, dtype=_F32, device=device),
                "vs": torch.zeros(scales, dtype=_F32, device=device)}
    return {"k": torch.zeros(shape, dtype=cfg.jdtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.jdtype, device=device)}


# ---------------------------------------------------------------------------
# int8 KV cache helpers (kv_dtype="int8")
# ---------------------------------------------------------------------------
def _per_127(x: torch.Tensor) -> torch.Tensor:
    """``x / 127`` correctly rounded on every device: CUDA divides a tensor
    by a Python number as a product with its reciprocal, which can differ
    in the last bit, so the divisor is a tensor on x's device."""
    return x / torch.full((), 127.0, dtype=x.dtype, device=x.device)


def kv_quantize(x: torch.Tensor):
    """[B,Hkv,T,D] -> (int8 values, f32 [B,Hkv,T,1] per-(pos,head) scales):
    symmetric, max |x| to 127, rounded half to even as ``jnp.round``."""
    xf = x.to(_F32)
    scale = _per_127(torch.clamp_min(
        torch.amax(torch.abs(xf), dim=-1, keepdim=True), 1e-12))
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def _int8_einsum(eq: str, a, b):
    """``einsum`` of two int8 operands with the reference's int32
    accumulation, converted to float32: the products are summed in float64,
    where every partial sum is an integer below 2^53 and so exact in any
    order, then rounded to float32 as the int32 sum would be.  (The CPU's
    int8 ``einsum`` returns int8, and CUDA has no int8 batched matmul.)"""
    return torch.einsum(eq, a.to(torch.float64), b.to(torch.float64)).to(_F32)


def decode_attention_q8(q, kq, ks, vq, vs, pos, window: int = 0,
                        ring_slot=None, ring_len=None,
                        scale: float | None = None):
    """Single-token attention on an int8 cache, integer products throughout.

    QK^T runs int8 x int8 -> int32 (exact), scaled by the query's and the
    per-position key scales; the softmax probabilities absorb the
    per-position *value* scales and are requantized to int8 for the PV
    product.  ``ring_slot``/``ring_len`` mask a sliding-window ring by slot
    age; otherwise ``pos`` (and ``window``) mask causally.  The scores are
    scaled by ``scale`` (None: divided by ``sqrt(D)``).  Returns float32
    [B,H,1,D].
    """
    B, H, _, D = q.shape
    Hkv, S = kq.shape[1], kq.shape[2]
    qq, qs = kv_quantize(q.reshape(B, Hkv, H // Hkv, 1, D))
    s_int = _int8_einsum("bhgqd,bhkd->bhgqk", qq, kq)
    # scales: qs [B,Hkv,G,1,1] x ks [B,Hkv,S,1] -> [B,Hkv,1,1,S]
    s = s_int * qs * ks[..., 0][:, :, None, None, :]
    s = s / math.sqrt(D) if scale is None else s * scale
    if ring_slot is not None:  # SWA ring buffer: mask by slot age
        mask = _ring_mask(ring_slot, ring_len, S)
    else:
        mask = _decode_mask(pos, S, window)
    s = torch.where(mask.to(s.device), s, -torch.inf)
    p = torch.softmax(s, dim=-1)  # [B,Hkv,G,1,S]
    # fold per-position value scales into p, requantize rows to int8
    pv = p * vs[..., 0][:, :, None, None, :]
    p_scale = _per_127(torch.clamp_min(torch.amax(pv, dim=-1, keepdim=True),
                                       1e-12))
    pq = torch.clamp(torch.round(pv / p_scale), 0, 127).to(torch.int8)
    out = _int8_einsum("bhgqk,bhkd->bhgqd", pq, vq) * p_scale
    return out.reshape(B, H, 1, D)


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
