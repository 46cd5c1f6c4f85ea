"""The port's int8 KV cache (``kv_dtype="int8"``) against the JAX package.

``kv_quantize`` bit-equal (ties round half to even as ``jnp.round``);
``decode_attention_q8`` on random int8 caches, causal and ring, scalar and
per-row positions, with the integer products exact where their sums pass
2^24 (float32 integers end there, float64 ones at 2^53); the reduced
``qwen2-7b`` and ``hymba-1.5b`` (2 layers, d_model 64, head_dim 16,
float32, the reference's weights carried across) decoding greedily from an
int8 cache, against the reference and within the reference's own bounds
of the float cache (logits 0.08 of max |logit|, tokens 0.75 equal);
caches, scalar against vector positions and ``ServingEngine``.

Tolerances (float32): ``decode_attention_q8`` 1e-5, but for a row where
the two packages requantize one probability to neighbouring integers
(``_close_q8`` says why and holds that row to one step of one key); model
logits and scales 1e-4, as for the float cache; integer results, int8
payloads and served tokens equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget
from repro.configs import reduced_config as rreduced
from repro.launch import serve as rserve
from repro.models import layers as RL
from repro.models import transformer as RT
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduced_config as treduced
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

torch.set_num_threads(1)
ARCHS = ["qwen2-7b", "hymba-1.5b"]
_SMALL = dict(n_layers=2, d_model=64, d_ff=128, vocab_size=128, head_dim=16,
              dtype="float32")


@pytest.fixture(autouse=True)
def _jax_32_bit():
    with jax.enable_x64(False):
        yield


_MODELS: dict = {}


def _model(arch):
    """(reference cfg, port cfg, reference params, port params) of the
    int8-cache configuration; the float ones differ only in kv_dtype."""
    if arch not in _MODELS:
        with jax.enable_x64(False):
            rc = dataclasses.replace(rreduced(rget(arch), **_SMALL),
                                     kv_dtype="int8")
            tc = dataclasses.replace(treduced(tget(arch), **_SMALL),
                                     kv_dtype="int8")
            params = RT.init_lm(rc, jax.random.key(0))
            pnp = jax.tree.map(np.asarray, params)
        _MODELS[arch] = (rc, tc, params, TT.params_from_jax(pnp,
                                                           device="cpu"))
    return _MODELS[arch]


def _float(cfg):
    return dataclasses.replace(cfg, kv_dtype="bfloat16")


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _np(t):
    return t.detach().numpy()


# ---------------------------------------------------------------------------
# kv_quantize and the int8 decode attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quantize_bit_equal(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 3, 9, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero row: scale 1e-12 / 127
    # rows whose x / scale land on .5: half to even (0.5 -> 0, 2.5 -> 2)
    x[0, 1, 0] = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -3.5] + [0.0] * 10)
    xr = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    qr, sr = RL.kv_quantize(xr)
    qt, st = TL.kv_quantize(xt)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert (_np(qt) == np.asarray(qr)).all()
    assert (_np(st).view(np.int32) == np.asarray(sr).view(np.int32)).all()
    assert _np(qt)[0, 1, 0, :6].tolist() == [127, 0, 2, 2, 0, -4]


def test_int8_products_exact_past_2_24():
    """Sums of int8 products up to 2^25 and beyond, exact against int64;
    converted to float32 as the reference's int32 sums are."""
    rng = np.random.default_rng(2)
    D = 2080  # 2080 * 127 * 127 = 33,548,320 > 2^25
    a = np.full((1, 1, 1, 1, D), 127, np.int8)
    a[..., ::7] = -128 + 1
    b = np.full((1, 1, 3, D), 127, np.int8)
    b[0, 0, 1] = rng.integers(-127, 128, D).astype(np.int8)
    b[0, 0, 2, ::3] = -127
    want = np.einsum("bhgqd,bhkd->bhgqk", a.astype(np.int64),
                     b.astype(np.int64))
    assert np.abs(want).max() > 2 ** 24
    got = TL._int8_einsum("bhgqd,bhkd->bhgqk", torch.from_numpy(a),
                          torch.from_numpy(b))
    assert got.dtype == torch.float32
    ref = jnp.einsum("bhgqd,bhkd->bhgqk", jnp.asarray(a), jnp.asarray(b),
                     preferred_element_type=jnp.int32).astype(jnp.float32)
    assert (_np(got) == np.asarray(ref)).all()
    assert (_np(got) == want.astype(np.float32)).all()


def _close_q8(got, want, vq, vs):
    """``decode_attention_q8``'s outputs within 1e-5, except in a row
    where the two requantize one probability to neighbouring integers.
    The softmax's ``exp`` differs in the last bits between XLA and torch
    (the scores are bit-equal), so a p*vs / p_scale that lands within an
    ulp of a half step rounds either way; that row then differs by one key's
    value row ``vq[k]`` times one step ``p_scale <= max(vs) / 127``.  At
    most one such key a row, in at most a tenth of the rows."""
    got, want = _np(got), np.asarray(want)
    B, H, _, D = got.shape
    Hkv = vq.shape[1]
    bad = 0
    for b in range(B):
        for h in range(H):
            d = (want[b, h, 0] - got[b, h, 0]).astype(np.float64)
            if (np.abs(d) <= 1e-5 + 1e-5 * np.abs(want[b, h, 0])).all():
                continue
            bad += 1
            rows = vq[b, h // (H // Hkv)].astype(np.float64)  # [S, D]
            c = rows @ d / np.maximum((rows * rows).sum(-1), 1.0)
            resid = np.abs(d[None, :] - c[:, None] * rows).max(-1)
            k = int(np.argmin(resid))
            assert resid[k] <= 2e-5, (b, h, d)
            assert 0 < abs(c[k]) <= vs[b, h // (H // Hkv)].max() / 127 * (
                1 + 1e-5), (b, h, c[k])
    assert bad <= B * H // 10, bad


def _q8_case(seed, B, H, Hkv, S, D, big=False):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, 1, D)).astype(np.float32)
    kq = rng.integers(-127, 128, (B, Hkv, S, D)).astype(np.int8)
    vq = rng.integers(-127, 128, (B, Hkv, S, D)).astype(np.int8)
    ks = rng.uniform(0.001, 0.02, (B, Hkv, S, 1)).astype(np.float32)
    vs = rng.uniform(0.001, 0.02, (B, Hkv, S, 1)).astype(np.float32)
    if big:
        # |q| near 1 everywhere, so q quantizes to +-126..127, and half the
        # keys along the first query head's signs: |q.k| near D * 127^2;
        # tiny key scales and equal value scales spread p evenly, so p
        # requantizes to 126..127 and the P.V sums reach S * 127^2
        q = (np.sign(q) * rng.uniform(0.99, 1.0, q.shape)).astype(np.float32)
        kq[:, :, :S // 2] = 127 * np.sign(q[:, ::H // Hkv]).astype(np.int8)
        vq[:] = 127
        ks[:] = 1e-7
        vs[:] = 0.01
    return q, kq, ks, vq, vs


@pytest.mark.parametrize("pos", [40, [40, 7, 63]])
@pytest.mark.parametrize("window", [0, 16])
def test_decode_attention_q8_causal(pos, window):
    q, kq, ks, vq, vs = _q8_case(3, 3, 8, 2, 64, 16)
    p = np.asarray(pos, np.int32)
    want = RL.decode_attention_q8(*map(jnp.asarray, (q, kq, ks, vq, vs)),
                                  jnp.asarray(p), window=window)
    got = TL.decode_attention_q8(*map(torch.from_numpy, (q, kq, ks, vq, vs)),
                                 torch.from_numpy(p), window=window)
    assert got.dtype == torch.float32
    _close_q8(got, want, vq, vs)


@pytest.mark.parametrize("slot,length", [(5, 6), (31, 32), ([5, 0, 31],
                                                             [6, 32, 32])])
def test_decode_attention_q8_ring(slot, length):
    q, kq, ks, vq, vs = _q8_case(4, 3, 8, 2, 32, 16)
    want = RL.decode_attention_q8(*map(jnp.asarray, (q, kq, ks, vq, vs)),
                                  None, ring_slot=jnp.asarray(slot),
                                  ring_len=jnp.asarray(length))
    got = TL.decode_attention_q8(*map(torch.from_numpy, (q, kq, ks, vq, vs)),
                                 None, ring_slot=torch.as_tensor(slot),
                                 ring_len=torch.as_tensor(length))
    _close_q8(got, want, vq, vs)


def test_decode_attention_q8_large_integer_sums():
    """D = 1100 and S = 1100: both integer products pass 2^24."""
    q, kq, ks, vq, vs = _q8_case(5, 1, 4, 1, 1100, 1100, big=True)
    qq, _ = TL.kv_quantize(torch.from_numpy(q).reshape(1, 1, 4, 1, 1100))
    s_int = np.einsum("bhgqd,bhkd->bhgqk", _np(qq).astype(np.int64),
                      kq.astype(np.int64))
    assert np.abs(s_int).max() > 2 ** 24
    want = RL.decode_attention_q8(*map(jnp.asarray, (q, kq, ks, vq, vs)),
                                  1099)
    got = TL.decode_attention_q8(*map(torch.from_numpy, (q, kq, ks, vq, vs)),
                                 1099)
    # every output is a P.V sum past 2^24 times p_scale
    assert float(got.abs().min()) * 127 / 0.01 > 2 ** 24 / 1100
    _close_q8(got, want, vq, vs)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------
def _greedy(module, cfg, params, prompt, n=8, max_len=64):
    """Greedy decode of ``prompt`` ([1, T] int32 numpy): (tokens, logits
    [n, V] numpy)."""
    wrap = jnp.asarray if module is RT else torch.from_numpy
    logits, caches = module.prefill(cfg, params, wrap(prompt),
                                    max_len=max_len)
    rows = [np.asarray(logits[0]) if module is RT else _np(logits[0])]
    toks = [int(np.argmax(rows[-1]))]
    pos = prompt.shape[1]
    for _ in range(n - 1):
        tok = wrap(np.asarray([[toks[-1]]], np.int32))
        logits, caches = module.decode_step(cfg, params, tok, caches, pos)
        rows.append(np.asarray(logits[0]) if module is RT
                    else _np(logits[0]))
        toks.append(int(np.argmax(rows[-1])))
        pos += 1
    return toks, np.stack(rows), caches


@pytest.mark.parametrize("arch", ARCHS)
def test_kv8_greedy_decode_matches_reference(arch):
    """Hymba's 40-token prompt prefills its ring rolled and decodes across
    the wrap (window 32)."""
    rc, tc, params, tparams = _model(arch)
    prompt = np.random.default_rng(6).integers(2, 128, (1, 40)).astype(
        np.int32)
    rt, rlog, rcache = _greedy(RT, rc, params, prompt)
    tt, tlog, tcache = _greedy(TT, tc, tparams, prompt)
    assert tt == rt
    _close(tlog, rlog, 1e-4)
    for tc_, rc_ in zip(tcache, rcache):
        for name in ("k", "v"):
            assert (_np(tc_["attn"][name])
                    == np.asarray(rc_["attn"][name])).all()
        for name in ("ks", "vs"):
            _close(_np(tc_["attn"][name]), rc_["attn"][name], 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_kv8_decode_close_to_float(arch):
    """The reference's own bounds on the int8 cache's error (its
    ``test_kv8.py``), held on the port."""
    _, tc, _, tparams = _model(arch)
    prompt = np.random.default_rng(1).integers(2, 128, (1, 12)).astype(
        np.int32)
    t8, l8, _ = _greedy(TT, tc, tparams, prompt)
    tf, lf, _ = _greedy(TT, _float(tc), tparams, prompt)
    err = np.abs(lf - l8).max() / np.abs(lf).max()
    assert err < 0.08, err
    assert np.mean([a == b for a, b in zip(tf, t8)]) >= 0.75, (tf, t8)


@pytest.mark.parametrize("arch", ARCHS)
def test_kv8_caches(arch):
    """int8 payloads, float32 scales, and (1 + 4/hd) / 2 of the float
    (bf16) cache's bytes, equal to the reference's layout."""
    rc, tc, _, _ = _model(arch)
    rcache = RT.init_caches(rc, 2, 48)
    tcache = TT.init_caches(tc, 2, 48, device="cpu")
    bf16 = TT.init_caches(dataclasses.replace(_float(tc), dtype="bfloat16"),
                          2, 48, device="cpu")
    for t8, r8, tb in zip(tcache, rcache, bf16):
        a = t8["attn"]
        assert (a["k"].dtype, a["v"].dtype) == (torch.int8, torch.int8)
        assert (a["ks"].dtype, a["vs"].dtype) == (torch.float32,) * 2
        for name in a:
            assert tuple(a[name].shape) == r8["attn"][name].shape
        n8 = sum(t.nbytes for t in a.values())
        nb = sum(t.nbytes for t in tb["attn"].values())
        assert n8 * 2 * tc.hd == nb * (tc.hd + 4)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_do_not_read_the_cache(arch):
    """The prefill attends to the float keys and values; only the cache
    is quantized.  So the int8 configuration's prefill logits equal the
    float one's, and its payload is ``kv_quantize`` of the float cache."""
    _, tc, _, tparams = _model(arch)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        2, 128, (2, 45)).astype(np.int32))
    l8, c8 = TT.prefill(tc, tparams, toks, max_len=64)
    lf, cf = TT.prefill(_float(tc), tparams, toks, max_len=64)
    assert torch.equal(l8, lf)
    for a8, af in zip(c8, cf):
        n = min(45, a8["attn"]["k"].shape[3])
        for name, scale in (("k", "ks"), ("v", "vs")):
            q, s = TL.kv_quantize(af["attn"][name][:, :, :, :n])
            assert torch.equal(a8["attn"][name][:, :, :, :n], q)
            assert torch.equal(a8["attn"][scale][:, :, :, :n], s)


@pytest.mark.parametrize("arch", ARCHS)
def test_vector_positions_match_scalar(arch):
    """A uniform per-row position vector gives the scalar path's logits and
    caches, byte for byte, on int8 caches (full and ring)."""
    _, tc, _, tparams = _model(arch)
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        2, 128, (2, 6)).astype(np.int32))
    toks = torch.tensor([[3], [4]], dtype=torch.int32)
    outs = []
    for pos in (6, torch.full((2,), 6, dtype=torch.int32)):
        _, caches = TT.prefill(tc, tparams, prompt, max_len=32)
        outs.append(TT.decode_step(tc, tparams, toks, caches, pos))
    (ls, cs), (lv, cv) = outs
    assert torch.equal(ls, lv)
    for a, b in zip(cs, cv):
        for name in a["attn"]:
            assert torch.equal(a["attn"][name], b["attn"][name])


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_engine_matches_reference(arch):
    rc, tc, params, tparams = _model(arch)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(2, 128, n).astype(np.int32)
               for n in (28, 5, 40, 13)]
    out = {}
    for mod, cfg, p, kw in ((rserve, rc, params, {}),
                            (tserve, tc, tparams, {"device": "cpu"})):
        eng = mod.ServingEngine(cfg, p, max_batch=2, max_len=64, **kw)
        for i, pr in enumerate(prompts):
            eng.submit(mod.Request(rid=i, prompt=pr, max_tokens=8))
        out[mod] = {r.rid: r.out for r in eng.run()}
    assert len(out[tserve]) == 4
    assert out[tserve] == out[rserve]
