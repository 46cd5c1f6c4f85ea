"""The port's LM path against the JAX package at the reduced ``qwen2-7b``
configuration (2 layers, d_model 64, 4 query heads over 1 KV head, head_dim
16, float32), with the reference's weights carried across by
``params_from_jax``: configs, layers, attention variants, prefill, decode
with per-slot positions, and the continuous-batching ``ServingEngine``.

Tolerances (float32): layers and attention 1e-5; model logits and caches
1e-4 (two layers of float32 sums taken in another order); served tokens
equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as RREG
from repro.configs import get_config as rget
from repro.configs import reduced_config as rreduced
from repro.kernels.ref import flash_attention_ref
from repro.launch import serve as rserve
from repro.models import layers as RL
from repro.models import transformer as RT
from repro_torch.configs import REGISTRY as TREG
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduced_config as treduced
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

torch.set_num_threads(1)
ARCH = "qwen2-7b"


@pytest.fixture(autouse=True)
def _jax_32_bit():
    """Some reference test modules turn x64 on process-wide; the reference
    is held here in JAX's default 32-bit mode."""
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def model():
    with jax.enable_x64(False):
        rc, tc = rreduced(rget(ARCH)), treduced(tget(ARCH))
        params = RT.init_lm(rc, jax.random.key(0))
        pnp = jax.tree.map(np.asarray, params)
    return rc, tc, params, TT.params_from_jax(pnp, device="cpu")


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _np(t):
    return t.detach().numpy()


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(RREG))
def test_configs_equal_reference(name):
    r, t = rget(name), tget(name)
    assert dataclasses.asdict(r) == dataclasses.asdict(t)
    assert r.param_count() == t.param_count()
    assert r.active_param_count() == t.active_param_count()
    assert dataclasses.asdict(rreduced(r)) == dataclasses.asdict(treduced(t))
    assert t.jdtype == getattr(torch, r.dtype)
    assert sorted(TREG) == sorted(RREG)


def test_qwen2_7b_width():
    cfg = tget(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.d_ff, cfg.vocab_size) == (28, 3584, 28, 4, 128, 18944,
                                          152064)
    assert cfg.param_count() == 7_615_412_224
    assert cfg.rope_theta == 1e4  # the reference's value (see ROADMAP)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pos_kind", ["shared", "per_row"])
def test_apply_rope(pos_kind):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 4, 9, 16)).astype(np.float32)
    pos = (np.arange(9, dtype=np.int32) + 3 if pos_kind == "shared"
           else rng.integers(0, 100, size=(2, 9)).astype(np.int32))
    want = RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)
    _close(_np(got), want, 1e-5)


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm", "layernorm_np"])
def test_norms(norm):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3 + 1
    w = rng.normal(size=(64,)).astype(np.float32)
    b = rng.normal(size=(64,)).astype(np.float32)
    cfg_r = dataclasses.replace(rreduced(rget(ARCH)), norm=norm)
    cfg_t = dataclasses.replace(treduced(tget(ARCH)), norm=norm)
    p_r = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    p_t = {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
    want = RL.apply_norm(cfg_r, p_r, jnp.asarray(x))
    got = TL.apply_norm(cfg_t, p_t, torch.from_numpy(x))
    _close(_np(got), want, 1e-5)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_apply(model, act):
    rc, tc, params, tparams = model
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, 64)).astype(np.float32)
    p = {k: np.array(v[0]) for k, v in params["stages"][0]["mlp"].items()}
    cr, ct = (dataclasses.replace(c, act=act) for c in (rc, tc))
    want = RL.mlp_apply(cr, {k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x))
    got = TL.mlp_apply(ct, {k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x))
    _close(_np(got), want, 1e-5)


def test_attention_apply_without_cache(model):
    rc, tc, params, tparams = model
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 11, 64)).astype(np.float32)
    pr = jax.tree.map(lambda v: v[0], params["stages"][0]["attn"])
    pt = {k: v[0] for k, v in tparams["stages"][0]["attn"].items()}
    want, _ = RL.attention_apply(rc, pr, jnp.asarray(x), jnp.arange(11))
    got, cache = TL.attention_apply(tc, pt, torch.from_numpy(x),
                                    torch.arange(11))
    assert cache is None
    _close(_np(got), want, 1e-5)


# ---------------------------------------------------------------------------
# attention variants (tests/test_attention.py's cases)
# ---------------------------------------------------------------------------
def _qkv(rng, B, H, Hkv, T, D):
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, H, T, D), (B, Hkv, T, D), (B, Hkv, T, D))]


@pytest.mark.parametrize("B,H,Hkv,T,D,qc,kc", [
    (1, 4, 4, 64, 16, 16, 16), (2, 8, 2, 128, 32, 32, 64),
    (1, 4, 1, 96, 16, 32, 32), (2, 4, 4, 100, 16, 32, 16),
    (1, 2, 2, 16, 8, 64, 64)])
def test_flash_attention_causal(B, H, Hkv, T, D, qc, kc):
    q, k, v = _qkv(np.random.default_rng(B * H + T), B, H, Hkv, T, D)
    want = RL.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                              q_chunk=qc, kv_chunk=kc)
    got = TL.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                             q_chunk=qc, kv_chunk=kc)
    _close(_np(got), want, 1e-5)
    _close(_np(got), flash_attention_ref(*map(jnp.asarray, (q, k, v))),
           2e-5)


@pytest.mark.parametrize("window,qc,kc", [(16, 16, 16), (24, 32, 16),
                                          (8, 16, 32)])
def test_flash_attention_banded(window, qc, kc):
    q, k, v = _qkv(np.random.default_rng(window), 2, 4, 2, 128, 16)
    want = RL.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                              window=window, q_chunk=qc, kv_chunk=kc)
    got = TL.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                             window=window, q_chunk=qc, kv_chunk=kc)
    _close(_np(got), want, 1e-5)


def test_flash_attention_kv_valid():
    q, k, v = _qkv(np.random.default_rng(3), 1, 2, 2, 64, 16)
    want = RL.flash_attention(jnp.asarray(q[:, :, :32]), jnp.asarray(k),
                              jnp.asarray(v), causal=False, kv_valid=32,
                              q_chunk=32, kv_chunk=32)
    got = TL.flash_attention(torch.from_numpy(q[:, :, :32]),
                             torch.from_numpy(k), torch.from_numpy(v),
                             causal=False, kv_valid=32, q_chunk=32,
                             kv_chunk=32)
    _close(_np(got), want, 1e-5)


def test_flash_attention_q_offset():
    q, k, v = _qkv(np.random.default_rng(4), 1, 4, 2, 48, 16)
    q = q[:, :, 40:]
    want = RL.flash_attention(*map(jnp.asarray, (q, k, v)), q_offset=40,
                              q_chunk=8, kv_chunk=16)
    got = TL.flash_attention(*map(torch.from_numpy, (q, k, v)), q_offset=40,
                             q_chunk=8, kv_chunk=16)
    _close(_np(got), want, 1e-5)


@pytest.mark.parametrize("pos", [40, [40, 7]])
def test_decode_attention(pos):
    rng = np.random.default_rng(9)
    B, H, Hkv, S, D = 2, 8, 2, 64, 16
    q = rng.normal(size=(B, H, 1, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
            for _ in range(2))
    p = np.asarray(pos, np.int32)
    want = RL.decode_attention(*map(jnp.asarray, (q, k, v)), jnp.asarray(p))
    got = TL.decode_attention(*map(torch.from_numpy, (q, k, v)),
                              torch.from_numpy(p))
    _close(_np(got), want, 1e-5)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def _prompts(lengths, seed=0, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, n).astype(np.int32) for n in lengths]


def test_prefill_matches_reference(model):
    rc, tc, params, tparams = model
    toks = np.stack(_prompts([37, 37], seed=5))
    rl, rcache = RT.prefill(rc, params, jnp.asarray(toks), max_len=48)
    tl, tcache = TT.prefill(tc, tparams, torch.from_numpy(toks), max_len=48)
    assert tl.shape == (2, tc.vocab_size)
    _close(_np(tl), rl, 1e-4)
    for key in ("k", "v"):
        assert tuple(tcache[0]["attn"][key].shape) == (2, 2, 1, 48, 16)
        _close(_np(tcache[0]["attn"][key]), rcache[0]["attn"][key], 1e-4)


def _batch_caches(module, cfg, params, prompts, max_len, to_tokens):
    """Prefill each prompt alone and write its cache into one batch row,
    as the serving engines do; returns (caches, first tokens, positions)."""
    caches = (module.init_caches(cfg, len(prompts), max_len)
              if module is RT else
              module.init_caches(cfg, len(prompts), max_len, device="cpu"))
    firsts = []
    for i, p in enumerate(prompts):
        logits, c1 = module.prefill(cfg, params, to_tokens(p[None]),
                                    max_len=max_len)
        if module is RT:
            caches = rserve._write_slot(caches, c1, i)
        else:
            tserve._write_slot(caches, c1, i)
        firsts.append(int(np.argmax(np.asarray(logits[0]))))
    return caches, firsts, [len(p) for p in prompts]


def test_decode_steps_with_per_slot_positions(model):
    rc, tc, params, tparams = model
    prompts = _prompts([5, 19, 12], seed=6)
    rcache, rfirst, pos = _batch_caches(RT, rc, params, prompts, 40,
                                        jnp.asarray)
    tcache, tfirst, _ = _batch_caches(TT, tc, tparams, prompts, 40,
                                      torch.from_numpy)
    assert rfirst == tfirst
    toks = np.asarray(rfirst, np.int32)[:, None]
    pos = np.asarray(pos, np.int32)
    for _ in range(4):
        rl, rcache = RT.decode_step(rc, params, jnp.asarray(toks), rcache,
                                    jnp.asarray(pos))
        tl, tcache = TT.decode_step(tc, tparams, torch.from_numpy(toks),
                                    tcache, torch.from_numpy(pos))
        _close(_np(tl), rl, 1e-4)
        toks = np.argmax(np.asarray(rl), -1)[:, None].astype(np.int32)
        pos = pos + 1
    for key in ("k", "v"):
        _close(_np(tcache[0]["attn"][key]), rcache[0]["attn"][key], 1e-4)


def test_decode_step_scalar_position(model):
    rc, tc, params, tparams = model
    toks = np.stack(_prompts([9, 9], seed=8))
    rl, rcache = RT.prefill(rc, params, jnp.asarray(toks), max_len=16)
    tl, tcache = TT.prefill(tc, tparams, torch.from_numpy(toks), max_len=16)
    nxt = np.argmax(np.asarray(rl), -1)[:, None].astype(np.int32)
    rl, _ = RT.decode_step(rc, params, jnp.asarray(nxt), rcache, 9)
    tl, _ = TT.decode_step(tc, tparams, torch.from_numpy(nxt), tcache, 9)
    _close(_np(tl), rl, 1e-4)


def test_init_lm_tree_and_distributions():
    rc, tc = rreduced(rget(ARCH)), treduced(tget(ARCH), d_model=256,
                                            d_ff=512)
    rc = dataclasses.replace(rc, d_model=256, d_ff=512)
    ref = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                       RT.init_lm(rc, jax.random.key(0)))
    port = TT.init_lm(tc, torch.Generator().manual_seed(0), device="cpu")
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), port)
    assert got == ref
    st = port["stages"][0]
    assert abs(float(st["attn"]["wq"].std()) * 16 - 1) < 0.05  # 1/sqrt(256)
    assert abs(float(port["embed"].std()) / 0.02 - 1) < 0.05
    assert float(st["attn"]["bq"].abs().max()) == 0.0
    assert bool((st["norm1"]["w"] == 1).all())
    again = TT.init_lm(tc, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["head"], port["head"])  # seeded


def test_params_from_jax_keeps_bfloat16():
    rc = rreduced(rget(ARCH), dtype="bfloat16")
    params = RT.init_lm(rc, jax.random.key(1))
    tp = TT.params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    assert tp["embed"].dtype == torch.bfloat16
    want = np.asarray(params["embed"]).astype(np.float32)
    assert (tp["embed"].float().numpy() == want).all()


@pytest.mark.parametrize("name", ["mamba2-2.7b", "hymba-1.5b"])
def test_other_families_wait(name):
    """The SSM and hybrid families, refused until their slice was ported,
    now initialise and prefill on the CPU (``test_torch_mamba2.py`` and
    ``test_torch_hybrid.py`` hold them against the reference)."""
    cfg = treduced(tget(name))
    params = TT.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    logits, caches = TT.prefill(cfg, params,
                                torch.zeros((1, 4), dtype=torch.int32),
                                max_len=8)
    assert logits.shape == (1, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    assert all("ssm" in c for c in caches)


def test_int8_kv_cache_waits(model):
    """The int8 KV cache, refused until its slice was ported, now prefills
    on the CPU into int8 payloads with float32 scales
    (``test_torch_kv8.py`` holds it against the reference)."""
    _, tc, _, tparams = model
    cfg = dataclasses.replace(tc, kv_dtype="int8")
    logits, caches = TT.prefill(cfg, tparams,
                                torch.zeros((1, 4), dtype=torch.int32))
    assert bool(torch.isfinite(logits).all())
    attn = caches[0]["attn"]
    assert attn["k"].dtype == torch.int8 and attn["ks"].dtype == torch.float32


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def _serve(engine_cls, request_cls, cfg, params, prompts, max_batch, **kw):
    eng = engine_cls(cfg, params, max_batch=max_batch, max_len=48, **kw)
    for i, p in enumerate(prompts):
        eng.submit(request_cls(rid=i, prompt=p, max_tokens=6))
    done = eng.run()
    return eng, {r.rid: r.out for r in done}


def test_serving_engine_matches_reference_and_sequential(model):
    rc, tc, params, tparams = model
    prompts = _prompts([3, 11, 25, 7, 16], seed=9)  # mixed lengths
    reng, rout = _serve(rserve.ServingEngine, rserve.Request, rc, params,
                        prompts, 2)
    teng, tout = _serve(tserve.ServingEngine, tserve.Request, tc, tparams,
                        prompts, 2, device="cpu")
    assert len(tout) == 5 and not teng.failed
    assert tout == rout
    assert teng.steps == reng.steps
    for i, p in enumerate(prompts):  # per-slot positions: batched == alone
        _, solo = _serve(tserve.ServingEngine, tserve.Request, tc,
                         tparams, [p], 1, device="cpu")
        assert solo[0] == tout[i]


def test_serving_failure_contract(model, monkeypatch):
    """A failed prefill fails that request only; a failed decode fails the
    active batch; the engine keeps draining the queue."""
    _, tc, _, tparams = model
    prompts = _prompts([4, 5, 6], seed=10)
    real_prefill = TT.prefill
    calls = {"n": 0}

    def flaky_prefill(*a, **k):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected prefill fault")
        return real_prefill(*a, **k)

    monkeypatch.setattr(TT, "prefill", flaky_prefill)
    eng, out = _serve(tserve.ServingEngine, tserve.Request, tc, tparams,
                      prompts, 2, device="cpu")
    assert sorted(out) == [0, 2]
    assert [r.rid for r in eng.failed] == [1]
    assert eng.failed[0].error == "injected prefill fault"
    monkeypatch.setattr(TT, "prefill", real_prefill)

    def broken_decode(*a, **k):
        raise RuntimeError("injected decode fault")

    monkeypatch.setattr(TT, "decode_step", broken_decode)
    eng, out = _serve(tserve.ServingEngine, tserve.Request, tc, tparams,
                      prompts, 2, device="cpu")
    assert out == {} and sorted(r.rid for r in eng.failed) == [0, 1, 2]
    assert eng.errors == ["injected decode fault"] * 2


@pytest.mark.parametrize("where", ["prefill", "decode_step"])
def test_kernel_error_is_raised_not_served(model, monkeypatch, where):
    """A kernel that does not build or launch stops the engine; it is not
    turned into failed requests."""
    from repro_torch.kernels.cuda_build import KernelError
    _, tc, _, tparams = model

    def broken(*a, **k):
        raise KernelError("flash_attention launch failed: cudaError_t 98")

    monkeypatch.setattr(TT, where, broken)
    with pytest.raises(KernelError, match="cudaError_t 98"):
        _serve(tserve.ServingEngine, tserve.Request, tc, tparams,
               _prompts([4, 5]), 2, device="cpu")


def test_serve_cli_reduced_on_cpu(capsys):
    rc = tserve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--requests", "3", "--max-tokens", "3",
                      "--prompt-len", "5", "--max-len", "16"])
    assert rc == 0
    assert "3 requests, 9 tokens" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the device rule: entry points default to cuda and raise without a GPU
# ---------------------------------------------------------------------------
def _no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the device rule is about its absence")


@pytest.mark.parametrize("entry", ["init_lm", "init_caches",
                                   "params_from_jax", "ServingEngine", "cli"])
def test_entry_points_raise_without_gpu(model, entry):
    _no_gpu()
    _, tc, params, tparams = model
    calls = {
        "init_lm": lambda: TT.init_lm(tc, torch.Generator()),
        "init_caches": lambda: TT.init_caches(tc, 1, 8),
        "params_from_jax": lambda: TT.params_from_jax(
            jax.tree.map(np.asarray, params)),
        "ServingEngine": lambda: tserve.ServingEngine(tc, tparams),
        "cli": lambda: tserve.main(["--arch", ARCH, "--reduced"]),
    }
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        calls[entry]()
