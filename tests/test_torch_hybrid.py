"""The port's hybrid family (sliding-window attention in parallel with a
Mamba-2 mixer) against the JAX package, at the reduced ``hymba-1.5b``
(2 layers, d_model 64, 4 query heads over 1 KV head of 16, global layer 0,
``attn_window`` 32, SSM state 16, float32), the reference's weights carried
across by ``params_from_jax``.

Prompts longer than the window prefill into the ring rolled by ``T % W``;
decodes cross the ring's wrap from slot 31 to slot 0, at a scalar position
and at per-row positions; the banded ``flash_attention`` runs at ragged T;
``_ring_mask`` at scalar and per-row slots; ``ServingEngine`` serves mixed
prompts.  Tolerances (float32): attention and masks 1e-5 (masks equal);
the model's logits and caches 1e-4, as for the dense family; served tokens
equal.
"""
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
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

torch.set_num_threads(1)
ARCH = "hymba-1.5b"
W = 32  # the reduced config's attn_window


@pytest.fixture(autouse=True)
def _jax_32_bit():
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def model():
    with jax.enable_x64(False):
        rc, tc = rreduced(rget(ARCH)), treduced(tget(ARCH))
        params = RT.init_lm(rc, jax.random.key(0))
        pnp = jax.tree.map(np.asarray, params)
    assert tc.attn_window == W and tc.global_layers == (0,)
    return rc, tc, params, TT.params_from_jax(pnp, device="cpu")


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _np(t):
    return t.detach().numpy()


def _prompts(lengths, seed=0, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, n).astype(np.int32) for n in lengths]


def _close_caches(tcache, rcache, tol):
    for tc_, rc_ in zip(tcache, rcache):
        assert sorted(tc_) == sorted(rc_)
        for kind in tc_:
            for name in tc_[kind]:
                assert tuple(tc_[kind][name].shape) == rc_[kind][name].shape
                _close(_np(tc_[kind][name]), rc_[kind][name], tol)


# ---------------------------------------------------------------------------
# attention pieces
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("T,qc,kc", [(45, 16, 16), (70, 64, 64),
                                     (131, 32, 16), (29, 64, 64)])
@pytest.mark.parametrize("window", [W, 7])
def test_banded_flash_attention_ragged(T, qc, kc, window):
    rng = np.random.default_rng(T + window)
    q = rng.normal(size=(2, 4, T, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 1, T, 16)).astype(np.float32)
            for _ in range(2))
    want = RL.flash_attention(*map(jnp.asarray, (q, k, v)), window=window,
                              q_chunk=qc, kv_chunk=kc)
    got = TL.flash_attention(*map(torch.from_numpy, (q, k, v)), window=window,
                             q_chunk=qc, kv_chunk=kc)
    _close(_np(got), want, 1e-5)


def test_banded_prefill_off_the_cpu_skips_the_kernel(monkeypatch):
    """Off the CPU, ``window > 0`` runs the torch banded path, never the
    flash kernel (which takes no window); ``window == 0`` reaches the
    kernel's entry point.  Meta tensors stand in for a card's."""
    calls = []

    def kernel(q, k, v, *, causal=True):
        calls.append(q.shape)
        return torch.empty_like(q)

    monkeypatch.setattr(ops, "flash_attention", kernel)
    q = torch.empty((1, 4, 70, 16), device="meta")
    kv = torch.empty((1, 1, 70, 16), device="meta")
    out = TL.flash_attention(q, kv, kv, window=W, q_chunk=64, kv_chunk=64)
    assert out.shape == q.shape and calls == []
    TL.flash_attention(q, kv, kv, window=0)
    assert calls == [q.shape]
    with pytest.raises(NotImplementedError, match="q_offset"):
        TL.flash_attention(q, kv, kv, window=W, q_offset=3)


@pytest.mark.parametrize("slot,length", [(5, 6), (0, W), (31, W), (3, 4),
                                         ([5, 0, 31, 12], [6, W, W, 13])])
def test_ring_mask_matches_reference(slot, length):
    want = RL._ring_mask(jnp.asarray(slot), jnp.asarray(length), W)
    got = TL._ring_mask(torch.as_tensor(slot), torch.as_tensor(length), W)
    assert tuple(got.shape) == want.shape
    assert (_np(got) == np.asarray(want)).all()


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def test_init_lm_and_caches_match_reference_tree(model):
    rc, tc, _, _ = model
    ref = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                       RT.init_lm(rc, jax.random.key(0)))
    port = TT.init_lm(tc, torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]),
                        port) == ref
    assert [tuple(st["beta_attn"].shape) for st in port["stages"]] == [(1,),
                                                                     (1,)]
    assert all(bool((st["beta_ssm"] == 1).all()) for st in port["stages"])
    rcache = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                          RT.init_caches(rc, 3, 48))
    tcache = TT.init_caches(tc, 3, 48, device="cpu")
    assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]),
                        tcache) == rcache
    assert tcache[0]["attn"]["k"].shape[3] == 48  # the global layer
    assert tcache[1]["attn"]["k"].shape[3] == W  # the ring


@pytest.mark.parametrize("n", [20, W, 45, 70])
def test_prefill_matches_reference(model, n):
    """Prompts longer than the window prefill into the ring rolled."""
    rc, tc, params, tparams = model
    toks = np.stack(_prompts([n, n], seed=n))
    rl, rcache = RT.prefill(rc, params, jnp.asarray(toks), max_len=96)
    tl, tcache = TT.prefill(tc, tparams, torch.from_numpy(toks), max_len=96)
    _close(_np(tl), rl, 1e-4)
    _close_caches(tcache, rcache, 1e-4)


def _batch_caches(module, cfg, params, prompts, max_len, to_tokens):
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


@pytest.mark.parametrize("positions", ["per-slot", "scalar"])
def test_decode_crosses_the_ring_wrap(model, positions):
    """Decode from position 29 (scalar) or 29/45/12 (per row) for 6 steps:
    rows write slots 29, 30, 31, 0, 1, 2 of the ring and read by age."""
    rc, tc, params, tparams = model
    lengths = [29, 45, 12] if positions == "per-slot" else [29, 29]
    prompts = _prompts(lengths, seed=7)
    rcache, rfirst, pos = _batch_caches(RT, rc, params, prompts, 96,
                                        jnp.asarray)
    tcache, tfirst, _ = _batch_caches(TT, tc, tparams, prompts, 96,
                                      torch.from_numpy)
    assert rfirst == tfirst
    toks = np.asarray(rfirst, np.int32)[:, None]
    pos = np.asarray(pos, np.int32)
    for _ in range(6):
        rp = jnp.asarray(pos) if positions == "per-slot" else int(pos[0])
        tp = torch.from_numpy(pos) if positions == "per-slot" else int(pos[0])
        rl, rcache = RT.decode_step(rc, params, jnp.asarray(toks), rcache, rp)
        tl, tcache = TT.decode_step(tc, tparams, torch.from_numpy(toks),
                                    tcache, tp)
        _close(_np(tl), rl, 1e-4)
        toks = np.argmax(np.asarray(rl), -1)[:, None].astype(np.int32)
        pos = pos + 1
    _close_caches(tcache, rcache, 1e-4)


def _serve(engine_cls, request_cls, cfg, params, prompts, max_batch, **kw):
    eng = engine_cls(cfg, params, max_batch=max_batch, max_len=64, **kw)
    for i, p in enumerate(prompts):
        eng.submit(request_cls(rid=i, prompt=p, max_tokens=8))
    done = eng.run()
    return eng, {r.rid: r.out for r in done}


def test_serving_engine_matches_reference(model):
    """Mixed prompts at 2 slots; the 28- and 40-token ones decode across
    the wrap, the 50-token one prefills rolled."""
    rc, tc, params, tparams = model
    prompts = _prompts([28, 5, 50, 40, 13], seed=9)
    reng, rout = _serve(rserve.ServingEngine, rserve.Request, rc, params,
                        prompts, 2)
    teng, tout = _serve(tserve.ServingEngine, tserve.Request, tc, tparams,
                        prompts, 2, device="cpu")
    assert len(tout) == 5 and not teng.failed
    assert tout == rout
    assert teng.steps == reng.steps
    assert teng.caches[1]["attn"]["k"].shape[3] == W


def test_serve_cli_on_cpu(capsys):
    rc = tserve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--requests", "2", "--max-tokens", "3",
                      "--prompt-len", "40", "--max-len", "48"])
    assert rc == 0
    assert "2 requests, 6 tokens" in capsys.readouterr().out
