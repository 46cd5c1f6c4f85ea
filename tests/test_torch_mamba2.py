"""The port's Mamba-2 mixer and SSM family against the JAX package.

The SSD forms (``ssd_chunked`` at T below, equal to and not a multiple of
the chunk, with and without a carried-in state; ``ssd_recurrent``), the
causal conv, the mixer with and without its prefill cache and the decode
step run on the same numpy inputs through both packages; then the reduced
``mamba2-2.7b`` (2 layers, d_model 64, 8 SSM heads of 16, state 16, chunk
32, float32, the reference's weights carried across by ``params_from_jax``)
prefills 1-, 2-, 37- and 40-token prompts, decodes with per-slot
positions and serves through ``ServingEngine``.

Tolerances (float32): the SSD forms, the conv and the mixer 1e-5 (the same
arithmetic; the port contracts the reference's three-operand einsums as
two pairwise products, so sums are taken in another order); the model's
logits and caches 1e-4, as for the dense family; served tokens equal.
``_softplus`` is the reference's ``logaddexp(x, 0)``, so it agrees also
above torch's ``threshold=20``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget
from repro.configs import reduced_config as rreduced
from repro.launch import serve as rserve
from repro.models import mamba2 as RM
from repro.models import transformer as RT
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduced_config as treduced
from repro_torch.launch import serve as tserve
from repro_torch.models import mamba2 as TM
from repro_torch.models import transformer as TT

torch.set_num_threads(1)
ARCH = "mamba2-2.7b"


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
    return rc, tc, params, TT.params_from_jax(pnp, device="cpu")


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _np(t):
    return t.detach().numpy()


def _rand_ssd(seed, B, T, nh, P, N, with_h0=False):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(B, T, nh, P)),
            rng.uniform(0.001, 0.1, size=(B, T, nh)),
            -rng.uniform(0.5, 4.0, size=(nh,)),
            rng.normal(size=(B, T, N)), rng.normal(size=(B, T, N)),
            rng.normal(size=(nh,))]
    if with_h0:
        arrs.append(rng.normal(size=(B, nh, P, N)))
    return [a.astype(np.float32) for a in arrs]


def _both(arrs):
    return ([jnp.asarray(a) for a in arrs],
            [torch.from_numpy(a) for a in arrs])


# ---------------------------------------------------------------------------
# the SSD forms
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("T,chunk", [(7, 16), (16, 16), (33, 8), (45, 16),
                                     (64, 16), (100, 32)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_reference(T, chunk, with_h0):
    arrs = _rand_ssd(T * chunk + with_h0, 2, T, 3, 4, 8, with_h0)
    r, t = _both(arrs)
    h0r = r.pop() if with_h0 else None
    h0t = t.pop() if with_h0 else None
    yr, hr = RM.ssd_chunked(*r, chunk, h0=h0r)
    yt, ht = TM.ssd_chunked(*t, chunk, h0=h0t)
    assert yt.dtype == ht.dtype == torch.float32
    _close(_np(yt), yr, 1e-5)
    _close(_np(ht), hr, 1e-5)


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_recurrent_matches_reference(with_h0):
    arrs = _rand_ssd(3, 2, 21, 3, 4, 8, with_h0)
    r, t = _both(arrs)
    h0r = r.pop() if with_h0 else None
    h0t = t.pop() if with_h0 else None
    yr, hr = RM.ssd_recurrent(*r, h0=h0r)
    yt, ht = TM.ssd_recurrent(*t, h0=h0t)
    _close(_np(yt), yr, 1e-5)
    _close(_np(ht), hr, 1e-5)
    yc, hc = TM.ssd_chunked(*t, 8, h0=h0t)  # the port's forms agree too
    _close(_np(yc), _np(yt), 1e-4)
    _close(_np(hc), _np(ht), 1e-4)


def test_segsum_decay_matches_reference():
    a = -np.random.default_rng(4).uniform(0, 0.5, (2, 3, 16)).astype(
        np.float32)
    want = RM._segsum_decay(jnp.asarray(a))
    got = TM._segsum_decay(torch.from_numpy(a))
    _close(_np(got), want, 1e-6)
    assert float(got[0, 0, 0, 5]) == 0.0  # zero above the diagonal


@pytest.mark.parametrize("T", [1, 2, 9])
def test_causal_conv_matches_reference(T):
    rng = np.random.default_rng(T)
    x = rng.normal(size=(2, T, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    b = rng.normal(size=(12,)).astype(np.float32)
    want = RM._causal_conv(*map(jnp.asarray, (x, w, b)))
    got = TM._causal_conv(*map(torch.from_numpy, (x, w, b)))
    _close(_np(got), want, 1e-5)


def test_softplus_matches_reference_above_threshold():
    x = np.array([-30.0, -1.0, 0.0, 1.5, 19.0, 20.5, 25.0, 60.0], np.float32)
    want = jax.nn.softplus(jnp.asarray(x))
    got = TM._softplus(torch.from_numpy(x))
    _close(_np(got), want, 1e-6)


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------
def _layer0_ssm(model):
    rc, tc, params, tparams = model
    rp = jax.tree.map(lambda a: a[0], params["stages"][0]["ssm"])
    tp = {k: v[0] for k, v in tparams["stages"][0]["ssm"].items()}
    return rc, tc, rp, tp


@pytest.mark.parametrize("T", [1, 2, 33, 40])
def test_mamba_apply_matches_reference(model, T):
    rc, tc, rp, tp = _layer0_ssm(model)
    u = np.random.default_rng(T).normal(size=(2, T, rc.d_model)).astype(
        np.float32)
    yr, _ = RM.mamba_apply(rc, rp, jnp.asarray(u))
    yt, none = TM.mamba_apply(tc, tp, torch.from_numpy(u))
    assert none is None
    _close(_np(yt), yr, 1e-5)
    yr, cr = RM.mamba_apply(rc, rp, jnp.asarray(u),
                            cache=RM.mamba_cache_init(rc, 2))
    yt, ct = TM.mamba_apply(tc, tp, torch.from_numpy(u),
                            cache=TM.mamba_cache_init(tc, 2))
    _close(_np(yt), yr, 1e-5)
    assert tuple(ct["conv"].shape) == cr["conv"].shape  # left-padded tail
    for name in ("conv", "ssm"):
        assert ct[name].dtype == getattr(torch, str(cr[name].dtype))
        _close(_np(ct[name]), cr[name], 1e-5)


def test_mamba_step_matches_reference(model):
    rc, tc, rp, tp = _layer0_ssm(model)
    rng = np.random.default_rng(11)
    u = rng.normal(size=(3, 20, rc.d_model)).astype(np.float32)
    _, cr = RM.mamba_apply(rc, rp, jnp.asarray(u),
                           cache=RM.mamba_cache_init(rc, 3))
    _, ct = TM.mamba_apply(tc, tp, torch.from_numpy(u),
                           cache=TM.mamba_cache_init(tc, 3))
    for _ in range(3):
        step = rng.normal(size=(3, 1, rc.d_model)).astype(np.float32)
        yr, cr = RM.mamba_step(rc, rp, jnp.asarray(step), cr)
        yt, ct = TM.mamba_step(tc, tp, torch.from_numpy(step), ct)
        _close(_np(yt), yr, 1e-5)
        for name in ("conv", "ssm"):
            _close(_np(ct[name]), cr[name], 1e-5)


def test_mamba_init_tree_and_dtypes():
    tc = treduced(tget(ARCH), dtype="bfloat16")
    rc = rreduced(rget(ARCH), dtype="bfloat16")
    ref = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                       RM.mamba_init(rc, jax.random.key(0)))
    port = TM.mamba_init(tc, torch.Generator().manual_seed(0))
    assert {k: (tuple(v.shape), str(v.dtype)[6:])
            for k, v in port.items()} == ref
    want = RM.mamba_init(rc, jax.random.key(0))
    for name in ("A_log", "D", "dt_bias"):
        _close(_np(port[name]), want[name], 1e-6)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def _prompts(lengths, seed=0, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, n).astype(np.int32) for n in lengths]


def test_init_lm_and_caches_match_reference_tree(model):
    rc, tc, params, tparams = model
    ref = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                       RT.init_lm(rc, jax.random.key(0)))
    port = TT.init_lm(tc, torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]),
                        port) == ref
    assert "attn" not in port["stages"][0] and "mlp" not in port["stages"][0]
    rcache = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                          RT.init_caches(rc, 3, 24))
    tcache = TT.init_caches(tc, 3, 24, device="cpu")
    assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]),
                        tcache) == rcache


@pytest.mark.parametrize("n", [1, 2, 37, 40])
def test_prefill_matches_reference(model, n):
    rc, tc, params, tparams = model
    toks = np.stack(_prompts([n, n], seed=n))
    rl, rcache = RT.prefill(rc, params, jnp.asarray(toks), max_len=48)
    tl, tcache = TT.prefill(tc, tparams, torch.from_numpy(toks), max_len=48)
    assert tl.shape == (2, tc.vocab_size)
    _close(_np(tl), rl, 1e-4)
    for name in ("conv", "ssm"):
        _close(_np(tcache[0]["ssm"][name]), rcache[0]["ssm"][name], 1e-4)


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
def test_decode_steps_match_reference(model, positions):
    rc, tc, params, tparams = model
    lengths = [5, 40, 12] if positions == "per-slot" else [9, 9, 9]
    prompts = _prompts(lengths, seed=6)
    rcache, rfirst, pos = _batch_caches(RT, rc, params, prompts, 64,
                                        jnp.asarray)
    tcache, tfirst, _ = _batch_caches(TT, tc, tparams, prompts, 64,
                                      torch.from_numpy)
    assert rfirst == tfirst
    toks = np.asarray(rfirst, np.int32)[:, None]
    pos = np.asarray(pos, np.int32)
    for _ in range(4):
        rp = jnp.asarray(pos) if positions == "per-slot" else int(pos[0])
        tp = torch.from_numpy(pos) if positions == "per-slot" else int(pos[0])
        rl, rcache = RT.decode_step(rc, params, jnp.asarray(toks), rcache, rp)
        tl, tcache = TT.decode_step(tc, tparams, torch.from_numpy(toks),
                                    tcache, tp)
        _close(_np(tl), rl, 1e-4)
        toks = np.argmax(np.asarray(rl), -1)[:, None].astype(np.int32)
        pos = pos + 1
    for name in ("conv", "ssm"):  # the new state landed in the caches
        _close(_np(tcache[0]["ssm"][name]), rcache[0]["ssm"][name], 1e-4)


def _serve(engine_cls, request_cls, cfg, params, prompts, max_batch, **kw):
    eng = engine_cls(cfg, params, max_batch=max_batch, max_len=64, **kw)
    for i, p in enumerate(prompts):
        eng.submit(request_cls(rid=i, prompt=p, max_tokens=6))
    done = eng.run()
    return eng, {r.rid: r.out for r in done}


def test_serving_engine_matches_reference(model):
    rc, tc, params, tparams = model
    prompts = _prompts([3, 40, 1, 25, 7], seed=9)
    reng, rout = _serve(rserve.ServingEngine, rserve.Request, rc, params,
                        prompts, 2)
    teng, tout = _serve(tserve.ServingEngine, tserve.Request, tc, tparams,
                        prompts, 2, device="cpu")
    assert len(tout) == 5 and not teng.failed
    assert tout == rout
    assert teng.steps == reng.steps


def test_serve_cli_on_cpu(capsys):
    rc = tserve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--requests", "2", "--max-tokens", "3",
                      "--prompt-len", "5", "--max-len", "16"])
    assert rc == 0
    assert "2 requests, 6 tokens" in capsys.readouterr().out
