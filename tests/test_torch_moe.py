"""The port's MoE layer and MoE LM against the JAX reference, on reduced
``arctic-480b`` (top-2 of 4 experts plus the parallel dense MLP) and a
reduced ``moonshot-v1-16b-a3b`` widened to top-6 of 8 experts (the
published top-k), float32, with the reference's weights carried across by
``params_from_jax``.

Both impls (``einsum`` and ``scatter``) are held against the reference's
with and without capacity drops (small ``moe_group_size`` and
``capacity_factor`` force them; the test counts them).  Tolerances
(float32): the layer 1e-5; model logits and caches 1e-4 (two layers of
float32 sums taken in another order); served tokens equal.
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
from repro.models import moe as RM
from repro.models import transformer as RT
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduced_config as treduced
from repro_torch.launch import serve as tserve
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT

torch.set_num_threads(1)

ARCHS = {"arctic-480b": {},
         "moonshot-v1-16b-a3b": dict(n_experts=8, top_k=6)}
# (capacity_factor, moe_group_size): none dropped, some dropped, many
CAPACITY = {"generous": (8.0, 64), "tight": (1.0, 16), "starved": (0.5, 8)}


@pytest.fixture(autouse=True)
def _jax_32_bit():
    with jax.enable_x64(False):
        yield


def _cfgs(name, **kw):
    over = dict(ARCHS[name], **kw)
    return rreduced(rget(name), **over), treduced(tget(name), **over)


_MODELS: dict = {}


def _model(name):
    if name not in _MODELS:
        with jax.enable_x64(False):
            rc, tc = _cfgs(name)
            params = RT.init_lm(rc, jax.random.key(0))
            pnp = jax.tree.map(np.asarray, params)
        _MODELS[name] = (rc, tc, params, TT.params_from_jax(pnp,
                                                           device="cpu"))
    return _MODELS[name]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _dropped(cfg, p, x):
    """(dropped, valid) (token, choice) pairs of the port's routing of x."""
    xg, valid, S, G, _ = TM._group(cfg, x)
    C = TM._capacity(cfg, S)
    _, idx = TM._topk(TM._router(cfg, p, xg), cfg.top_k)
    flat = idx.reshape(G, -1)
    fv = valid.repeat_interleave(cfg.top_k, dim=1)
    oh = torch.nn.functional.one_hot(flat, cfg.n_experts) * fv[..., None]
    pos = torch.gather(torch.cumsum(oh, 1) - 1, -1, flat[..., None])[..., 0]
    return int(((pos >= C) & fv).sum()), int(fv.sum())


@pytest.mark.parametrize("capacity", sorted(CAPACITY))
@pytest.mark.parametrize("impl", ["einsum", "scatter"])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_moe_layer_matches_reference(name, impl, capacity):
    cf, gs = CAPACITY[capacity]
    rc, tc = _cfgs(name, capacity_factor=cf, moe_group_size=gs)
    p = RM.moe_init(rc, jax.random.PRNGKey(3))
    tp = TT.params_from_jax(jax.tree.map(np.asarray, p), device="cpu")
    x = np.random.default_rng(4).standard_normal(
        (2, 37, rc.d_model)).astype(np.float32)  # 74 tokens: group padding
    want = getattr(RM, f"moe_apply_{impl}")(rc, p, jnp.asarray(x))
    got = getattr(TM, f"moe_apply_{impl}")(tc, tp, torch.from_numpy(x))
    _close(got.numpy(), want, 1e-5)
    dropped, total = _dropped(tc, tp, torch.from_numpy(x))
    print(f"{name} {capacity}: {dropped} of {total} choices dropped")
    assert (dropped > 0) == (capacity != "generous")
    other = TM.moe_apply_scatter if impl == "einsum" else TM.moe_apply_einsum
    _close(other(tc, tp, torch.from_numpy(x)).numpy(), got.numpy(), 1e-5)


def test_topk_breaks_ties_by_index_as_reference():
    probs = np.array([[0.1, 0.3, 0.3, 0.2, 0.3, 0.0],
                      [0.25, 0.25, 0.25, 0.25, 0.0, 0.0],
                      [0.0, 0.0, 0.5, 0.0, 0.5, 0.0]], np.float32)
    for k in (1, 2, 3, 4):
        rw, ri = RM._topk(jnp.asarray(probs), k)
        tw, ti = TM._topk(torch.from_numpy(probs), k)
        assert (np.asarray(ri) == ti.numpy()).all(), k
        _close(tw.numpy(), rw, 1e-7)
        _close(tw.sum(-1).numpy(), np.ones(3), 1e-6)


def test_capacity_equals_reference_and_decode_cannot_overflow():
    """The served decode batch (4 slots) against each expert's capacity:
    each token picks top_k distinct experts, so an expert receives at most
    S choices from a group of S tokens, and none drops when the capacity
    is at least S.  moonshot (top-6 of 64) holds 6 >= 4 at 4 slots;
    arctic (top-2 of 128) holds only 2, which covers 2 slots, not 4."""
    for name in ARCHS:
        rc, tc = rget(name), tget(name)
        for s in (1, 2, 4, 37, 1024):
            assert RM._capacity(rc, s) == TM._capacity(tc, s)
    assert TM._capacity(tget("moonshot-v1-16b-a3b"), 4) >= 4
    assert TM._capacity(tget("arctic-480b"), 2) >= 2
    assert TM._capacity(tget("arctic-480b"), 4) < 4
    # routing really reaches the capacity bound without passing it: four
    # tokens that all pick the same experts fill exactly 4 rows of each
    cfg = treduced(tget("moonshot-v1-16b-a3b"), n_experts=8, top_k=6)
    p = TM.moe_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    same = torch.randn(1, 1, cfg.d_model).expand(4, 1, cfg.d_model)
    assert TM._capacity(cfg, 4) >= 4
    assert _dropped(cfg, p, same) == (0, 4 * cfg.top_k)


def test_moe_init_draws_experts_in_place():
    """Experts are drawn one at a time into preallocated leaves with the
    reference's shapes, dtypes and scales; seeded."""
    rc, tc = _cfgs("moonshot-v1-16b-a3b", d_model=128, d_ff=256)
    ref = RM.moe_init(rc, jax.random.PRNGKey(0))
    a = TM.moe_init(tc, torch.Generator().manual_seed(5), device="cpu")
    b = TM.moe_init(tc, torch.Generator().manual_seed(5), device="cpu")
    for k in ref:
        assert tuple(a[k].shape) == ref[k].shape
        assert str(a[k].dtype)[6:] == str(ref[k].dtype)
        assert torch.equal(a[k], b[k])
    assert abs(float(a["wi"].std()) * np.sqrt(128) - 1) < 0.05
    assert abs(float(a["wo"].std()) * np.sqrt(256) - 1) < 0.05
    out = {k: torch.zeros_like(v) for k, v in a.items()}
    ptrs = {k: v.data_ptr() for k, v in out.items()}
    got = TM.moe_init(tc, torch.Generator().manual_seed(5), device="cpu",
                      out=out)
    assert all(got[k].data_ptr() == ptrs[k] and torch.equal(got[k], a[k])
               for k in a)
    meta = TM.moe_init(tc, None, device="meta")
    assert all(v.device.type == "meta" for v in meta.values())


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_init_lm_tree_equals_reference(name):
    rc, tc = _cfgs(name, dtype="bfloat16")
    ref = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                       RT.init_lm(rc, jax.random.key(0)))
    port = TT.init_lm(tc, torch.Generator().manual_seed(0), device="cpu")
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), port)
    assert got == ref
    st = port["stages"][0]
    assert st["moe"]["router"].dtype == torch.float32
    assert ("dense_mlp" in st) == tc.moe_dense_residual
    again = TT.init_lm(tc, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["stages"][0]["moe"]["wo"], st["moe"]["wo"])


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_params_from_jax_carries_moe_leaves(name):
    rc, _ = _cfgs(name, dtype="bfloat16")
    params = RT.init_lm(rc, jax.random.key(2))
    tp = TT.params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    rst, tst = params["stages"][0], tp["stages"][0]
    L, d, E, ff = rc.n_layers, rc.d_model, rc.n_experts, rc.d_ff
    assert tuple(tst["moe"]["router"].shape) == (L, d, E)
    assert tst["moe"]["router"].dtype == torch.float32
    for k, shape in (("wi", (L, E, d, ff)), ("wg", (L, E, d, ff)),
                     ("wo", (L, E, ff, d))):
        assert tuple(tst["moe"][k].shape) == shape
        assert tst["moe"][k].dtype == torch.bfloat16
        want = np.asarray(rst["moe"][k]).astype(np.float32)
        assert (tst["moe"][k].float().numpy() == want).all()
    if rc.moe_dense_residual:
        assert tuple(tst["dense_mlp"]["wi"].shape) == (L, d, rc.dense_ff)


def _prompts(lengths, seed, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, n).astype(np.int32) for n in lengths]


@pytest.mark.parametrize("impl", ["einsum", "scatter"])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_prefill_and_decode_match_reference(name, impl):
    rc, tc, params, tparams = _model(name)
    rc, tc = (dataclasses.replace(c, moe_impl=impl) for c in (rc, tc))
    toks = np.stack(_prompts([37, 37], seed=5))
    rl, rcache = RT.prefill(rc, params, jnp.asarray(toks), max_len=48)
    tl, tcache = TT.prefill(tc, tparams, torch.from_numpy(toks), max_len=48)
    _close(tl.numpy(), rl, 1e-4)
    nxt = np.argmax(np.asarray(rl), -1)[:, None].astype(np.int32)
    pos = np.array([37, 37], np.int32)
    for _ in range(3):
        rl, rcache = RT.decode_step(rc, params, jnp.asarray(nxt), rcache,
                                    jnp.asarray(pos))
        tl, tcache = TT.decode_step(tc, tparams, torch.from_numpy(nxt),
                                    tcache, torch.from_numpy(pos))
        _close(tl.numpy(), rl, 1e-4)
        nxt = np.argmax(np.asarray(rl), -1)[:, None].astype(np.int32)
        pos = pos + 1
    for key in ("k", "v"):
        _close(tcache[0]["attn"][key].numpy(), rcache[0]["attn"][key], 1e-4)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_prefill_with_drops_matches_reference(name):
    """A whole MoE model under capacity pressure (group 8, factor 0.5)."""
    _, _, params, tparams = _model(name)
    rc, tc = _cfgs(name, capacity_factor=0.5, moe_group_size=8)
    toks = np.stack(_prompts([29, 29], seed=7))
    rl, _ = RT.prefill(rc, params, jnp.asarray(toks), max_len=32)
    tl, _ = TT.prefill(tc, tparams, torch.from_numpy(toks), max_len=32)
    _close(tl.numpy(), rl, 1e-4)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_serving_engine_matches_reference(name):
    rc, tc, params, tparams = _model(name)
    prompts = _prompts([3, 11, 25, 7], seed=9)
    out = {}
    for mod, cfg, p, kw in ((rserve, rc, params, {}),
                            (tserve, tc, tparams, dict(device="cpu"))):
        eng = mod.ServingEngine(cfg, p, max_batch=2, max_len=40, **kw)
        for i, pr in enumerate(prompts):
            eng.submit(mod.Request(rid=i, prompt=pr, max_tokens=5))
        out[mod] = ({r.rid: r.out for r in eng.run()}, eng.steps)
    assert out[tserve] == out[rserve]
    assert len(out[tserve][0]) == 4
