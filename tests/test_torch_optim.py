"""The port's AdamW and gradient compression against ``repro.optim``.

AdamW: one update from identical grads, params and state, with the grad
clip active and not, at a warmup and a cosine step, with float32 and int8
moments, for bfloat16 and float32 parameters.  ``m``, ``v`` and the
updates agree within rtol 1e-6 (``m``, ``v`` and the updates also within 1e-6
x the leaf's max, for entries where ``b1 m + (1 - b1) g`` cancels after a clip
scale one ulp apart; a bfloat16 update within one bf16 step,
where the two float32 values round to neighbours); the int8 moments' ``q``
is equal except at rounding ties, each at most one step off and at most
0.1% of the entries (counted); their scales within rtol 1e-6.

Compression on ragged sizes (1, 511, 513, 3x512+7): ``q``, ``scale`` and
the new error feedback bit-equal; where the two divide ``x / scale`` one
ulp apart and round to neighbouring integers, the entry is named and held
to one step.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compression as RC
from repro_torch import tree
from repro_torch.optim import compression as TC

# the packages export a function ``adamw`` under the module's name
RA = importlib.import_module("repro.optim.adamw")
TA = importlib.import_module("repro_torch.optim.adamw")

torch.set_num_threads(1)

SHAPES = {"w": (24, 40), "stack": (3, 8, 33), "bias": (40,), "s": ()}


@pytest.fixture(autouse=True)
def _jax_32_bit():
    with jax.enable_x64(False):
        yield


def _np(x):
    if torch.is_tensor(x):
        if x.dtype == torch.bfloat16:
            return x.float().numpy()
        return x.numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _problem(seed, dtype, quantized, clip_active, count):
    """Params, grads and an optimizer state after ``count`` steps, in the
    reference's form (numpy / jax)."""
    rng = np.random.default_rng(seed)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    params = {k: jnp.asarray(rng.standard_normal(s).astype(np.float32) * 0.1,
                             jd) for k, s in SHAPES.items()}
    gscale = 1.0 if clip_active else 1e-3  # global norm ~30 vs ~0.03
    grads = {k: jnp.asarray(rng.standard_normal(s).astype(np.float32)
                            * gscale, jd) for k, s in SHAPES.items()}
    leaves = jax.tree.leaves(params)

    def moment(p, positive):
        x = rng.standard_normal(p.shape).astype(np.float32) * 0.01
        x = jnp.asarray(np.abs(x) * 1e-2 if positive else x)
        return RA._q8_pack(x) if quantized else x

    state = {"m": tuple(moment(p, False) for p in leaves),
             "v": tuple(moment(p, True) for p in leaves),
             "count": jnp.asarray(count, jnp.int32)}
    return params, grads, state


def _state_to_torch(state):
    def conv(x):
        if isinstance(x, RA.MomentState):
            return TA.MomentState(_to_torch(x.q), _to_torch(x.scale))
        return _to_torch(x)

    return {"m": tuple(conv(x) for x in state["m"]),
            "v": tuple(conv(x) for x in state["v"]),
            "count": _to_torch(state["count"])}


def _close_q8(got, want, what):
    """int8 moments: scales within rtol 1e-6; q equal but at rounding ties,
    each at most one step off, at most 0.1% of the entries."""
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale),
                               rtol=1e-6, err_msg=what)
    gq = got.q.numpy().astype(np.int32)
    wq = np.asarray(want.q).astype(np.int32)
    off = np.abs(gq - wq)
    assert off.max(initial=0) <= 1, what
    assert np.count_nonzero(off) <= max(1, wq.size // 1000), (
        what, np.count_nonzero(off), wq.size)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quantized", [False, True], ids=["f32m", "int8m"])
@pytest.mark.parametrize("count", [4, 60], ids=["warmup", "cosine"])
@pytest.mark.parametrize("clip_active", [True, False],
                         ids=["clipped", "unclipped"])
def test_adamw_update_equals_reference(dtype, quantized, count,
                                       clip_active):
    params, grads, state = _problem(count + quantized, dtype, quantized,
                                    clip_active, count)
    kw = dict(lr=None, quantize_moments=quantized)
    r_opt = RA.AdamW(**{**kw, "lr": RA.cosine_schedule(1e-3, 10, 100)})
    t_opt = TA.AdamW(**{**kw, "lr": TA.cosine_schedule(1e-3, 10, 100)})
    r_up, r_state = r_opt.update(grads, state, params)
    tp = tree.map(_to_torch, params)
    t_up, t_state = t_opt.update(tree.map(_to_torch, grads),
                                 _state_to_torch(state), tp)
    assert int(t_state["count"]) == int(r_state["count"]) == count + 1
    for name in ("m", "v"):
        for i, (g, w) in enumerate(zip(t_state[name], r_state[name])):
            if quantized:
                _close_q8(g, w, f"{name}[{i}]")
            else:  # atol: the clip scale may differ by an ulp (the global
                # norm is summed in another order) and b1*m + (1-b1)*g
                # cancels, so an entry near 0 is held to the leaf's scale
                w = np.asarray(w)
                np.testing.assert_allclose(
                    g.numpy(), w, rtol=1e-6,
                    atol=1e-6 * float(np.max(np.abs(w), initial=0)),
                    err_msg=f"{name}[{i}]")
    for k in SHAPES:
        got, want = t_up[k], r_up[k]
        assert got.dtype == tp[k].dtype
        if quantized and got.ndim:  # a moment one int8 step off moves it
            np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                                       atol=_q8_step(r_state, k), err_msg=k)
        elif dtype == "bfloat16":
            # float32 values within 1e-6 may round to neighbouring bf16
            np.testing.assert_allclose(_np(got), _np(want), rtol=2 ** -8,
                                       err_msg=k)
        else:  # atol as for m: the step cancels where m does
            np.testing.assert_allclose(
                _np(got), _np(want), rtol=1e-6,
                atol=1e-6 * float(np.max(np.abs(_np(want)), initial=0)),
                err_msg=k)
    new = TA.apply_updates(tp, t_up)
    ref = RA.apply_updates(params, r_up)
    for k in SHAPES:
        assert new[k].dtype == tp[k].dtype
        np.testing.assert_allclose(_np(new[k]), _np(ref[k]), rtol=2 ** -7,
                                   atol=1e-6)


def _q8_step(state, k):
    """The update a one-step moment difference can cause, bounded by lr x
    (one m step / sqrt of the smallest v) on leaf ``k``'s channels."""
    i = sorted(SHAPES).index(k)
    m, v = state["m"][i], state["v"][i]
    vmin = max(float(np.min(np.asarray(v.q).astype(np.float32)
                            * np.asarray(v.scale))), 1e-12)
    return 1e-3 * 2 * float(np.max(np.asarray(m.scale))) / np.sqrt(vmin)


def test_adamw_without_clip_and_constant_lr():
    params, grads, state = _problem(0, "float32", False, True, 3)
    r_up, r_state = RA.adamw(lr=1e-2, grad_clip=0.0).update(grads, state,
                                                            params)
    t_up, t_state = TA.adamw(lr=1e-2, grad_clip=0.0).update(
        tree.map(_to_torch, grads), _state_to_torch(state),
        tree.map(_to_torch, params))
    for k in SHAPES:
        np.testing.assert_allclose(t_up[k].numpy(), np.asarray(r_up[k]),
                                   rtol=1e-6)


def test_adamw_init_equals_reference():
    params, _, _ = _problem(1, "bfloat16", False, False, 0)
    for quantized in (False, True):
        r = RA.AdamW(quantize_moments=quantized).init(params)
        t = TA.AdamW(quantize_moments=quantized).init(
            tree.map(_to_torch, params))
        rl, tl = jax.tree.leaves(r), tree.leaves(t)
        assert len(rl) == len(tl)
        for a, b in zip(tl, rl):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_cosine_schedule_equals_reference():
    counts = np.arange(0, 130, dtype=np.int32)
    want = np.asarray(RA.cosine_schedule(3e-4, 20, 100)(jnp.asarray(counts)))
    got = TA.cosine_schedule(3e-4, 20, 100)(torch.from_numpy(counts))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("shape", [(5, 7), (3, 1), (1000,), ()])
def test_q8_pack_equals_reference(shape):
    x = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    want = RA._q8_pack(jnp.asarray(x))
    got = TA._q8_pack(torch.from_numpy(x))
    _close_q8(got, want, str(shape))
    np.testing.assert_array_equal(
        TA._q8_unpack(got, shape).numpy(),
        np.asarray(RA._q8_unpack(want, shape)))


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------
def _tie_entries(blocks, scale):
    """Entries whose quotient lies within an ulp of a rounding tie."""
    quot = blocks / scale
    frac = np.abs(quot - np.trunc(quot))
    return np.isclose(frac, 0.5, rtol=0, atol=4 * np.spacing(np.abs(quot)))


@pytest.mark.parametrize("n", [1, 511, 513, 3 * 512 + 7])
def test_compress_leaf_equals_reference(n):
    rng = np.random.default_rng(n)
    g = rng.standard_normal(n).astype(np.float32).reshape(
        (n,) if n < 512 else (1, n))
    ef = (rng.standard_normal(g.shape) * 1e-3).astype(np.float32)
    rc, ref_ef = RC._compress_leaf(jnp.asarray(g), jnp.asarray(ef))
    tc, t_ef = TC._compress_leaf(torch.from_numpy(g), torch.from_numpy(ef))
    np.testing.assert_array_equal(tc.scale.numpy(), np.asarray(rc.scale))
    gq, wq = tc.q.numpy().astype(np.int32), np.asarray(rc.q).astype(np.int32)
    diff = np.flatnonzero(gq != wq)
    if diff.size:  # allowed only at rounding ties, one step off, named
        gf = np.pad((g + ef).reshape(-1), (0, gq.size - g.size))
        ties = _tie_entries(gf.reshape(gq.shape),
                            np.asarray(rc.scale)).reshape(-1)
        assert np.all(ties[diff]), diff
        assert np.abs(gq - wq).max() <= 1, diff
    else:
        np.testing.assert_array_equal(t_ef.numpy(), np.asarray(ref_ef))
    assert tc.q.dtype == torch.int8 and tuple(tc.q.shape) == rc.q.shape


def test_error_feedback_round_equals_reference():
    rng = np.random.default_rng(3)
    grads = {"a": rng.standard_normal((7, 100)).astype(np.float32),
             "b": [rng.standard_normal(513).astype(np.float32)]}
    r_ef = RC.ef_init(jax.tree.map(jnp.asarray, grads))
    t_ef = TC.ef_init(tree.map(torch.from_numpy, grads))
    for _ in range(2):  # the second round carries the first's residual
        r_eff, r_ef = RC.error_feedback_update(
            jax.tree.map(jnp.asarray, grads), r_ef)
        t_eff, t_ef = TC.error_feedback_update(
            tree.map(torch.from_numpy, grads), t_ef)
        for got, want in zip(tree.leaves(t_eff), jax.tree.leaves(r_eff)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for got, want in zip(tree.leaves(t_ef), jax.tree.leaves(r_ef)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    comp, _ = TC.compress_gradients(tree.map(torch.from_numpy, grads), t_ef)
    assert isinstance(comp["b"][0], TC.CompressedGrads)
    assert tuple(comp["a"].q.shape) == (2, TC.QBLOCK)  # 700 -> 2 blocks
    bf = TC.decompress(comp, tree.map(
        lambda a: torch.from_numpy(a).to(torch.bfloat16), grads))
    assert bf["a"].dtype == torch.bfloat16 and bf["a"].shape == (7, 100)
