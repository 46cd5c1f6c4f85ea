"""The port's cross-layer streaming (``nc_forward(stream_chunk=N)``) and
quantized float forward (``apply(quant=True)``) against the reference.

``stream_chunk``: logits byte-identical (float32 bit patterns) to the
reference's chunked run and to the port's unchunked run, and the merged
``NCForwardReport`` equal to the reference's field by field, with and
without overlap, integrity and compressed plans; ``filter_loads`` sums to
the chunk count.

``apply(quant=True)``: both packages run float32 convolutions whose sums
are taken in different orders, and a per-tensor ``fake_quant`` can move a
value that lies on a rounding boundary by one level.  The test counts such
flips at the pooled features (printed) and holds the logits within
atol 1e-4 (the float test's tolerance) when no level flipped; at these
inputs none does.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import quantize as rq
from repro.models import inception as ri
from repro_torch.core import quantize as tq
from repro_torch.core import schedule as tsched
from repro_torch.core.cache_geometry import XEON_E5_35MB as TGEOM
from repro_torch.models import inception as ti

torch.set_num_threads(1)

TINY = {
    "stem": dict(img=31, width_div=8, classes=8, stages=()),
    "mixed_a": dict(img=47, width_div=8, classes=8, stages=("a",)),
}
BATCH = 3


_MODELS: dict = {}


def _model(name):
    if name not in _MODELS:
        kw = TINY[name]
        rc, tc = ri.reduced_config(**kw), ti.reduced_config(**kw)
        params = ri.init_params(jax.random.key(2), config=rc)
        x = np.random.default_rng(11).random((BATCH, rc.img, rc.img, 3),
                                             dtype=np.float32)
        _MODELS[name] = (name, rc, tc, params,
                         ti.params_from_jax(params, device="cpu"), x)
    return _MODELS[name]


@pytest.fixture(params=sorted(TINY))
def tiny(request):
    return _model(request.param)


def _bits_equal(want, got):
    want = np.asarray(want)
    assert got.dtype == torch.float32 and want.shape == tuple(got.shape)
    assert (want.view(np.uint32) == got.numpy().view(np.uint32)).all()


FLAGS = {
    "plain": {},
    "overlap": dict(overlap=True),
    "integrity+compressed": dict(integrity=True, compressed=True),
}


# every flag combination on the stem config; the mixed block unflagged
CASES = ([("stem", chunk, flags) for chunk in (1, 2) for flags in FLAGS]
         + [("mixed_a", chunk, "plain") for chunk in (1, 2)])


@pytest.mark.parametrize("config,chunk,flags", CASES)
def test_stream_chunk_matches_reference(config, chunk, flags):
    name, rc, tc, rparams, tparams, x = _model(config)
    kw = FLAGS[flags]
    r_logits, r_rep = ri.nc_forward(rparams, x, config=rc, engine="jit",
                                    stream_chunk=chunk, **kw)
    t_logits, t_rep = ti.nc_forward(tparams, x, config=tc,
                                    stream_chunk=chunk, device="cpu", **kw)
    _bits_equal(r_logits, t_logits)
    assert dataclasses.asdict(r_rep) == dataclasses.asdict(t_rep)
    n_chunks = -(-BATCH // chunk)
    conv_fc = [lr for lr in t_rep.layers if lr.kind in ("conv", "fc")]
    assert conv_fc and all(lr.filter_loads == n_chunks for lr in conv_fc)
    assert all(lr.batch == BATCH for lr in t_rep.layers)
    whole, w_rep = ti.nc_forward(tparams, x, config=tc, device="cpu", **kw)
    assert torch.equal(whole.view(torch.int32), t_logits.view(torch.int32))
    # the modeled numbers are per image, so chunking leaves them unchanged
    assert [lr.modeled_cycles for lr in t_rep.layers] == [
        lr.modeled_cycles for lr in w_rep.layers]


def test_stream_chunk_at_or_above_batch_is_unchunked(tiny):
    """A chunk at least as large as the batch runs the whole-batch path:
    one filter load per layer, the same report."""
    _, rc, tc, _, tparams, x = tiny
    whole = ti.nc_forward(tparams, x, config=tc, device="cpu")
    same = ti.nc_forward(tparams, x, config=tc, stream_chunk=BATCH,
                         device="cpu")
    assert torch.equal(whole[0], same[0])
    assert dataclasses.asdict(whole[1]) == dataclasses.asdict(same[1])


def test_stream_chunk_with_explicit_schedule_raises_as_reference(tiny):
    _, rc, tc, rparams, tparams, x = tiny
    from repro.core import schedule as rsched
    r_net = rsched.plan_network(ri.inception_v3_specs(rc), batch=BATCH)
    t_net = tsched.plan_network(ti.inception_v3_specs(tc), TGEOM,
                                batch=BATCH)
    with pytest.raises(ValueError, match="stream_chunk") as r_err:
        ri.nc_forward(rparams, x, config=rc, schedule=r_net, stream_chunk=1)
    with pytest.raises(ValueError, match="stream_chunk") as t_err:
        ti.nc_forward(tparams, x, config=tc, schedule=t_net, stream_chunk=1,
                      device="cpu")
    assert str(r_err.value) == str(t_err.value)


def _pooled(apply_mod, params, x, cfg, to_np):
    """Pooled features before the FC of a quantized forward: the logits'
    pre-image, where a flipped fake_quant level would show."""
    feats = {}
    real = apply_mod.q.fake_quant

    def spy(v, *a, **k):
        if v.ndim == 2:
            feats["pooled"] = to_np(v)
        return real(v, *a, **k)

    apply_mod.q.fake_quant = spy
    try:
        logits = apply_mod.apply(params, x, quant=True, config=cfg)
    finally:
        apply_mod.q.fake_quant = real
    return to_np(logits), feats["pooled"]


def test_quantized_apply_matches_reference(tiny):
    name, rc, tc, rparams, tparams, x = tiny
    want, r_pool = _pooled(ri, rparams, x, rc, np.asarray)
    got, t_pool = _pooled(ti, tparams, torch.from_numpy(x), tc,
                          lambda t: t.numpy())
    r_qp = rq.choose_qparams(r_pool.min(), r_pool.max())
    t_qp = tq.choose_qparams(t_pool.min(), t_pool.max())
    r_lv = np.asarray(rq.quantize(r_pool, r_qp)).astype(np.int32)
    t_lv = tq.quantize(torch.from_numpy(t_pool), t_qp).numpy().astype(np.int32)
    flips = int((r_lv != t_lv).sum())
    print(f"[{name}] pooled-feature levels flipped: {flips} of {r_lv.size}; "
          f"max logit diff {np.abs(got - want).max():.3g}")
    assert flips == 0
    assert np.allclose(got, want, atol=1e-4, rtol=0)
    plain = ti.apply(tparams, torch.from_numpy(x), config=tc).numpy()
    assert not np.array_equal(plain, got)  # the flag changes the function
