"""``repro_torch.tracing`` on the LM path: the spans of ``ServingEngine``
(``lm.step``, ``lm.prefill``, ``lm.decode``), of each layer's mixer
(``mixer.mamba``, ``mixer.attn``) and of the MoE (``moe.route``,
``moe.experts``, ``moe.shared``), and the counters ``tokens.prefill``,
``tokens.decode``, ``moe.assigned``, ``moe.dropped``,
``attn.prefill_pairs``, ``attn.decode_pairs`` and ``host_syncs``, on the
test-size Granite configuration (``tests/granite_cases.py``: Mamba,
attention, Mamba).  Off, nothing is recorded; the Neural Cache path's
spans and counters are those ``test_torch_tracing.py`` holds."""
import copy
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
for p in (str(ROOT), str(ROOT / "tests")):
    if p not in sys.path:
        sys.path.insert(0, p)

from granite_cases import tiny_config  # noqa: E402
from ncbench import harness  # noqa: E402
from ncbench.builders import granite as builder  # noqa: E402
from repro_torch import tracing  # noqa: E402
from repro_torch.launch.serve import Request, ServingEngine  # noqa: E402
from repro_torch.models import moe as MoE  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

CPU = torch.device("cpu")
LM_SPANS = {"lm.step", "lm.prefill", "lm.decode", "mixer.mamba",
            "mixer.attn", "moe.route", "moe.experts", "moe.shared"}


@pytest.fixture(scope="module")
def model():
    cfg = tiny_config()
    params = builder.make_params(cfg, torch.Generator().manual_seed(3), CPU)
    return builder.model_config(cfg), params["program"]


def _counts(s):
    return {k: v["count"] for k, v in s.totals().items()}


def _total(s, counter):
    return sum(c.get(counter, 0) for c in s.counters().values())


def _serve(mcfg, params, n, N, max_batch=1):
    """One request of an ``n``-token prompt and a forced continuation of
    ``N`` tokens, served to its end; returns the request."""
    rng = np.random.default_rng(n)
    eng = ServingEngine(mcfg, params, max_batch=max_batch, max_len=n + N + 1,
                        device=CPU)
    req = Request(rid=0, prompt=rng.integers(0, 256, n).astype(np.int32),
                  forced=rng.integers(0, 256, N).astype(np.int32),
                  max_tokens=N + 1)
    eng.submit(req)
    eng.run()
    assert req.done and not req.failed
    return req


def test_one_prefill_records_each_layer_once(model):
    mcfg, params = model
    with tracing.session() as s:
        T.prefill(mcfg, params, torch.zeros((1, 12), dtype=torch.int64),
                  max_len=16)
    assert _counts(s) == {"mixer.mamba": 2, "mixer.attn": 1, "moe.route": 3,
                          "moe.experts": 3, "moe.shared": 3}
    assert _total(s, "attn.prefill_pairs") == 12 * 13 // 2
    assert _total(s, "moe.dropped") == 0


@pytest.mark.parametrize("N", [1, 5])
def test_serving_records_the_engine_steps(model, N):
    """One request, N forced tokens: N engine steps (the first admits and
    prefills), one prefill, N decode steps; each of 1 + N forwards runs
    both Mamba layers, the attention layer and three MoE layers."""
    mcfg, params = model
    with tracing.session() as s:
        _serve(mcfg, params, 9, N)
    assert _counts(s) == {"lm.step": N, "lm.prefill": 1, "lm.decode": N,
                          "mixer.mamba": 2 * (N + 1),
                          "mixer.attn": N + 1, "moe.route": 3 * (N + 1),
                          "moe.experts": 3 * (N + 1),
                          "moe.shared": 3 * (N + 1)}
    segs = s.segments()
    assert segs == sorted(segs) and {n for *_, n in segs} <= LM_SPANS


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "sorted"])
def test_counters_on_a_known_input(model, monkeypatch, dense):
    """A 9-token prompt and 5 forced tokens at batch 1: the tokens, the
    causal pairs of the prefill and of each decode step (position p attends
    p + 1 keys), no expert pair dropped, and the host syncs: the prompt's
    copy, one position vector a decode step, the argmax after the last
    forced token, and with the sorted MoE one per-expert count read a
    layer a forward."""
    mcfg, params = model
    monkeypatch.setattr(MoE, "_dense_form", lambda x: dense)
    n, N = 9, 5
    with tracing.session() as s:
        _serve(mcfg, params, n, N)
    assert _total(s, "tokens.prefill") == n
    assert _total(s, "tokens.decode") == N
    assert _total(s, "attn.prefill_pairs") == n * (n + 1) // 2
    assert _total(s, "attn.decode_pairs") == sum(n + k for k in range(1, N + 1))
    assert _total(s, "moe.dropped") == 0
    syncs = {k: c["host_syncs"] for k, c in s.counters().items()}
    want = {"lm.prefill": 1, "lm.step": N + 1}
    if not dense:
        want["moe.experts"] = 3 * (N + 1)
    assert {k: v for k, v in syncs.items() if v} == want


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "sorted"])
def test_moe_assigned_counts_the_routed_pairs(model, monkeypatch, dense):
    """``moe.assigned``: the (token, held expert) pairs the router chose,
    counted from its top k here."""
    mcfg, params = model
    monkeypatch.setattr(MoE, "_dense_form", lambda x: dense)
    p = {k: t[0] for k, t in params["stages"][0]["moe"].items()}
    x = torch.randn(2, 7, 64, generator=torch.Generator().manual_seed(8))
    top = torch.topk(x.reshape(14, 64) @ p["router"], mcfg.top_k).indices
    want = int((top < mcfg.n_held).sum())  # share 0 holds experts 0, 1
    assert 0 < want < 14 * mcfg.top_k
    with tracing.session() as s:
        MoE.moe_apply(mcfg, p, x)
    assert _total(s, "moe.assigned") == want
    assert _total(s, "moe.dropped") == 0


def test_device_tensor_counts_are_read_with_the_counters():
    with tracing.session() as s:
        with tracing.span("a"):
            tracing.count("n", torch.tensor(3))
            tracing.count("n", 4)
            tracing.count("n", torch.tensor([5]).sum())
    c = s.counters()
    assert c["a"] == {"host_syncs": 0, "host_wait_ns": 0, "n": 12}
    assert s.counters() == c


def test_nothing_is_recorded_outside_a_session(model):
    mcfg, params = model
    _serve(mcfg, params, 6, 2)
    tracing.count("n", 1)
    assert tracing.last_session() is None


def test_the_nc_path_records_its_own_spans_and_counters_only():
    """A served tiny Inception batch: the spans are the Neural Cache
    path's, none of the LM's, and every counter dict holds just
    ``host_syncs``, ``host_wait_ns`` and the requantization's
    ``requant.launches`` and ``requant.rows``."""
    from ncbench.builders import inception
    from ncbench.conftest import TINY

    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.Cell.find(copy.deepcopy(manifest),
                             "inception_v3-hostq.throughput", ROOT)
    cell.config.update(TINY)
    params = inception.make_params(cell.config,
                                   torch.Generator().manual_seed(5), CPU)
    engine = inception.build_engine(params, cell.config, {"batch": 2}, CPU)
    images = inception.make_images(cell.config, 2,
                                   torch.Generator().manual_seed(11), CPU)
    with tracing.session() as s:
        for i, img in enumerate(images):
            engine.submit(inception.request(i, img))
        assert engine.step()
    assert not set(_counts(s)) & LM_SPANS
    assert "serve.step" in _counts(s)
    nc_counters = {"host_syncs", "host_wait_ns", "requant.launches",
                   "requant.rows"}
    assert all({"host_syncs", "host_wait_ns"} <= set(c) <= nc_counters
               for c in s.counters().values())
    assert _total(s, "requant.launches") > 0
    assert _total(s, "host_syncs") > 0
