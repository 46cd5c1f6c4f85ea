"""granite-4.0-h-small-ep8 on the port's LM path, at test size on the CPU,
against the plain reference (``tests/granite_plain.py``) on seeded random
weights (``tests/granite_cases.py``: every layer kind, the shared expert,
NoPE and the multipliers kept).

Tolerances: the program runs here in float32, like the reference, so the
gaps are float32 rounding of sums taken in another order (the chunked SSD
against the recurrence, the flash scan against a plain softmax, batched
GEMMs against row products): a few units of 1e-7 on logits of about 0.05.
``TOL = 2e-6`` leaves a factor of ten above that and stays far below what
a dropped term gives (a missing expert, the shared expert, or the residual
multiplier moves them by 1e-3 or more).
"""
import dataclasses
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

import granite_plain as plain  # noqa: E402
from granite_cases import CONFIG, STEPS, TRAFFIC, tiny_config  # noqa: E402
from ncbench.builders import granite as builder  # noqa: E402
from ncbench.references import granite as blocked  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.launch.serve import Request, ServingEngine  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe as MoE  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

CPU = torch.device("cpu")
TOL = 2e-6
ARCH = "granite-4.0-h-small-ep8"


@pytest.fixture(scope="module")
def model():
    cfg = tiny_config()
    params = builder.make_params(cfg, torch.Generator().manual_seed(3), CPU)
    return cfg, builder.model_config(cfg), params


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# the configuration
# ---------------------------------------------------------------------------
def test_config_file_is_the_registered_config():
    """The benchmark's file and ``get_config`` give one configuration, which
    ``REGISTRY`` (the reference's) does not list."""
    cfg = builder.model_config(json.loads(CONFIG.read_text()))
    assert cfg == get_config(ARCH)
    assert ARCH not in configs.REGISTRY and ARCH in configs.PORT_REGISTRY
    assert ARCH not in configs.ARCH_IDS


def test_config_widths_and_counts():
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.d_ff, cfg.shared_ff, cfg.vocab_size) == (
        40, 4096, 32, 8, 128, 768, 1536, 100352)
    assert (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.d_inner) == (
        128, 64, 128, 8192)
    assert [i for i, t in enumerate(cfg.layer_types) if t == "attention"] \
        == [5, 15, 25, 35]
    assert (cfg.n_experts, cfg.top_k, cfg.n_held) == (72, 10, 9)
    assert cfg.param_count() == 8_425_634_304  # held here: 16.9 GB in bf16
    whole = dataclasses.replace(cfg, experts_held=0)
    assert round(whole.param_count() / 1e9, 1) == 32.2  # the published 32B
    assert round(whole.active_param_count() / 1e9, 1) == 8.8  # A9B
    assert cfg.attention_multiplier == 0.0078125  # the scores' scale


def test_config_refuses_a_share_that_does_not_tile():
    cfg = get_config(ARCH)
    with pytest.raises(ValueError):
        dataclasses.replace(cfg, experts_held=10)
    with pytest.raises(ValueError):
        dataclasses.replace(cfg, expert_share=8)
    with pytest.raises(ValueError):
        dataclasses.replace(cfg, layer_types=cfg.layer_types[:-1])


def test_stages_follow_the_layer_pattern():
    stages = T.plan_stages(get_config(ARCH))
    assert [(s.start, s.length, s.kind) for s in stages] == [
        (0, 5, "mamba"), (5, 1, "attention"), (6, 9, "mamba"),
        (15, 1, "attention"), (16, 9, "mamba"), (25, 1, "attention"),
        (26, 9, "mamba"), (35, 1, "attention"), (36, 4, "mamba")]
    small = reduced_config(get_config(ARCH))
    assert small.layer_types == ("mamba", "attention", "mamba")
    assert (small.n_experts, small.n_held, small.shared_ff) == (16, 2, 96)


def test_caches_hold_each_kind_on_its_layers_only(model):
    _, mcfg, _ = model
    caches = T.init_caches(mcfg, 2, 24, device=CPU)
    kinds = [s.kind for s in T.plan_stages(mcfg)]
    assert [set(c) for c in caches] == [
        {"ssm"} if k == "mamba" else {"attn"} for k in kinds]
    assert tuple(caches[1]["attn"]["k"].shape) == (1, 2, 1, 24, 16)
    assert tuple(caches[0]["ssm"]["ssm"].shape) == (1, 2, 8, 16, 16)
    assert tuple(caches[0]["ssm"]["conv"].shape) == (1, 2, 3, 128 + 32)


def test_parameters_hold_each_kind_on_its_layers_only(model):
    _, mcfg, params = model
    program = params["program"]
    assert [set(s) for s in program["stages"]] == [
        {"norm1", "ssm", "norm2", "moe", "shared"},
        {"norm1", "attn", "norm2", "moe", "shared"},
        {"norm1", "ssm", "norm2", "moe", "shared"}]
    moe = program["stages"][0]["moe"]
    assert tuple(moe["router"].shape) == (1, 64, 16)  # routes over all 16
    assert tuple(moe["wi"].shape) == (1, 2, 64, 32)  # holds its 2
    assert "head" not in program  # tied


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def test_the_adapter_gives_the_programs_tree(model):
    """The builder's weights, drawn in the reference's layout and copied
    through its layout adapter, fill the tree that ``init_lm`` makes: the
    same leaves, shapes and dtypes, stage by stage."""
    _, mcfg, params = model
    made = T.init_lm(mcfg, torch.Generator().manual_seed(0), device=CPU)
    got = params["program"]
    assert set(got) == set(made)
    for a, b in zip([got["embed"], got["final_norm"], *got["stages"]],
                    [made["embed"], made["final_norm"], *made["stages"]]):
        if isinstance(a, dict):
            want = {p: (t.shape, t.dtype) for p, t in _leaves(b)}
            assert {p: (t.shape, t.dtype) for p, t in _leaves(a)} == want
        else:
            assert (a.shape, a.dtype) == (b.shape, b.dtype)


def _tensors(obj):
    """Every tensor in ``obj`` (dicts and lists of them), in order."""
    if torch.is_tensor(obj):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, list):
        for v in obj:
            yield from _tensors(v)


def test_the_reference_keeps_its_own_weights(model):
    """The reference's weights are the builder's own draw, the same for a
    seed, and the program holds copies: no leaf of the program shares
    storage with the reference's, and each layer's leaves reach the
    program in its layout."""
    cfg, _, params = model
    again = builder.make_params(cfg, torch.Generator().manual_seed(3), CPU)
    mine = {k: params[k] for k in ("embed", "final_norm", "layers")}
    theirs = {k: again[k] for k in ("embed", "final_norm", "layers")}
    assert all(torch.equal(a, b) for a, b in
               zip(_tensors(mine), _tensors(theirs), strict=True))
    ref_ptrs = {t.untyped_storage().data_ptr() for t in _tensors(mine)}
    prog = params["program"]
    assert not ref_ptrs & {t.untyped_storage().data_ptr()
                           for t in _tensors(prog)}
    ssm, attn = prog["stages"][0]["ssm"], prog["stages"][1]["attn"]
    lm, la = params["layers"][0], params["layers"][1]
    assert torch.equal(ssm["conv_w"][0], lm["conv_weight"].T)
    assert torch.equal(ssm["norm_w"][0], lm["norm"])
    assert torch.equal(attn["wk"][0], la["k"])
    assert torch.equal(prog["stages"][1]["moe"]["wg"][0],
                       la["experts"]["gate"])
    assert torch.equal(prog["stages"][2]["shared"]["wo"][0],
                       params["layers"][2]["shared"]["down"])
    # every norm and D away from 1, every conv bias away from 0
    assert not torch.equal(lm["D"], torch.ones_like(lm["D"]))
    assert lm["conv_bias"].abs().min() > 0


# ---------------------------------------------------------------------------
# prefill and decode against the plain reference
# ---------------------------------------------------------------------------
def _tokens(n, seed=0, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, n).tolist()


@pytest.mark.parametrize("n", [2, 7, 21])
def test_prefill_logits(model, n):
    """Prefill of 2, 7 and 21 tokens (the SSD's chunk is 8: one partial
    chunk, and three with padding)."""
    cfg, mcfg, params = model
    toks = _tokens(n, seed=n)
    got, _ = T.prefill(mcfg, params["program"], torch.tensor([toks]),
                       max_len=n + 4)
    want = plain.forward(params, toks, cfg)
    _close(got[0], want[-1])


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "sorted"])
def test_forced_decode_through_the_caches(model, monkeypatch, dense):
    """Three requests of 13, 5 and 30 tokens, each carrying a continuation
    of 8 forced tokens, served by ``ServingEngine`` at batch 3: the logits
    kept at the prefill and at decode steps 4 and 8 equal the reference's
    full forward over prompt plus continuation.  Both of the MoE layer's
    forms run: every held expert on every token, and the tokens sorted by
    expert (``moe._dense_form``)."""
    cfg, mcfg, params = model
    monkeypatch.setattr(MoE, "_dense_form", lambda x: dense)
    eng = ServingEngine(mcfg, params["program"], max_batch=3, max_len=48,
                        device=CPU)
    reqs = []
    for rid, n in enumerate([13, 5, 30]):
        toks = _tokens(n + 8, seed=100 + rid)
        reqs.append(Request(rid=rid, prompt=np.asarray(toks[:n], np.int32),
                            forced=np.asarray(toks[n:], np.int32),
                            max_tokens=9, keep=tuple(STEPS)))
        eng.submit(reqs[-1])
    done = eng.run()
    assert len(done) == 3 and not eng.failed and eng.steps == 8
    for r in reqs:
        toks = list(r.prompt) + list(r.forced)
        assert r.out[:8] == list(r.forced) and len(r.out) == 9
        want = plain.forward(params, toks, cfg)
        n = len(r.prompt)
        for k in STEPS:
            _close(r.kept[k], want[n - 1 + k])


def test_generation_feeds_the_argmax(model):
    """A request without a continuation is served as before: each decode
    step feeds the argmax of the last logits."""
    cfg, mcfg, params = model
    eng = ServingEngine(mcfg, params["program"], max_batch=2, max_len=32,
                        device=CPU)
    req = Request(rid=0, prompt=np.asarray(_tokens(9, seed=4), np.int32),
                  max_tokens=4, keep=(0, 3))
    eng.submit(req)
    eng.run()
    toks = list(req.prompt) + req.out[:3]
    want = plain.forward(params, toks, cfg)
    assert req.out == [int(torch.argmax(want[8 + k])) for k in range(4)]
    _close(req.kept[3], want[11])


def test_the_builder_serves_the_cell(model):
    """The benchmark's builder at test size: drawn rows, the engine, the
    answers, and the blocked reference's logits at the kept steps."""
    cfg, _, params = model
    cfg = dict(cfg)
    engine = builder.build_engine(params, cfg, dict(TRAFFIC), CPU)
    rows = builder.make_images(cfg, 3, torch.Generator().manual_seed(5), CPU)
    batch = [builder.request(i, r) for i, r in enumerate(rows)]
    assert all(len(r.forced) == TRAFFIC["continuation"] for r in batch)
    assert all(TRAFFIC["prompt_min"] <= len(r.prompt) <= TRAFFIC["prompt_max"]
               for r in batch)
    for r in batch:
        engine.submit(r)
    engine.step()
    answers = builder.collect(engine, batch)
    assert all(ok for ok, _ in answers)
    served = torch.stack([a for _, a in answers])
    _close(served, blocked.logits(params, rows, cfg, block=2))


# ---------------------------------------------------------------------------
# the held experts' share
# ---------------------------------------------------------------------------
def test_eight_shares_add_up_to_the_uncut_layer(model):
    """The MoE branch of one layer: the eight shares' parts (each a layer
    told which two of the 16 experts it holds), with the shared expert
    counted once, add up to the uncut reference's routed MoE plus shared
    expert over all 16 experts."""
    cfg, mcfg, _ = model
    gen = torch.Generator().manual_seed(11)
    uncut = dataclasses.replace(mcfg, experts_held=0)
    # the uncut layer's weights, drawn here in the reference's layout
    ref_layer = {"router": torch.randn(64, 16, generator=gen) / 8,
                 "first_expert": 0,
                 "experts": {"gate": torch.randn(16, 64, 32, generator=gen) / 8,
                             "up": torch.randn(16, 64, 32, generator=gen) / 8,
                             "down": torch.randn(16, 32, 64, generator=gen)
                             / 32 ** 0.5}}
    shared = {"gate": torch.randn(64, 48, generator=gen) / 8,
              "up": torch.randn(64, 48, generator=gen) / 8,
              "down": torch.randn(48, 64, generator=gen) / 48 ** 0.5}
    ex = ref_layer["experts"]
    v = torch.randn(2, 9, 64, generator=gen)
    total = L.mlp_apply(uncut, {"wg": shared["gate"], "wi": shared["up"],
                                "wo": shared["down"]}, v)
    for s in range(8):
        part = dataclasses.replace(mcfg, expert_share=s)
        held = {"router": ref_layer["router"]}
        held.update({n: ex[r][2 * s:2 * s + 2] for n, r in
                     (("wg", "gate"), ("wi", "up"), ("wo", "down"))})
        total = total + MoE.moe_apply(part, held, v)
    want = plain.moe(cfg, ref_layer, v.reshape(18, 64)) + plain.swiglu(
        v.reshape(18, 64), shared)
    _close(total.reshape(18, 64), want)


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "sorted"])
def test_held_experts_compute_only_their_part(model, monkeypatch, dense):
    """A share's layer output is the reference's with its own two experts:
    the others' tokens are routed (the router keeps all 16 outputs) and
    left out."""
    cfg, mcfg, params = model
    monkeypatch.setattr(MoE, "_dense_form", lambda x: dense)
    held = {k: t[0] for k, t in
            params["program"]["stages"][0]["moe"].items()}
    v = torch.randn(1, 11, 64, generator=torch.Generator().manual_seed(2))
    got = MoE.moe_apply(mcfg, held, v)
    _close(got[0], plain.moe(cfg, params["layers"][0], v[0]))


# ---------------------------------------------------------------------------
# attention without positions, at the config's scale
# ---------------------------------------------------------------------------
def test_nope_attention_ignores_positions(model):
    _, mcfg, params = model
    ap = {k: t[0] for k, t in params["program"]["stages"][1]["attn"].items()}
    x = torch.randn(1, 6, 64, generator=torch.Generator().manual_seed(1))
    a, _ = L.attention_apply(mcfg, ap, x, torch.arange(6))
    b, _ = L.attention_apply(mcfg, ap, x, torch.arange(6) + 1000)
    assert torch.equal(a, b)
    rope = dataclasses.replace(mcfg, position_embedding="rope")
    c, _ = L.attention_apply(rope, ap, x, torch.arange(6) + 1000)
    assert not torch.equal(a, c)


@pytest.mark.parametrize("scale", [None, 0.0078125, 0.3])
def test_flash_attention_scale(scale):
    """The plain kernel version and the layer's scan take the caller's
    scale (None: 1/sqrt(D)) as a softmax over scaled scores does."""
    from repro_torch.kernels.flash_attention import flash_attention_plain

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 4, 9, 16, generator=g) for _ in range(3))
    k, v = k[:, :2], v[:, :2]
    s = (q @ k.repeat_interleave(2, 1).transpose(-1, -2)) * (
        0.25 if scale is None else scale)
    s = s.masked_fill(~torch.ones(9, 9, dtype=torch.bool).tril(), -torch.inf)
    want = torch.softmax(s, -1) @ v.repeat_interleave(2, 1)
    _close(flash_attention_plain(q, k, v, scale=scale), want, 1e-6)
    _close(L.flash_attention(q, k, v, scale=scale, q_chunk=4, kv_chunk=4),
           want, 1e-6)


# ---------------------------------------------------------------------------
# the two references
# ---------------------------------------------------------------------------
def test_blocked_reference_agrees_with_the_plain_one(model):
    """``ncbench/references/granite.py`` (chunked SSD, layers in blocks)
    against this directory's plain reference (the recurrence), at chunk 8
    over prompts of 5 to 40 tokens plus 8."""
    cfg, _, params = model
    rows = builder.make_images(dict(cfg, traffic=TRAFFIC), 4,
                               torch.Generator().manual_seed(9), CPU)
    got = blocked.logits(params, rows, cfg, block=3)
    for i, row in enumerate(rows.tolist()):
        n, steps, toks = builder.split_row(row)
        want = plain.forward(params, toks, cfg)
        _close(got[i], want[[n - 1 + k for k in steps]])


def test_control_rounds_the_weights_to_e4m3():
    w = torch.randn(64, 32, generator=torch.Generator().manual_seed(0))
    r = blocked._weight(w, 8)
    s = w.abs().max() / 448
    assert torch.equal((r / s).to(torch.float8_e4m3fn).to(torch.float32)
                       * s, r)
    assert 0 < (r - w).abs().max() <= w.abs().max() / 16
    assert torch.equal(blocked._weight(w, 16), w)


def test_serve_cli_runs_granite_reduced(capsys):
    from repro_torch.launch import serve

    assert serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--requests", "2", "--max-tokens", "3"]) == 0
    assert "granite-4.0-h-small-ep8" in capsys.readouterr().out
