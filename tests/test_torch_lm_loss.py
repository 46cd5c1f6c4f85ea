"""The port's ``lm_loss`` and its gradients against
``jax.value_and_grad(repro.models.transformer.lm_loss)``, for every LM
family at its reduced configuration (float32, weights carried across by
``params_from_jax``); the remat policies; the grad routing of attention;
and the port's pytree order against ``jax.tree.leaves``.

Tolerances (float32): the loss within rtol 1e-5; each gradient leaf within
1e-4 x that leaf's max |g|.  Remat: gradients bit-equal.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget
from repro.configs import reduced_config as rreduced
from repro.models import transformer as RT
from repro.optim.adamw import AdamW as RAdamW
from repro_torch import tree
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduced_config as treduced
from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch import steps as S
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.optim.adamw import AdamW

torch.set_num_threads(1)

B, T, CHUNK = 2, 37, 16  # T is not a multiple of the loss chunk

# (id, arch, overrides, by embeds)
CASES = [
    ("olmo", "olmo-1b", {}, False),
    ("qwen2-qkv-bias", "qwen2-7b", {}, False),
    ("moonshot-einsum", "moonshot-v1-16b-a3b", {"moe_impl": "einsum"}, False),
    ("moonshot-scatter", "moonshot-v1-16b-a3b", {"moe_impl": "scatter"},
     False),
    ("arctic-einsum", "arctic-480b", {"moe_impl": "einsum"}, False),
    ("arctic-scatter", "arctic-480b", {"moe_impl": "scatter"}, False),
    ("mamba2", "mamba2-2.7b", {}, False),
    ("hymba-w32", "hymba-1.5b", {}, False),
    ("musicgen", "musicgen-large", {}, False),
    ("internvl2-embeds", "internvl2-26b", {}, True),
]


@pytest.fixture(autouse=True)
def _jax_32_bit():
    """Some reference test modules turn x64 on process-wide; the reference
    is held here in JAX's default 32-bit mode."""
    with jax.enable_x64(False):
        yield


def _configs(arch, overrides):
    rc = rreduced(rget(arch), **overrides)
    tc = treduced(tget(arch), **overrides)
    assert dataclasses.asdict(rc) == dataclasses.asdict(tc)
    return rc, tc


def _batch(cfg, seed, embeds):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    labels[0, :3] = -1  # masked positions
    labels[1, -5:] = -1
    out = {"labels": labels}
    if embeds:
        out["embeds"] = rng.standard_normal((B, T, cfg.d_model)).astype(
            np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (B, T)).astype(
            np.int32)
    return out


def _reference(rc, params, batch):
    def loss(p):
        return RT.lm_loss(rc, p, batch.get("tokens"), batch["labels"],
                          embeds=batch.get("embeds"), loss_chunk=CHUNK)

    val, grads = jax.jit(jax.value_and_grad(loss))(params)
    return float(val), [np.asarray(g) for g in jax.tree.leaves(grads)]


def _port_value_and_grad(tc, tparams, batch):
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    leaves, treedef = tree.flatten(tparams)
    ps = [p.detach().requires_grad_(True) for p in leaves]
    loss = TT.lm_loss(tc, tree.unflatten(treedef, ps), tb.get("tokens"),
                      tb["labels"], embeds=tb.get("embeds"),
                      loss_chunk=CHUNK)
    grads = torch.autograd.grad(loss, ps, allow_unused=True)
    return float(loss.detach()), [
        np.zeros(p.shape, np.float32) if g is None else g.numpy()
        for p, g in zip(leaves, grads)]


def _check_grads(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        bound = 1e-4 * float(np.max(np.abs(w)))
        err = float(np.max(np.abs(g - w))) if g.size else 0.0
        assert err <= bound, (i, err, bound)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_lm_loss_and_grads_equal_reference(case):
    _, arch, overrides, embeds = case
    rc, tc = _configs(arch, overrides)
    params = RT.init_lm(rc, jax.random.key(1))
    tparams = TT.params_from_jax(jax.tree.map(np.asarray, params),
                                 device="cpu")
    batch = _batch(rc, 3, embeds)
    want_loss, want = _reference(rc, params, batch)
    got_loss, got = _port_value_and_grad(tc, tparams, batch)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    _check_grads(got, want)
    # the attention (and mixer) weights get a gradient: nothing detached
    named = dict(zip(tree.paths(tparams), got))
    for name, g in named.items():
        if name.split("/")[-1] in ("wq", "wk", "wv", "in_proj"):
            assert np.any(g != 0), name


def test_loss_counts_only_labelled_positions():
    """All labels -1 but one: the loss is that position's cross-entropy."""
    rc, tc = _configs("olmo-1b", {})
    params = TT.init_lm(tc, torch.Generator().manual_seed(0), device="cpu")
    batch = _batch(rc, 5, False)
    labels = np.full((B, T), -1, np.int32)
    labels[1, 20] = 7
    tok = torch.from_numpy(batch["tokens"])
    loss = TT.lm_loss(tc, params, tok, torch.from_numpy(labels),
                      loss_chunk=CHUNK)
    hidden, _ = TT.lm_apply(tc, params, tok)
    logits = TT.lm_logits(tc, params, hidden[1, 20])
    want = torch.logsumexp(logits, -1) - logits[7]
    torch.testing.assert_close(loss, want, rtol=1e-6, atol=1e-6)
    none = TT.lm_loss(tc, params, tok, torch.full((B, T), -1), loss_chunk=8)
    assert float(none) == 0.0  # divided by max(count, 1)


# ---------------------------------------------------------------------------
# remat: the same values under every policy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["olmo-1b", "hymba-1.5b",
                                  "moonshot-v1-16b-a3b"])
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_grads_bit_equal(arch, remat):
    tc = treduced(tget(arch))
    params = TT.init_lm(tc, torch.Generator().manual_seed(2), device="cpu")
    b = {k: torch.from_numpy(v) for k, v in _batch(tc, 4, False).items()}
    base_loss, base = S.value_and_grad(tc, params, b)
    loss, grads = S.value_and_grad(dataclasses.replace(tc, remat=remat),
                                   params, b)
    assert torch.equal(loss, base_loss)
    for g, w in zip(tree.leaves(grads), tree.leaves(base)):
        assert torch.equal(g, w)


def test_remat_recomputes_per_policy():
    """In the backward, ``full`` recomputes every forward op and ``dots``
    every op but the weight products (``aten.mm``), whose outputs it kept:
    so ``dots`` runs as many mm as no remat and as many batched products
    (the attention's ``bmm``) as ``full``."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {"mm": 0, "bmm": 0}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name in self.n:
                self.n[name] += 1
            return func(*args, **(kwargs or {}))

    tc = treduced(tget("olmo-1b"))
    params = TT.init_lm(tc, torch.Generator().manual_seed(2), device="cpu")
    tokens = torch.from_numpy(_batch(tc, 4, False)["tokens"])
    counts = {}
    for remat in ("none", "full", "dots"):
        cfg = dataclasses.replace(tc, remat=remat)
        ps = tree.map(lambda p: p.detach().requires_grad_(True), params)
        hidden, _ = TT.lm_apply(cfg, ps, tokens)
        with Count() as c:
            hidden.sum().backward()
        counts[remat] = c.n
    assert counts["dots"]["mm"] == counts["none"]["mm"]
    assert counts["full"]["mm"] > counts["none"]["mm"]
    assert counts["dots"]["bmm"] == counts["full"]["bmm"]
    assert counts["full"]["bmm"] > counts["none"]["bmm"]


# ---------------------------------------------------------------------------
# attention under grad: the scan; the kernel wrapper refuses grad operands
# ---------------------------------------------------------------------------
def _qkv(requires_grad):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 4, 9, 16, generator=g)
    k = torch.randn(1, 2, 9, 16, generator=g)
    v = torch.randn(1, 2, 9, 16, generator=g)
    return (q.requires_grad_(requires_grad), k, v)


def test_kernel_wrapper_refuses_grad_operands():
    q, k, v = _qkv(True)
    with pytest.raises(RuntimeError, match="no backward"):
        tfa.flash_attention(q, k, v)
    with torch.no_grad():
        out = tfa.flash_attention(q, k, v)
    torch.testing.assert_close(out, tfa.flash_attention_plain(
        q.detach(), k, v), rtol=0, atol=0)
    with torch.inference_mode():
        tfa.flash_attention(q.detach(), k, v)
    tfa.flash_attention(*_qkv(False))  # nothing requires grad: runs


def test_scan_attention_has_gradient():
    q, k, v = _qkv(True)
    out = TL.flash_attention(q, k, v, q_chunk=4, kv_chunk=4)
    out.sum().backward()
    assert q.grad is not None and torch.all(torch.isfinite(q.grad))
    assert torch.any(q.grad != 0)


@pytest.fixture
def gpu():
    """Skips (decided at run time, not at collection) without a GPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py's train-grad phase "
                    "checks the same routing on the card")
    return torch.device("cuda")


def test_grad_forward_launches_no_kernel_on_gpu(gpu):
    tc = treduced(tget("olmo-1b"))
    params = TT.init_lm(tc, torch.Generator().manual_seed(0), device="cpu")
    b = {k: torch.from_numpy(v) for k, v in _batch(tc, 6, False).items()}
    before = tfa.flash_attention.launches
    loss, grads = S.value_and_grad(tc, tree.map(lambda p: p.to(gpu), params),
                                   {k: v.to(gpu) for k, v in b.items()})
    assert tfa.flash_attention.launches == before
    want_loss, want = S.value_and_grad(tc, params, b)
    torch.testing.assert_close(loss.cpu(), want_loss, rtol=1e-5, atol=0)
    for g, w in zip(tree.leaves(grads), tree.leaves(want)):
        bound = 1e-4 * float(w.abs().max())
        assert float((g.cpu() - w).abs().max()) <= bound


# ---------------------------------------------------------------------------
# pytree order: the port's leaves are jax.tree.leaves' order
# ---------------------------------------------------------------------------
ARCHS = sorted({c[1] for c in CASES})  # one case per config, all families


@pytest.mark.parametrize("arch", ARCHS)
def test_tree_order_equals_jax(arch):
    overrides = {}
    rc, tc = _configs(arch, overrides)
    params = RT.init_lm(rc, jax.random.key(0))
    tparams = TT.params_from_jax(jax.tree.map(np.asarray, params),
                                 device="cpu")
    want = [np.asarray(x) for x in jax.tree.leaves(params)]
    got = tree.leaves(tparams)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    for quantized in (False, True):
        rstate = RAdamW(quantize_moments=quantized).init(params)
        tstate = AdamW(quantize_moments=quantized).init(tparams)
        rl = jax.tree.leaves(rstate)
        tl = tree.leaves(tstate)
        assert [tuple(x.shape) for x in tl] == [x.shape for x in rl]
        assert [str(x.dtype).replace("torch.", "") for x in tl] == [
            str(x.dtype) for x in rl]
    leaves, treedef = tree.flatten(tparams)
    rebuilt = tree.unflatten(treedef, leaves)
    assert tree.leaves(rebuilt) == leaves
    assert str(treedef).count("*") == len(leaves)
    paths = tree.paths(tparams)
    assert len(paths) == len(leaves) and paths[0] == "/embed"
    want_paths = ["".join(f"/{getattr(k, 'key', getattr(k, 'idx', k))}"
                          for k in path)
                  for path, _ in jax.tree_util.tree_flatten_with_path(
                      params)[0]]
    assert paths == want_paths


def test_tree_namedtuples_and_none():
    from repro_torch.optim.adamw import MomentState
    t = {"b": [1, None, (2, 3)], "a": MomentState(4, 5), "c": {}}
    want = jax.tree.leaves({"b": [1, None, (2, 3)],
                            "a": MomentState(4, 5), "c": {}})
    assert tree.leaves(t) == want == [4, 5, 1, 2, 3]
    leaves, treedef = tree.flatten(t)
    back = tree.unflatten(treedef, [x * 10 for x in leaves])
    assert back == {"b": [10, None, (20, 30)], "a": MomentState(40, 50),
                    "c": {}}
    assert list(back) == ["b", "a", "c"]  # the original key order
    with pytest.raises(ValueError):
        tree.unflatten(treedef, leaves[:-1])
