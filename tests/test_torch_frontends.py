"""The audio and vision LM families through the port, against the JAX
reference, at reduced ``musicgen-large`` (MHA, layernorm, gelu, EnCodec
token ids) and ``internvl2-26b`` (GQA, rmsnorm, swiglu, precomputed patch
embeddings), float32, with the reference's weights carried across by
``params_from_jax``.  Prefill by tokens and by embeddings, decode steps and
the serving engine; the stub frontends; the SSM and hybrid families build.
Tolerances (float32): logits and caches 1e-4, as for the dense family;
served tokens equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget
from repro.configs import reduced_config as rreduced
from repro.launch import serve as rserve
from repro.models import frontends as RF
from repro.models import transformer as RT
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduced_config as treduced
from repro_torch.launch import serve as tserve
from repro_torch.models import frontends as TF
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

torch.set_num_threads(1)
ARCHS = ["internvl2-26b", "musicgen-large"]


@pytest.fixture(autouse=True)
def _jax_32_bit():
    with jax.enable_x64(False):
        yield


_MODELS: dict = {}


def _model(name):
    if name not in _MODELS:
        with jax.enable_x64(False):
            rc, tc = rreduced(rget(name)), treduced(tget(name))
            params = RT.init_lm(rc, jax.random.key(0))
            pnp = jax.tree.map(np.asarray, params)
        _MODELS[name] = (rc, tc, params, TT.params_from_jax(pnp,
                                                           device="cpu"))
    return _MODELS[name]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _tokens(n, seed, vocab=256, batch=2):
    return np.random.default_rng(seed).integers(
        0, vocab, (batch, n)).astype(np.int32)


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_by_tokens_matches_reference(name):
    rc, tc, params, tparams = _model(name)
    toks = _tokens(29, seed=1)
    rl, rcache = RT.prefill(rc, params, jnp.asarray(toks), max_len=40)
    tl, tcache = TT.prefill(tc, tparams, torch.from_numpy(toks), max_len=40)
    _close(tl.numpy(), rl, 1e-4)
    for key in ("k", "v"):
        _close(tcache[0]["attn"][key].numpy(), rcache[0]["attn"][key], 1e-4)


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_by_embeds_matches_reference(name):
    """A ``vision_patch`` prefill takes precomputed embeddings; the same
    numpy embeddings through both packages, and embeddings gathered from
    the port's own table equal to a prefill by those tokens."""
    rc, tc, params, tparams = _model(name)
    emb = (np.random.default_rng(2).standard_normal((2, 23, rc.d_model))
           * 0.02).astype(np.float32)
    rl, _ = RT.prefill(rc, params, embeds=jnp.asarray(emb), max_len=30)
    tl, _ = TT.prefill(tc, tparams, embeds=torch.from_numpy(emb), max_len=30)
    _close(tl.numpy(), rl, 1e-4)
    toks = torch.from_numpy(_tokens(23, seed=3))
    by_tok, _ = TT.prefill(tc, tparams, toks, max_len=30)
    by_emb, _ = TT.prefill(tc, tparams, embeds=tparams["embed"][toks.long()],
                           max_len=30)
    assert torch.equal(by_tok, by_emb)


@pytest.mark.parametrize("name", ARCHS)
def test_decode_steps_match_reference(name):
    rc, tc, params, tparams = _model(name)
    toks = _tokens(13, seed=4)
    rl, rcache = RT.prefill(rc, params, jnp.asarray(toks), max_len=24)
    tl, tcache = TT.prefill(tc, tparams, torch.from_numpy(toks), max_len=24)
    nxt = np.argmax(np.asarray(rl), -1)[:, None].astype(np.int32)
    pos = np.array([13, 13], np.int32)
    for _ in range(3):
        rl, rcache = RT.decode_step(rc, params, jnp.asarray(nxt), rcache,
                                    jnp.asarray(pos))
        tl, tcache = TT.decode_step(tc, tparams, torch.from_numpy(nxt),
                                    tcache, torch.from_numpy(pos))
        _close(tl.numpy(), rl, 1e-4)
        nxt = np.argmax(np.asarray(rl), -1)[:, None].astype(np.int32)
        pos = pos + 1


@pytest.mark.parametrize("name", ARCHS)
def test_serving_engine_matches_reference(name):
    rc, tc, params, tparams = _model(name)
    prompts = [p[0] for p in (_tokens(n, seed=n, batch=1)
                              for n in (3, 11, 17, 6))]
    out = {}
    for mod, cfg, p, kw in ((rserve, rc, params, {}),
                            (tserve, tc, tparams, dict(device="cpu"))):
        eng = mod.ServingEngine(cfg, p, max_batch=2, max_len=32, **kw)
        for i, pr in enumerate(prompts):
            eng.submit(mod.Request(rid=i, prompt=pr, max_tokens=4))
        out[mod] = ({r.rid: r.out for r in eng.run()}, eng.steps)
    assert out[tserve] == out[rserve] and len(out[tserve][0]) == 4


def test_musicgen_reaches_layernorm_and_gelu(monkeypatch):
    """musicgen-large is MHA with layernorm and gelu: its parameters carry
    the norm biases and no gate, and a forward calls both functions."""
    full = tget("musicgen-large")
    assert (full.n_heads, full.n_kv_heads, full.norm, full.act) == (
        32, 32, "layernorm", "gelu")
    _, tc, _, tparams = _model("musicgen-large")
    st = tparams["stages"][0]
    assert "b" in st["norm1"] and "wg" not in st["mlp"]
    seen = {"layer_norm": 0, "gelu": 0}
    real_ln, real_gelu = TL.layer_norm, TL.F.gelu

    def layer_norm(*a, **k):
        seen["layer_norm"] += 1
        return real_ln(*a, **k)

    def gelu(*a, **k):
        seen["gelu"] += 1
        return real_gelu(*a, **k)

    monkeypatch.setattr(TL, "layer_norm", layer_norm)
    monkeypatch.setattr(TL.F, "gelu", gelu)
    TT.prefill(tc, tparams, torch.from_numpy(_tokens(5, seed=5)))
    # two norms a layer plus the final one; one gelu a layer
    assert seen == {"layer_norm": 2 * tc.n_layers + 1, "gelu": tc.n_layers}


def test_stub_frontends_shapes_seeds_and_device_rule():
    cfg = treduced(tget("internvl2-26b"), dtype="bfloat16")
    e = TF.stub_embeddings(cfg, torch.Generator().manual_seed(0), 2, 9,
                           device="cpu")
    again = TF.stub_embeddings(cfg, torch.Generator().manual_seed(0), 2, 9,
                               device="cpu")
    ref = RF.stub_embeddings(rreduced(rget("internvl2-26b"),
                                      dtype="bfloat16"),
                             jax.random.key(0), 2, 9)
    assert tuple(e.shape) == ref.shape and str(e.dtype)[6:] == str(ref.dtype)
    assert torch.equal(e, again)
    assert abs(float(e.float().std()) / 0.02 - 1) < 0.1
    mg = treduced(tget("musicgen-large"))
    t = TF.stub_tokens(mg, torch.Generator().manual_seed(1), 3, 50,
                       device="cpu")
    rt = RF.stub_tokens(rreduced(rget("musicgen-large")), jax.random.key(1),
                        3, 50)
    assert tuple(t.shape) == rt.shape and t.dtype == torch.int32
    assert int(t.min()) >= 0 and int(t.max()) < mg.vocab_size
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            TF.stub_tokens(mg, torch.Generator(), 1, 4)
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            TF.stub_embeddings(cfg, torch.Generator(), 1, 4)


@pytest.mark.parametrize("name", ["mamba2-2.7b", "hymba-1.5b"])
def test_ssm_and_hybrid_still_raise(name):
    """The SSM and hybrid families no longer raise: their parameters and
    caches build on the CPU (held against the reference in
    ``test_torch_mamba2.py`` and ``test_torch_hybrid.py``)."""
    cfg = treduced(tget(name))
    params = TT.init_lm(cfg, torch.Generator(), device="cpu")
    caches = TT.init_caches(cfg, 1, 8, device="cpu")
    assert all("ssm" in st for st in params["stages"])
    assert all(tuple(c["ssm"]["ssm"].shape)
               == (st["ssm"]["A_log"].shape[0], 1, cfg.ssm_heads,
                   cfg.ssm_head_dim, cfg.ssm_state)
               for c, st in zip(caches, params["stages"]))


@pytest.mark.parametrize("name", ARCHS + ["moonshot-v1-16b-a3b"])
def test_serve_cli_new_families_on_cpu(name, capsys):
    rc = tserve.main(["--arch", name, "--reduced", "--device", "cpu",
                      "--requests", "2", "--max-tokens", "3",
                      "--prompt-len", "5", "--max-len", "16"])
    assert rc == 0
    assert "2 requests, 6 tokens" in capsys.readouterr().out
