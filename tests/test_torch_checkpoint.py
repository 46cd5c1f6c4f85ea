"""The port's checkpoints against ``repro.checkpoint``, both ways.

The port writes and the reference restores (float32 trees): leaves
byte-equal, the same ``n_leaves`` and ``extras``.  The reference writes and
the port restores, bfloat16 leaves included: bits equal.  The reference's
own ``restore_checkpoint`` raises on its bfloat16 leaves (numpy has no
cast from the ``|V2`` bytes it wrote them as); that fault is pinned here
beside the port's bit-exact restore of the same files.  Also
``latest_step``, ``AsyncCheckpointer``'s ``keep=3`` collection and its
error raised at ``wait()``, and the leaf-count ``ValueError``.
"""
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as RCk
from repro.optim.adamw import AdamW as RAdamW
from repro_torch import tree
from repro_torch.checkpoint import checkpoint as TCk
from repro_torch.optim.adamw import AdamW, MomentState

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _jax_32_bit():
    with jax.enable_x64(False):
        yield


def _params(dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"embed": torch.randn(10, 4, generator=g).to(dtype),
            "stages": [{"attn": {"wq": torch.randn(2, 4, 4, generator=g)
                                 .to(dtype)},
                        "norm1": {}}],
            "final_norm": {"w": torch.ones(4, dtype=dtype)}}


def _bits(t: torch.Tensor) -> bytes:
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _jax_like(tparams):
    return jax.tree.map(lambda t: jnp.zeros(t.shape, str(t.dtype)[6:]),
                        tparams)


def test_port_writes_reference_restores(tmp_path):
    params = _params()
    opt = AdamW(quantize_moments=True).init(params)
    extras = {"data": {"next_index": 4}, "arch": "olmo-1b"}
    TCk.save_checkpoint(tmp_path, 4, {"params": params, "opt_state": opt},
                        extras=extras)
    rlike = {"params": _jax_like(params),
             "opt_state": RAdamW(quantize_moments=True).init(
                 _jax_like(params))}
    step, trees, got_extras = RCk.restore_checkpoint(tmp_path, rlike)
    assert step == 4 and got_extras == extras
    for name, t in (("params", params), ("opt_state", opt)):
        rl, tl = jax.tree.leaves(trees[name]), tree.leaves(t)
        assert len(rl) == len(tl)
        for a, b in zip(rl, tl):
            assert np.asarray(a).tobytes() == _bits(b)
    manifest = json.loads((tmp_path / "step_4" / "manifest.json").read_text())
    assert manifest["trees"]["params"]["n_leaves"] == 3
    assert manifest["trees"]["opt_state"]["n_leaves"] == 1 + 2 * 2 * 3
    assert manifest["step"] == 4 and manifest["extras"] == extras


def _reference_bf16_checkpoint(path):
    rng = np.random.default_rng(1)
    tree_ = {"w": jnp.asarray(rng.standard_normal((5, 3)), jnp.bfloat16),
             "b": [jnp.asarray(rng.standard_normal(3), jnp.float32),
                   jnp.asarray(7, jnp.int32)]}
    RCk.save_checkpoint(path, 2, {"params": tree_}, extras={"k": 1})
    return tree_


def test_reference_writes_port_restores_bf16(tmp_path):
    want = _reference_bf16_checkpoint(tmp_path)
    like = {"w": torch.zeros(5, 3, dtype=torch.bfloat16),
            "b": [torch.zeros(3), torch.zeros((), dtype=torch.int32)]}
    step, trees, extras = TCk.restore_checkpoint(tmp_path, {"params": like},
                                                 device="cpu")
    assert step == 2 and extras == {"k": 1}
    got = trees["params"]
    assert got["w"].dtype == torch.bfloat16
    assert _bits(got["w"]) == np.asarray(want["w"]).view(np.int16).tobytes()
    assert _bits(got["b"][0]) == np.asarray(want["b"][0]).tobytes()
    assert int(got["b"][1]) == 7 and got["b"][1].dtype == torch.int32


def test_reference_cannot_restore_its_bf16_checkpoint(tmp_path):
    """A reference fault, pinned: its bf16 leaves are written as ``|V2``
    and its restore has no cast from them.  The port reads the same bytes
    as bfloat16 bits."""
    want = _reference_bf16_checkpoint(tmp_path)
    with np.load(tmp_path / "step_2" / "params.npz") as z:
        assert z["leaf_2"].dtype.str == "|V2"  # leaves b[0], b[1], w
    with pytest.raises(ValueError, match="No cast function"):
        RCk.restore_checkpoint(tmp_path, {"params": want})
    like = tree.map(lambda a: torch.zeros(
        a.shape, dtype=torch.bfloat16 if a.dtype == jnp.bfloat16
        else getattr(torch, str(a.dtype))), want)
    _, trees, _ = TCk.restore_checkpoint(tmp_path, {"params": like},
                                         device="cpu")
    assert (_bits(trees["params"]["w"])
            == np.asarray(want["w"]).view(np.int16).tobytes())


def test_port_bf16_round_trip_matches_reference_bytes(tmp_path):
    params = _params(torch.bfloat16, seed=3)
    TCk.save_checkpoint(tmp_path / "t", 1, {"params": params})
    RCk.save_checkpoint(tmp_path / "r", 1, {"params": jax.tree.map(
        lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16), params)})
    with np.load(tmp_path / "t/step_1/params.npz") as a, \
            np.load(tmp_path / "r/step_1/params.npz") as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            assert a[k].tobytes() == b[k].tobytes()
    _, trees, _ = TCk.restore_checkpoint(tmp_path / "t", {"params": params},
                                         device="cpu")
    for a, b in zip(tree.leaves(trees["params"]), tree.leaves(params)):
        assert a.dtype == b.dtype and _bits(a) == _bits(b)


def test_latest_step_and_keep_three(tmp_path):
    assert TCk.latest_step(tmp_path / "none") is None
    assert TCk.restore_checkpoint(tmp_path / "none", {}, device="cpu") == (
        None, None, None)
    ck = TCk.AsyncCheckpointer(tmp_path, keep=3)
    params = _params()
    for step in (1, 2, 3, 4, 5):
        ck.save(step, {"params": params}, extras={"s": step})
    ck.wait()
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_3", "step_4", "step_5"]
    (tmp_path / "step_9").mkdir()  # no manifest: not a complete checkpoint
    (tmp_path / "step_7.tmp-x").mkdir()
    assert TCk.latest_step(tmp_path) == 5
    assert RCk.latest_step(tmp_path) == 5
    step, trees, extras = TCk.restore_checkpoint(tmp_path, {"params": params},
                                                 device="cpu")
    assert (step, extras) == (5, {"s": 5})
    step, _, extras = TCk.restore_checkpoint(tmp_path, {"params": params},
                                             step=3, device="cpu")
    assert (step, extras) == (3, {"s": 3})


def test_async_snapshot_is_taken_at_save(tmp_path):
    params = _params()
    ck = TCk.AsyncCheckpointer(tmp_path)
    ck.save(1, {"params": params})
    before = _bits(params["embed"])
    params["embed"].add_(1.0)  # the caller moves on at once
    ck.wait()
    _, trees, _ = TCk.restore_checkpoint(tmp_path, {"params": params},
                                         device="cpu")
    assert _bits(trees["params"]["embed"]) == before


def test_async_error_raised_at_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ck = TCk.AsyncCheckpointer(blocker)
    ck.save(1, {"params": _params()})
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()  # raised once


def test_leaf_count_mismatch_raises(tmp_path):
    TCk.save_checkpoint(tmp_path, 1, {"params": _params()})
    like = _params()
    like["head"] = torch.zeros(2)
    with pytest.raises(ValueError, match=r"checkpoint params: 3 leaves, "
                                         r"expected 4 — structure "
                                         r"changed\?"):
        TCk.restore_checkpoint(tmp_path, {"params": like}, device="cpu")


def test_interrupted_save_leaves_no_checkpoint(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise KeyboardInterrupt

    monkeypatch.setattr(TCk.os, "rename", boom)
    with pytest.raises(KeyboardInterrupt):
        TCk.save_checkpoint(tmp_path, 1, {"params": _params()})
    assert list(tmp_path.iterdir()) == []


def test_restore_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the device rule is about its absence")
    TCk.save_checkpoint(tmp_path, 1, {"params": _params()})
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        TCk.restore_checkpoint(tmp_path, {"params": _params()})
    shutil.rmtree(tmp_path / "step_1")


def test_moment_state_restores_as_namedtuple(tmp_path):
    params = _params()
    opt = AdamW(quantize_moments=True).init(params)
    TCk.save_checkpoint(tmp_path, 1, {"opt_state": opt})
    _, trees, _ = TCk.restore_checkpoint(tmp_path, {"opt_state": opt},
                                         device="cpu")
    m0 = trees["opt_state"]["m"][0]
    assert isinstance(m0, MomentState) and m0.q.dtype == torch.int8
    assert trees["opt_state"]["count"].dtype == torch.int32
