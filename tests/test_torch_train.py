"""The port's train step and training loop against ``repro.launch``.

* ``make_train_step`` with 1 and 2 microbatches against the reference's
  jitted step on the reduced olmo (float32, the reference's weights):
  loss and grad norm within rtol 1e-5, the moments within rtol 1e-5 and
  1e-4 x the leaf's max (the gradients' own bound), the parameters within
  atol 1e-6.
* ``default_microbatches`` equal to the reference's on a one-device mesh
  for every config at ``train_4k`` and two small shapes.
* The loop: the reference's ``train`` writes step 4 of
  ``tests/test_train_serve.py``'s reduced olmo; from copies of that
  directory the reference and the port each resume to step 6.  Losses
  within rtol 1e-5, final parameters within atol 1e-6, and the reference
  restores the port's step-6 checkpoint.
* The watchdog's flags, a SIGTERM raised inside a step, bit-equal resumed
  losses on the CPU, and the device rule.
"""
import dataclasses
import shutil
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as r_restore
from repro.configs import REGISTRY as RREG
from repro.configs import get_config as rget
from repro.configs import reduced_config as rreduced
from repro.configs.base import ShapeSpec as RShape
from repro.launch import steps as RS
from repro.launch import train as RTrain
from repro.models import transformer as RT
from repro_torch import tree
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduced_config as treduced
from repro_torch.configs.base import SHAPES, ShapeSpec
from repro_torch.launch import steps as S
from repro_torch.launch import train as TTrain
from repro_torch.models import transformer as TT

torch.set_num_threads(1)

TINY = dict(n_layers=2, d_model=32, d_ff=64, vocab_size=64, head_dim=8)
LOOP_SHAPE = ShapeSpec("tiny", seq_len=32, global_batch=4, kind="train")


@pytest.fixture(autouse=True)
def _jax_32_bit():
    with jax.enable_x64(False):
        yield


def _one_device_mesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))


def _to_torch(a):
    return torch.from_numpy(np.array(a))


def _close_tree(got, want, rtol, scaled_atol=0.0, atol=0.0):
    gl, wl = tree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for i, (g, w) in enumerate(zip(gl, wl)):
        w = np.asarray(w)
        bound = atol + scaled_atol * float(np.max(np.abs(w), initial=0))
        np.testing.assert_allclose(g.numpy(), w, rtol=rtol, atol=bound,
                                   err_msg=str(i))


@pytest.mark.parametrize("n_mb", [1, 2])
def test_train_step_equals_reference(n_mb):
    rc, tc = rreduced(rget("olmo-1b")), treduced(tget("olmo-1b"))
    params = RT.init_lm(rc, jax.random.key(0))
    tparams = TT.params_from_jax(jax.tree.map(np.asarray, params),
                                 device="cpu")
    r_opt, t_opt = RS.make_optimizer(rc, total=20), S.make_optimizer(
        tc, total=20)
    r_state, t_state = r_opt.init(params), t_opt.init(tparams)
    r_step = jax.jit(RS.make_train_step(rc, r_opt, n_mb))
    t_step = S.make_train_step(tc, t_opt, n_mb)
    rng = np.random.default_rng(n_mb)
    for _ in range(2):
        batch = {k: rng.integers(0, rc.vocab_size, (4, 24)).astype(np.int32)
                 for k in ("tokens", "labels")}
        batch["labels"][0, :5] = -1
        params, r_state, r_m = r_step(params, r_state, batch)
        tparams, t_state, t_m = t_step(
            tparams, t_state, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(t_m[k]), float(r_m[k]),
                                       rtol=1e-5)
        _close_tree(tparams, params, rtol=0, atol=1e-6)
        _close_tree(t_state, r_state, rtol=1e-5, scaled_atol=1e-4)
    assert int(t_state["count"]) == 2


def test_microbatches_average_the_full_batch():
    """Two microbatches give the full batch's loss (equal halves, no
    masked labels) and the same update within float32 rounding."""
    tc = treduced(tget("olmo-1b"))
    params = TT.init_lm(tc, torch.Generator().manual_seed(0), device="cpu")
    opt = S.make_optimizer(tc)
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, tc.vocab_size, (4, 16), generator=g,
                              dtype=torch.int32)
             for k in ("tokens", "labels")}
    one = S.make_train_step(tc, opt, 1)(params, opt.init(params), batch)
    two = S.make_train_step(tc, opt, 2)(params, opt.init(params), batch)
    torch.testing.assert_close(two[2]["loss"], one[2]["loss"], rtol=1e-6,
                               atol=0)
    for a, b in zip(tree.leaves(two[0]), tree.leaves(one[0])):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [
    SHAPES["train_4k"], ShapeSpec("s1", 1024, 4, "train"),
    ShapeSpec("s2", 128, 8, "train"), SHAPES["prefill_32k"]],
    ids=lambda s: s.name)
@pytest.mark.parametrize("arch", sorted(RREG))
def test_default_microbatches_equal_reference(arch, shape):
    want = RS.default_microbatches(
        rget(arch), RShape(shape.name, shape.seq_len, shape.global_batch,
                           shape.kind), _one_device_mesh())
    assert S.default_microbatches(tget(arch), shape) == want


def test_default_microbatches_full_olmo_card_shape():
    assert S.default_microbatches(tget("olmo-1b"),
                                  ShapeSpec("card", 1024, 4, "train")) == 2


def test_make_optimizer_equals_reference():
    for arch in sorted(RREG):
        assert (S.make_optimizer(tget(arch)).quantize_moments
                == RS.make_optimizer(rget(arch)).quantize_moments)
    opt = S.make_optimizer(tget("olmo-1b"), total=1000)
    lr = opt.lr(torch.arange(0, 1200, 7, dtype=torch.int32))
    want = RS.make_optimizer(rget("olmo-1b"), total=1000).lr(
        jnp.arange(0, 1200, 7, dtype=jnp.int32))
    np.testing.assert_allclose(lr.numpy(), np.asarray(want), rtol=1e-6)


def test_prefill_and_decode_steps():
    tc = treduced(tget("qwen2-7b"))
    params = TT.init_lm(tc, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, tc.vocab_size, (2, 9),
                           generator=torch.Generator().manual_seed(1))
    logits, caches = S.make_prefill_step(tc, max_len=12)(
        params, {"tokens": tokens})
    want, _ = TT.prefill(tc, params, tokens, max_len=12)
    assert torch.equal(logits, want)
    nxt = torch.argmax(logits, -1, keepdim=True)
    step_logits, _ = S.make_decode_step(tc)(params, caches,
                                            {"tokens": nxt, "pos": 9})
    full = TT.lm_logits(tc, params, TT.lm_apply(
        tc, params, torch.cat([tokens, nxt], 1))[0][:, -1])
    torch.testing.assert_close(step_logits, full, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------
def _ref_train(steps, ckpt_dir):
    cfg = rreduced(rget("olmo-1b"), **TINY)
    return RTrain.train(cfg, RShape("tiny", 32, 4, "train"), steps=steps,
                        ckpt_dir=str(ckpt_dir), ckpt_every=2, log_every=100,
                        mesh=_one_device_mesh())


def _port_train(steps, ckpt_dir, **kw):
    cfg = treduced(tget("olmo-1b"), **TINY)
    return TTrain.train(cfg, LOOP_SHAPE, steps=steps,
                        ckpt_dir=None if ckpt_dir is None else str(ckpt_dir),
                        ckpt_every=2, log_every=100, device="cpu", **kw)


def test_port_resumes_the_reference_run(tmp_path):
    _ref_train(4, tmp_path / "r")
    shutil.copytree(tmp_path / "r", tmp_path / "t")
    r_params, _, r_hist = _ref_train(6, tmp_path / "r")
    t_params, _, t_hist = _port_train(6, tmp_path / "t")
    assert [h["step"] for h in t_hist] == [h["step"] for h in r_hist] == [
        4, 5]
    np.testing.assert_allclose([h["loss"] for h in t_hist],
                               [h["loss"] for h in r_hist], rtol=1e-5)
    np.testing.assert_allclose([h["grad_norm"] for h in t_hist],
                               [h["grad_norm"] for h in r_hist], rtol=1e-5)
    _close_tree(t_params, r_params, rtol=0, atol=1e-6)
    assert set(t_hist[0]) == set(r_hist[0])
    # and the reference restores the port's step-6 checkpoint
    like = {"params": r_params,
            "opt_state": RS.make_optimizer(
                rreduced(rget("olmo-1b"), **TINY)).init(r_params)}
    step, trees, extras = r_restore(tmp_path / "t", like)
    assert step == 6 and extras["data"] == {"next_index": 6}
    for a, b in zip(jax.tree.leaves(trees["params"]),
                    tree.leaves(t_params)):
        assert np.asarray(a).tobytes() == b.numpy().tobytes()


def test_resume_is_deterministic(tmp_path):
    _, _, full = _port_train(4, tmp_path / "a")
    _, _, first = _port_train(2, tmp_path / "b")
    _, _, second = _port_train(4, tmp_path / "b")
    assert [h["step"] for h in first + second] == [0, 1, 2, 3]
    assert [h["loss"] for h in first + second] == [h["loss"] for h in full]
    assert [h["grad_norm"] for h in second] == [h["grad_norm"]
                                                for h in full[2:]]


def test_sigterm_inside_a_step_forces_the_final_checkpoint(tmp_path,
                                                           monkeypatch,
                                                           capsys):
    real = S.make_train_step

    def make(cfg, optimizer, n_mb=1):
        step = real(cfg, optimizer, n_mb)
        calls = []

        def preempted_step(*a):
            calls.append(1)
            if len(calls) == 2:
                signal.raise_signal(signal.SIGTERM)
            return step(*a)

        return preempted_step

    monkeypatch.setattr(S, "make_train_step", make)
    before = signal.getsignal(signal.SIGTERM)
    _, _, hist = _port_train(10, tmp_path, )
    assert [h["step"] for h in hist] == [0, 1]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_2"]
    assert "preempted at step 1" in capsys.readouterr().out
    assert signal.getsignal(signal.SIGTERM) is before  # handler restored


def test_watchdog_flags_equal_reference():
    dts = [1.0, 1.1, 10.0, 1.0, 0.9, 4.0, 30.0, 1.0, 1.0, 3.5]
    r, t = RTrain.Watchdog(factor=3.0), TTrain.Watchdog(factor=3.0)
    assert ([r.observe(i, dt) for i, dt in enumerate(dts)]
            == [t.observe(i, dt) for i, dt in enumerate(dts)])
    assert r.flagged == t.flagged and t.flagged
    assert t.ewma == pytest.approx(r.ewma, rel=0, abs=0)


def test_history_and_loss_fall_on_the_cpu(capsys):
    _, _, hist = _port_train(6, None)
    assert [h["step"] for h in hist] == list(range(6))
    assert all(np.isfinite(h["loss"]) and h["grad_norm"] > 0 for h in hist)
    assert set(hist[0]) == {"step", "loss", "grad_norm", "time_s",
                            "straggler"}
    assert "[train] step     5" in capsys.readouterr().out


def test_train_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the device rule is about its absence")
    cfg = treduced(tget("olmo-1b"), **TINY)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        TTrain.train(cfg, LOOP_SHAPE, steps=1, ckpt_dir=None)


def test_train_state_fields():
    st = TTrain.TrainState(params={}, opt_state={})
    assert dataclasses.asdict(st) == {"params": {}, "opt_state": {},
                                      "step": 0}
