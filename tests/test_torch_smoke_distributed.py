"""``chip_smoke.py``'s phase 11 (the distributed layer), run on the CPU.

On the card phase 11 runs the sharded train step of full-width olmo-1b and
the sharded prefill and decode of full-width qwen2-7b on a one-rank NCCL
mesh.  Here the same phase functions run the reduced configurations
(float32) on a one-rank gloo mesh, the CUDA calls stubbed out and the
step walls read from fake clocks: every check must hold (on one rank the
sharded steps are bit-equal to the unsharded ones, and ``train(mesh=)``
to phase 10's unsharded ``train()``).  A sharded step timed slower than
its twin by more than the two spreads, ``train(mesh=)`` runs timed slower
than the unsharded ``train()`` runs in turns with them by more than the
two spreads, phase-10 losses off by 1e-3, and a decode step planted off
by one position must each fail; phase 10's own walls, timed minutes
earlier, are printed and not held.  The dry-run wait must fail on a cell whose subprocess exits
non-zero.
"""
import functools
import types
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture
def mesh(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda *a, **k: None)
    m = cs._one_rank_mesh("cpu")
    yield m
    dist.destroy_process_group()


def _olmo():
    return reduced_config(get_config("olmo-1b"))


@functools.lru_cache(maxsize=1)
def _phase10_losses() -> tuple:
    """Phase 10's straight run, unsharded, at the reduced size."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import train as train_mod
    _, _, hist = train_mod.train(_olmo(), ShapeSpec("card", 32, 4, "train"),
                                 steps=cs.TRAIN_RESUMED_STEPS, ckpt_dir=None,
                                 log_every=100, device="cpu")
    return tuple(h["loss"] for h in hist)


@pytest.fixture
def clocks(monkeypatch):
    """Every step wall 0.5 s: ``train()``'s ``perf_counter`` advances 0.5
    s a call (times ``clocks.train_slow`` in a ``train(mesh=)`` run), and
    ``_event_wall`` reports the sharded step's wall (its first operand a
    DTensor) times ``clocks.slow``."""
    from repro_torch.distributed.sharding import is_dtensor
    from repro_torch.launch import train as train_mod
    state = types.SimpleNamespace(slow=1.0, train_slow=1.0, tick=0.5, t=0.0)
    real_train = train_mod.train

    def perf_counter():
        state.t += state.tick
        return state.t

    def train(*args, mesh=None, **kwargs):
        state.tick = 0.5 * (state.train_slow if mesh is not None else 1.0)
        try:
            return real_train(*args, mesh=mesh, **kwargs)
        finally:
            state.tick = 0.5

    def event_wall(fn, *args):
        first = args[0] if not isinstance(args[0], dict) else \
            next(iter(args[0].values()))
        while isinstance(first, dict):
            first = next(iter(first.values()))
        return fn(*args), 0.5 * (state.slow if is_dtensor(first) else 1.0)

    monkeypatch.setattr(train_mod, "time", types.SimpleNamespace(
        perf_counter=perf_counter))
    monkeypatch.setattr(train_mod, "train", train)
    monkeypatch.setattr(cs, "_event_wall", event_wall)
    return state


def _phase10(walls=(0.5,) * 5, scale=1.0):
    return {"losses": [x * scale for x in _phase10_losses()],
            "step_walls": list(walls)}


def test_dist_train_holds(mesh, clocks, capsys):
    out = cs.phase_dist_train(_olmo(), 32, 4, mesh, "cpu", _phase10())
    assert out["wall"] == out["uwall"] == out["train_wall"] == 0.5
    assert out["bound"] > 0
    text = capsys.readouterr().out
    assert "bit-equal True" in text and "bit-equal False" not in text
    assert "bound_time / wall" in text and "the spreads' sum" in text


def test_dist_train_fails_on_walls_that_do_not_meet(mesh, clocks):
    clocks.train_slow = 1.5
    with pytest.raises(AssertionError, match="shares disagree"):
        cs.phase_dist_train(_olmo(), 32, 4, mesh, "cpu", _phase10())


def test_dist_train_prints_phase10_walls_without_holding_them(
        mesh, clocks, capsys):
    out = cs.phase_dist_train(_olmo(), 32, 4, mesh, "cpu",
                              _phase10([1e-9, 2e-9]))
    assert out["share"] == out["ushare"]
    assert "minutes earlier" in capsys.readouterr().out


def test_dist_train_fails_when_slower_than_its_twin(mesh, clocks):
    clocks.slow = 1.5
    with pytest.raises(AssertionError, match="slower than its twin"):
        cs.phase_dist_train(_olmo(), 32, 4, mesh, "cpu", _phase10())


def test_dist_train_fails_on_other_losses(mesh, clocks):
    with pytest.raises(AssertionError, match="phase 10's straight run"):
        cs.phase_dist_train(_olmo(), 32, 4, mesh, "cpu",
                            _phase10(scale=1.001))


def _qwen():
    cfg = reduced_config(get_config("qwen2-7b"))
    params = transformer.init_lm(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 40)]
    return cfg, params, prompts


def test_dist_serve_holds(mesh, monkeypatch, capsys):
    """On the CPU the prefill's attention takes the scan, not the kernel:
    each local (per-shard) attention call without grad stands in for a
    launch, as on the card."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers

    real = layers.flash_attention

    def counted(q, *a, **k):
        if not layers.is_dtensor(q) and not torch.is_grad_enabled():
            fa.flash_attention.launches += 1
        return real(q, *a, **k)

    monkeypatch.setattr(layers, "flash_attention", counted)
    cfg, params, prompts = _qwen()
    launches, worst = cs.phase_dist_serve(cfg, params, prompts, mesh, "cpu")
    assert launches == cfg.n_layers * len(prompts) and worst == 0.0
    text = capsys.readouterr().out
    assert "bit-equal True" in text and "bound_time / wall" in text


def test_dist_serve_fails_on_a_shifted_decode(mesh, monkeypatch):
    from repro_torch.models import transformer as T
    cfg, params, prompts = _qwen()
    real = T.decode_step

    def shifted(cfg_, params_, tokens, caches, pos):
        if cfg_.act_spec is not None:  # the sharded step's
            pos = pos + 1
        return real(cfg_, params_, tokens, caches, pos)

    monkeypatch.setattr(T, "decode_step", shifted)
    with pytest.raises(AssertionError, match="decode logits"):
        cs.phase_dist_serve(cfg, params, prompts[:1], mesh, "cpu")


def test_finish_dryruns_fails_on_a_failed_cell(tmp_path):
    p = subprocess.Popen([sys.executable, "-c", "raise SystemExit(3)"],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    with pytest.raises(AssertionError, match="exit 3"):
        cs._finish_dryruns([(("olmo-1b", "train_4k"), p)], tmp_path,
                           cs.time.perf_counter())
