"""``chip_smoke.py``'s training phases, run on the CPU.

On the card phase 10 trains full-width olmo-1b and hymba-1.5b.  Here the
same phase functions run on the reduced configurations (float32), with the
CUDA calls the phases make stubbed out: every check must hold, and a
planted detached attention output must fail ``train-grad`` (no gradient
reaches the attention weights), as a resume that ignores the iterator's
state must fail ``train``.
"""
import pathlib
import re
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.models import layers, transformer  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture
def cpu_phase(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)


def _olmo():
    return reduced_config(get_config("olmo-1b"))


def test_train_grad_holds(cpu_phase, capsys):
    assert cs.phase_train_grad(_olmo(), "cpu") == 0.0
    out = capsys.readouterr().out
    assert "every attention leaf non-zero" in out
    assert "0 flash_attention launches under grad" in out


def test_detached_attention_fails_train_grad(cpu_phase, monkeypatch):
    real = layers.flash_attention

    def detached(*a, **k):
        return real(*a, **k).detach()

    monkeypatch.setattr(layers, "flash_attention", detached)
    with pytest.raises(AssertionError, match="has no gradient"):
        cs.phase_train_grad(_olmo(), "cpu")


def test_train_loop_holds(cpu_phase, tmp_path, capsys):
    out = cs.phase_train(_olmo(), 32, 4, tmp_path / "ckpt", "cpu")
    assert out["n_mb"] == 1 and out["step_s"] > 0
    assert not (tmp_path / "ckpt").exists()  # cleaned up
    text = capsys.readouterr().out
    assert re.search(r"restored bit-equal to the saved state, iterator at 4",
                     text)
    assert "resumed steps [4, 5]" in text


def test_resume_that_ignores_the_iterator_fails_train(cpu_phase, tmp_path,
                                                      monkeypatch):
    monkeypatch.setattr(synthetic.DataIterator, "load_state_dict",
                        lambda self, state: None)
    with pytest.raises(AssertionError, match="resumed losses"):
        cs.phase_train(_olmo(), 32, 4, tmp_path / "ckpt", "cpu")


def test_compress_q8_and_overfit_hold(cpu_phase, capsys):
    # int8 moments cost 2 + 8 / (last axis) bytes a parameter with their
    # per-channel scales: the 2.1 bound needs rows of at least 80, so the
    # reduced model is widened to d_model 128 here (full width: 2048)
    cfg = reduced_config(get_config("olmo-1b"), d_model=128, head_dim=32,
                         d_ff=256)
    params = transformer.init_lm(cfg, torch.Generator().manual_seed(1),
                                 device="cpu")
    batch = cs._train_batch(cfg, 64, 4, 0, "cpu")
    probe = cs.phase_train_compress(cfg, params, batch, "cpu")
    assert probe.dtype == torch.float32
    moments = cs.phase_train_q8(cfg, params, batch, 2, probe, "cpu")
    n = cfg.param_count()
    assert moments["f32_bytes"] == 8 * n
    assert moments["q8_bytes"] <= cs.TRAIN_Q8_BYTES * n
    losses = cs.phase_train_overfit(cfg, params, batch, 1, "cpu")
    assert losses[0] - losses[-1] >= cs.TRAIN_OVERFIT_DROP
    out = capsys.readouterr().out
    assert "x fewer" in out and "bit-equal on the card and the CPU" in out


def test_train_hybrid_holds(cpu_phase, capsys):
    cfg = reduced_config(get_config("hymba-1.5b"))
    out = cs.phase_train_family(cfg, 64, 2, "cpu")
    assert out["n_mb"] == 1
    assert "every attention and mixer leaf non-zero" in capsys.readouterr().out


def test_phase_training_runs_every_phase(cpu_phase, tmp_path, capsys,
                                         monkeypatch):
    """Phase 10 as ``main`` runs it, on widened reduced models at short
    sequences."""
    monkeypatch.setattr(cs, "TRAIN_SHAPE", (32, 4))
    monkeypatch.setattr(cs, "TRAIN_GRAD_BATCH", (2, 32))
    monkeypatch.setattr(cs, "HYBRID_SHAPE", (64, 2))
    def small(arch):
        return reduced_config(get_config(arch), d_model=128, head_dim=32,
                              d_ff=256)

    ran = []

    def timed(name, fn, *args):
        ran.append(name)
        return fn(*args)

    cs.phase_training(timed, small, transformer, tmp_path / "ckpt", "cpu")
    assert ran == ["train-grad", "train", "train-compress", "train-q8",
                   "train-overfit", "train-hybrid"]
    assert "0 flash_attention launches on the training path" in (
        capsys.readouterr().out)
