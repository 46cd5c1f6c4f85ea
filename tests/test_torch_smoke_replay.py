"""``chip_smoke.py``'s MoE routing replay, run on the CPU.

On the card the served (batch-4) decode of an MoE model is held against a
batch-1 ``decode_step`` loop that replays the served expert choices and
capacity drops (``chip_smoke._RouteReplay``).  Here the same phase runs
on reduced ``arctic-480b`` and ``moonshot-v1-16b-a3b`` (float32, capacity
factor 1.0, so the 4 decoding tokens overflow experts and choices drop):
the replay must hold the served decode within the smoke's bound, a replay
that ignores the drops must not, and row shifts planted in the served
``_topk`` and ``_router`` must fail the routing checks.  The CUDA timing
calls the phase makes are stubbed out; attention on the CPU is the
reference's scan, counted here where the card counts kernel launches.
"""
import pathlib
import re
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers, moe, transformer  # noqa: E402

torch.set_num_threads(1)

ARCHS = {"arctic-480b": dict(capacity_factor=1.0),
         "moonshot-v1-16b-a3b": dict(n_experts=8, top_k=3,
                                     capacity_factor=1.0)}


class _Event:
    def __init__(self, **kw):
        pass

    def record(self):
        pass

    def elapsed_time(self, other):
        return 0.0


@pytest.fixture
def cpu_phase(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    real = layers.flash_attention

    def counted(*a, **k):
        fa.flash_attention.launches += 1
        return real(*a, **k)

    monkeypatch.setattr(layers, "flash_attention", counted)
    monkeypatch.setattr(fa.flash_attention, "launches", 0, raising=False)


def _model(arch):
    cfg = reduced_config(get_config(arch), **ARCHS[arch])
    params = transformer.init_lm(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 9, 70, 7)]
    return cfg, params, prompts


def _serve(cfg, params, prompts):
    return cs.phase_lm_serve(transformer, serve, ops, fa, cfg, params,
                             prompts, "cpu")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_replay_holds_served_decode_with_drops(arch, cpu_phase, capsys):
    cfg, params, prompts = _model(arch)
    launches, _, _ = _serve(cfg, params, prompts)
    assert launches == cfg.n_layers * len(prompts)
    out = capsys.readouterr().out
    drops = int(re.search(r"(\d+) served choices dropped", out).group(1))
    assert drops > 0
    diff = float(re.search(r"decode logit difference ([0-9.e+-]+)",
                           out).group(1))
    assert diff < 1e-4  # float32: the replay leaves only summation order


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_replay_ignoring_drops_fails(arch, cpu_phase, monkeypatch):
    cfg, params, prompts = _model(arch)
    settle = cs._RouteReplay._settle_step

    def keep_all(self, rows, calls):
        settle(self, rows, calls)
        for _, rid in rows:
            self.served[rid][-1] = [(p, idx, torch.ones_like(keep))
                                    for p, idx, keep in self.served[rid][-1]]

    monkeypatch.setattr(cs._RouteReplay, "_settle_step", keep_all)
    with pytest.raises(AssertionError, match="router logits differ|served "
                       "decode logits differ"):
        _serve(cfg, params, prompts)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_planted_routing_faults_fail(arch, cpu_phase, capsys):
    cfg, params, prompts = _model(arch)
    cs._planted_routing_faults(transformer, serve, ops, fa, moe, cfg, params,
                               prompts, "cpu")
    out = capsys.readouterr().out
    assert "served _topk fails the routing check" in out
    assert "served _router fails the routing check" in out
    assert moe._topk.__name__ == "_topk" and moe._router.__name__ == "_router"
