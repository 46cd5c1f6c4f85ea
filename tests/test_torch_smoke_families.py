"""``chip_smoke.py``'s SSM, hybrid and int8-KV-cache phases, run on the CPU.

On the card ``phase_lm_serve`` serves full-width mamba2-2.7b and hymba-1.5b
(the latter with a fifth prompt that decodes across its ring's wrap) and
``phase_kv8`` serves qwen2-7b and hymba-1.5b again from the int8 KV cache.
Here the same phases run on the reduced configurations (float32, hymba's
window 32, so its wrap prompt has 28 tokens and the 70-token prompt
prefills the ring rolled): every check of the phases must hold (with
hymba's float32 batch-size check), the flash entry point must be reached
by the full-attention layers only, and faults planted in the int8 cache's
prefill write and in the per-row ring mask must fail the checks.  The CUDA timing calls the phases make are stubbed
out; attention on the CPU is the reference's scan, counted here where the
card counts kernel launches.
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
from repro_torch.models import layers, transformer  # noqa: E402

torch.set_num_threads(1)


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

    def counted(q, k, v, *, window=0, **kw):
        if window == 0:  # the calls the card sends to the kernel
            fa.flash_attention.launches += 1
        return real(q, k, v, window=window, **kw)

    monkeypatch.setattr(layers, "flash_attention", counted)
    monkeypatch.setattr(fa.flash_attention, "launches", 0, raising=False)


_MODELS: dict = {}


def _model(arch):
    if arch not in _MODELS:
        cfg = reduced_config(get_config(arch))
        params = transformer.init_lm(cfg, torch.Generator().manual_seed(0),
                                     device="cpu")
        rng = np.random.default_rng(0)
        lengths = (5, 9, 70, 7) + ((cfg.attn_window - cs.LM_WRAP_MARGIN,)
                                   if cfg.attn_window else ())
        prompts = [rng.integers(2, cfg.vocab_size, n).astype(np.int32)
                   for n in lengths]
        _MODELS[arch] = cfg, params, prompts
    return _MODELS[arch]


def _serve(cfg, params, prompts, record=None):
    return cs.phase_lm_serve(transformer, serve, ops, fa, cfg, params,
                             prompts, "cpu", record)


@pytest.mark.parametrize("arch,full_layers", [("mamba2-2.7b", 0),
                                              ("hymba-1.5b", 1)])
def test_served_family_holds(arch, full_layers, cpu_phase, capsys):
    cfg, params, prompts = _model(arch)
    record = {}
    launches, _, _ = _serve(cfg, params, prompts, record)
    assert cs._full_attention_layers(transformer, cfg) == full_layers
    assert launches == full_layers * len(prompts)
    out = capsys.readouterr().out
    assert f"{len(prompts)} requests" in out
    diff = float(re.search(r"decode logit difference ([0-9.e+-]+)",
                           out).group(1))
    assert diff < 1e-4  # float32: batch 4 and batch 1 differ in order only
    shaped = out.count("bit-equal to a loop at the served batch shape")
    assert shaped == (len(prompts) if arch in cs.LM_SERVED_SHAPE_LOOP else 0)
    if cfg.attn_window:  # the global layer's cache and the ring
        assert [(c["attn"]["k"][0], c["attn"]["k"][3])
                for c in record["cache_shapes"]] == [(1, cs.LM_MAX_LEN),
                                                     (1, cfg.attn_window)]


@pytest.mark.parametrize("arch", ["qwen2-7b", "hymba-1.5b"])
def test_kv8_phase_holds(arch, cpu_phase, capsys):
    cfg, params, prompts = _model(arch)
    base = {}
    _serve(cfg, params, prompts, base)
    launches, _ = cs.phase_kv8(transformer, layers, serve, ops, fa, cfg,
                               params, prompts, base, "cpu")
    assert launches == cs._full_attention_layers(transformer, cfg) * len(
        prompts)
    out = capsys.readouterr().out
    line = re.search(r"\[lm-kv8\].*", out).group(0)
    assert "prefill logits bit-equal" in line
    rel = float(re.search(r"by ([0-9.]+) of its largest", line).group(1))
    assert rel < 0.08  # the reference's own bound at this size


def test_kv8_phase_catches_a_bad_prefill_write(cpu_phase, monkeypatch):
    """A prefill that writes one slot's int8 keys off by one fails the
    payload check."""
    cfg, params, prompts = _model("qwen2-7b")
    base = {}
    _serve(cfg, params, prompts, base)
    real = layers.kv_quantize

    def skewed(x):
        q, s = real(x)
        if x.ndim == 4 and x.shape[2] > 1:  # a prefill's keys or values
            q = q.clone()
            q[..., 1, 0] = torch.clamp(q[..., 1, 0].to(torch.int16) + 1,
                                       -127, 127).to(torch.int8)
        return q, s

    monkeypatch.setattr(layers, "kv_quantize", skewed)
    with pytest.raises(AssertionError, match="not kv_quantize"):
        cs.phase_kv8(transformer, layers, serve, ops, fa, cfg, params,
                     prompts, base, "cpu")


def _fmod_ring_mask(real):
    """``_ring_mask`` whose per-row branch takes ``fmod`` for the floor
    modulo."""
    def mask(ring_slot, ring_len, S):
        ring_slot = torch.as_tensor(ring_slot)
        if ring_slot.ndim == 0:
            return real(ring_slot, ring_len, S)
        kpos = torch.arange(S)
        age = torch.fmod(ring_slot[:, None] - kpos[None, :], S)
        return (age < torch.as_tensor(ring_len)[:, None])[:, None, None,
                                                          None, :]
    return mask


@pytest.mark.parametrize("fault", [False, True])
def test_float32_batch_check(fault, cpu_phase, monkeypatch, capsys):
    """The float32 batch-1 against batch-4 check holds on the reduced
    hymba, and fails with the ``fmod`` per-row ring mask."""
    cfg, params, prompts = _model("hymba-1.5b")
    if not fault:
        worst = cs._float32_batch_check(transformer, serve, cfg, params,
                                        prompts, "cpu")
        assert worst < 1e-4
        assert "in float32: request 0's decode" in capsys.readouterr().out
        return
    monkeypatch.setattr(layers, "_ring_mask",
                        _fmod_ring_mask(layers._ring_mask))
    with pytest.raises(AssertionError, match="batch-4 decode differs"):
        cs._float32_batch_check(transformer, serve, cfg, params, prompts,
                                "cpu")


def test_per_row_ring_mask_with_fmod_fails(cpu_phase, monkeypatch):
    """The served decode (per-row positions) is held against a loop at the
    served batch shape (scalar positions): a per-row ring mask computed
    with ``fmod`` in place of the floor modulo counts slots ahead of the
    newest as young, attends to them, and fails that check."""
    cfg, params, prompts = _model("hymba-1.5b")
    monkeypatch.setattr(layers, "_ring_mask",
                        _fmod_ring_mask(layers._ring_mask))
    with pytest.raises(AssertionError, match="served batch shape"):
        _serve(cfg, params, prompts)
