"""``chip_smoke.py``'s ``examples`` phase (phase 12), run on the CPU.

On the card the phase runs the four examples of ``repro_torch.examples``
at the reference examples' sizes.  Here the same phase functions run on
CPU tensors: the quickstart, both serving demos and the LM demo at their
own (already reduced) sizes, ``train_lm`` at 2 layers x d64 (batch 4 x 32,
300 steps, as the card's schedule) and the dry-run example's command line
in a host subprocess on a reduced cell of a fake 4-rank world.  The CUDA calls are stubbed out and the kernel wrappers
counted where the card counts launches (the plain versions run on the
CPU).  Every check must hold; a GEMM result planted off the plain
version's (in the quickstart and in the Neural Cache serving), a served
attention output planted off the plain version's, a served LM token
planted off the batch-1 loop's and a dry run that exits non-zero must
each fail.
"""
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.core import backends  # noqa: E402
from repro_torch.examples import quickstart  # noqa: E402
from repro_torch.examples import serve_quantized, train_lm  # noqa: E402
from repro_torch.kernels import bitserial_matmul as bsm  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quant_matmul as qm  # noqa: E402
from repro_torch.models import inception, layers, transformer  # noqa: E402

torch.set_num_threads(1)

DEV = torch.device("cpu")


def _counted(monkeypatch, module, name):
    real = getattr(module, name)

    def counted(*a, **k):
        counted.launches += 1
        return real(*a, **k)

    counted.launches = 0
    monkeypatch.setattr(module, name, counted)
    return counted


@pytest.fixture
def cpu_phase(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda *a, **k: None)
    _counted(monkeypatch, bsm, "bitserial_matmul")
    _counted(monkeypatch, qm, "quant_matmul")
    real = layers.flash_attention

    def flash(q, k, v, *, window=0, **kw):
        # the calls the card sends to the kernel: full prefills, no grad
        grad = torch.is_grad_enabled() and q.requires_grad
        if window == 0 and not grad:
            fa.flash_attention.launches += 1
        return real(q, k, v, window=window, **kw)

    monkeypatch.setattr(layers, "flash_attention", flash)
    monkeypatch.setattr(fa.flash_attention, "launches", 0, raising=False)


def test_quickstart_phase(cpu_phase):
    launches = cs.phase_ex_quickstart(quickstart, bsm, qm, DEV)
    assert launches == {"bitserial_matmul": 3, "quant_matmul": 1}


def test_quickstart_phase_fails_on_a_kernel_off_its_plain_version(
        cpu_phase, monkeypatch):
    real = bsm.bitserial_matmul

    def planted(*a, **k):
        planted.launches += 1
        out = real(*a, **k)
        out[0, 0] += 1.0
        return out

    planted.launches = 0
    monkeypatch.setattr(bsm, "bitserial_matmul", planted)
    with pytest.raises(AssertionError, match="differ from the plain"):
        cs.phase_ex_quickstart(quickstart, bsm, qm, DEV)


def test_serve_nc_phase(cpu_phase):
    res = cs.phase_ex_serve_nc(serve_quantized, inception, backends, ops,
                               bsm, DEV)
    assert res["bitserial_matmul"] > 0 and res["wall_s"] > 0


def test_serve_nc_phase_fails_on_a_kernel_off_its_plain_version(
        cpu_phase, monkeypatch):
    """A kernel wrong in the same way in the served run and the standalone
    forwards agrees with itself; the plain versions' forward must catch
    it.  The fault profile is off here: under it the checksums of the
    checked path see such a kernel too (and re-run every pass)."""
    monkeypatch.setattr(cs, "EX_FAULTS", None)
    real = bsm.bitserial_matmul

    def planted(*a, **k):
        planted.launches += 1
        out = real(*a, **k)
        out[:, 0] += 1 << 12  # every row alike: batched and alone agree
        return out

    planted.launches = 0
    monkeypatch.setattr(bsm, "bitserial_matmul", planted)
    with pytest.raises(AssertionError, match="differ from the plain"):
        cs.phase_ex_serve_nc(serve_quantized, inception, backends, ops, bsm,
                             DEV)


def test_serve_lm_phase(cpu_phase):
    res = cs.phase_ex_serve_lm(serve_quantized, transformer, layers, fa, DEV)
    assert res["flash_attention"] == 4 * 8 * 3
    assert set(res["tok_s"]) == {"fp32", "w8", "w4"}
    assert res["worst"] <= cs.FA_F32_TOL


def test_serve_lm_phase_fails_on_an_attention_call_off_the_plain_version(
        cpu_phase, monkeypatch):
    real = layers.flash_attention
    calls = []

    def planted(q, k, v, **kw):
        out = real(q, k, v, **kw)
        calls.append(None)
        if len(calls) == 10:
            out = out.clone()
            out[0, 0, -1, 0] += 1e-3
        return out

    monkeypatch.setattr(layers, "flash_attention", planted)
    with pytest.raises(AssertionError,
                       match="flash_attention != plain at served prefill "
                             "call 9"):
        cs.phase_ex_serve_lm(serve_quantized, transformer, layers, fa, DEV)


def test_serve_lm_phase_fails_on_a_token_off_the_loop(cpu_phase,
                                                      monkeypatch):
    real = serve_quantized.serve_lm

    def planted(cfg, params, prompts, tag, device=None):
        run = real(cfg, params, prompts, tag, device)
        if tag == "fp32":
            out = run["out"][3]
            out[5] = (out[5] + 1) % cfg.vocab_size
        return run

    monkeypatch.setattr(serve_quantized, "serve_lm", planted)
    with pytest.raises(AssertionError, match="request 3 token 5"):
        cs.phase_ex_serve_lm(serve_quantized, transformer, layers, fa, DEV)


def test_train_phase(cpu_phase, tmp_path):
    cfg = train_lm.example_config(**train_lm.REDUCED)
    res = cs.phase_ex_train(train_lm, fa, cfg, cs.EX_TRAIN_STEPS, 4, 32,
                            tmp_path / "ckpt", DEV)
    assert res["last"] < res["first"] and res["tok_s"] > 0
    assert not (tmp_path / "ckpt").exists()


def test_dryrun_phase(tmp_path):
    """The example's command line in a host subprocess at the reduced
    cell, waited for and read as phase 12 reads the full one."""
    t0 = cs.time.perf_counter()
    host = cs._start_dryruns(tmp_path, cells=(),
                             example=["olmo-1b", "train_4k", "--reduced"])
    try:
        rec = cs.phase_ex_dryrun(host, tmp_path, t0)
    finally:
        cs._stop(host)
    assert rec["fits_hbm"] is True and rec["chips"] == 4


def test_dryrun_phase_fails_on_a_failed_example(tmp_path):
    t0 = cs.time.perf_counter()
    host = cs._start_dryruns(tmp_path, cells=(), example=["no-such-arch"])
    with pytest.raises(AssertionError, match="multipod_dryrun: exit"):
        cs.phase_ex_dryrun(host, tmp_path, t0)
