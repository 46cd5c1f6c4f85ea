"""``chip_smoke.py``'s ``paper`` phase (phase 13), run on the CPU.

On the card the phase prints the ``paper_repro`` example and holds its
headline rows, prints ``lm_neural_cache``'s rows, runs ``sched_breakdown``
with its two inputs measured on the card, and serves phase 4's images
through a three-socket real fleet at full width.  Here the same phase
functions run on CPU tensors with the reduced stem config standing in for
full width, the CUDA calls stubbed out and the bit-serial kernel's wrapper
counted where the card counts launches (the plain versions run on the
CPU).  Every check must hold; the headline rows must be the reference's
lines; a headline row planted off, a GEMM wrong alike in every forward
(which the fleet and phase 4, dense and sparse, serial and overlapped
would each agree on), a served logit row shifted in the fleet and a
launch count off the fleet's batches must each fail.
"""
import importlib.util
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.benchmarks import lm_neural_cache  # noqa: E402
from repro_torch.benchmarks import sched_breakdown  # noqa: E402
from repro_torch.benchmarks import tab4_cache_scaling  # noqa: E402
from repro_torch.benchmarks import traffic_replay  # noqa: E402
from repro_torch.configs import REGISTRY  # noqa: E402
from repro_torch.examples import paper_repro  # noqa: E402
from repro_torch.kernels import bitserial_matmul as bsm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import inception  # noqa: E402

torch.set_num_threads(1)

DEV = torch.device("cpu")
CFG = inception.reduced_config(img=47, width_div=8, classes=8, stages=())


def _counted(monkeypatch, change=None):
    real = bsm.bitserial_matmul

    def counted(*a, **k):
        counted.launches += 1
        out = real(*a, **k)
        if change is not None:
            change(out)
        return out

    counted.launches = 0
    monkeypatch.setattr(bsm, "bitserial_matmul", counted)


@pytest.fixture
def cpu_phase(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda *a, **k: None)
    _counted(monkeypatch)


def _served(params, images):
    """What phase 4 hands phase 13: each image's served logits."""
    engine = serve.NCServingEngine(params, CFG, max_batch=2, device=DEV)
    for i, img in enumerate(images):
        engine.submit(serve.NCRequest(rid=i, image=img))
    return {r.rid: r.logits for r in engine.run()}


def _inputs():
    params = cs._inception_params(inception, CFG, DEV)
    rng = np.random.default_rng(0)
    images = [rng.random((CFG.img, CFG.img, 3), dtype=np.float32)
              for _ in range(4)]
    return params, images


def test_headlines_are_the_reference_example_s():
    """The rows the card holds are the reference example's own lines."""
    spec = importlib.util.spec_from_file_location(
        "reference_example_paper_repro", ROOT / "examples" / "paper_repro.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    lines = []
    for title, mod in ref.MODULES:
        lines += ["", f"=== {title} ==="] + [f"  {r}" for r in mod.run()]
    assert len(lines) == cs.PAPER_LINES
    assert all(h in lines for h in cs.PAPER_HEADLINES)


def test_paper_phase(cpu_phase):
    params, images = _inputs()
    served = _served(params, images)
    walls = []

    def timed(name, fn, *args):
        walls.append(name)
        return fn(*args)

    launches = cs.phase_paper(timed, inception, serve, ops, bsm, "cpu card",
                              images, served, DEV, CFG)
    assert walls == ["paper-repro", "lm-nc", "sched", "replay"]
    assert launches > 0


def test_paper_repro_phase_fails_on_a_headline_off(monkeypatch):
    real = tab4_cache_scaling.run
    monkeypatch.setattr(tab4_cache_scaling, "run", lambda: [
        r.replace("4.20 ms", "4.21 ms") for r in real()])
    with pytest.raises(AssertionError, match="headline rows off"):
        cs.phase_paper_repro(paper_repro, DEV)


def test_lm_nc_phase_holds_one_row_per_arch():
    rows = cs.phase_lm_nc(lm_neural_cache, REGISTRY)
    assert len(rows) == len(REGISTRY)
    with pytest.raises(AssertionError, match="lm_nc rows"):
        cs.phase_lm_nc(lm_neural_cache, dict(REGISTRY, extra=None))


def test_sched_step_fails_on_a_gemm_fault(cpu_phase, monkeypatch):
    """A kernel wrong alike in every measuring forward: dense agrees with
    sparse and serial with overlapped, so only the plain versions' forwards
    can catch it."""
    def wrong(out):
        out[:, 0] += 1 << 12

    _counted(monkeypatch, wrong)
    with pytest.raises(AssertionError, match="forward's logits differ from "
                                             "the plain versions' forward"):
        cs.phase_sched(sched_breakdown, ops, bsm, "cpu card", DEV)


def test_replay_step_fails_on_launches_off_the_batches(cpu_phase,
                                                       monkeypatch):
    """Launches the fleet's batches do not account for must fail."""
    params, images = _inputs()
    served = _served(params, images)
    _counted(monkeypatch, lambda out: setattr(
        bsm.bitserial_matmul, "launches", bsm.bitserial_matmul.launches + 1))
    with pytest.raises(AssertionError, match="replay: fleet launches"):
        cs.phase_replay(traffic_replay, serve, inception, ops, bsm, params,
                        images, served, DEV, CFG)


def test_replay_step_fails_on_a_gemm_fault(cpu_phase, monkeypatch):
    """A kernel wrong alike in phase 4 and the fleet: the fleet agrees with
    phase 4, so only the plain versions' forward can catch it."""
    params, images = _inputs()

    def wrong(out):
        out[:, 0] += 1 << 12  # every row alike: batched and alone agree

    _counted(monkeypatch, wrong)
    served = _served(params, images)
    with pytest.raises(AssertionError, match="differ from the plain "
                                             "versions' forward"):
        cs.phase_replay(traffic_replay, serve, inception, ops, bsm, params,
                        images, served, DEV, CFG)


def test_replay_step_fails_on_a_shifted_served_row(cpu_phase, monkeypatch):
    params, images = _inputs()
    served = _served(params, images)
    served[2] = torch.roll(served[2], 1)
    with pytest.raises(RuntimeError, match="real-fleet: request 2 logits "
                                           "differ"):
        cs.phase_replay(traffic_replay, serve, inception, ops, bsm, params,
                        images, served, DEV, CFG)
