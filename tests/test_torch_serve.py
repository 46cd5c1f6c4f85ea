"""The port's NCServingEngine against the reference engine on a fake clock:
equal steps, admitted-batch histogram, SLO decisions and per-request logits
(byte-identical, and equal to a standalone port ``nc_forward``)."""
import jax
import numpy as np
import pytest
import torch

from repro.launch import serve as rserve
from repro.models import inception as ri
from repro_torch.kernels import bitserial_matmul as tk
from repro_torch.launch import serve as tserve
from repro_torch.models import inception as ti

torch.set_num_threads(1)

KW = dict(img=31, width_div=8, classes=8, stages=())


@pytest.fixture(scope="module")
def tiny():
    rc, tc = ri.reduced_config(**KW), ti.reduced_config(**KW)
    params = ri.init_params(jax.random.key(1), config=rc)
    images = [np.random.default_rng(i).random((rc.img, rc.img, 3),
                                              dtype=np.float32)
              for i in range(5)]
    return rc, tc, params, ti.params_from_jax(params, device="cpu"), images


def _drive(engine, images, request_cls):
    for i, img in enumerate(images):
        engine.submit(request_cls(rid=i, image=img), now=0.1 * i)
    done = engine.run()
    return sorted(done, key=lambda r: r.rid)


@pytest.mark.parametrize("slo_ms", [None, 1e9])
def test_engine_matches_reference(tiny, slo_ms):
    rc, tc, rparams, tparams, images = tiny
    clock = {"t": 1.0}
    ref = rserve.NCServingEngine(rparams, rc, max_batch=2, engine="jit",
                                 slo_ms=slo_ms, now_fn=lambda: clock["t"])
    port = tserve.NCServingEngine(tparams, tc, max_batch=2, slo_ms=slo_ms,
                                  now_fn=lambda: clock["t"], device="cpu")
    r_done = _drive(ref, images, rserve.NCRequest)
    t_done = _drive(port, images, tserve.NCRequest)
    assert ref.steps == port.steps
    assert ref.batch_histogram == port.batch_histogram
    assert [d.admit for d in ref.decisions] == [d.admit for d in port.decisions]
    assert [r.rid for r in r_done] == [r.rid for r in t_done]
    for r, t in zip(r_done, t_done):
        assert (np.asarray(r.logits).view(np.uint32)
                == t.logits.numpy().view(np.uint32)).all()
        assert (r.degraded, t.degraded) == (None, None)
        alone, _ = ti.nc_forward(tparams, images[t.rid], config=tc,
                                 device="cpu")
        assert torch.equal(alone.view(torch.int32), t.logits.view(torch.int32))
    r_stats, t_stats = ref.stats(), port.stats()
    for key in ("steps", "completed", "batch_histogram", "slo_hits",
                "slo_misses", "stream_batch_limit", "failed", "retries",
                "degraded_batches", "residency_credit_bytes"):
        assert r_stats[key] == t_stats[key], key
    assert port.batch_cap == ref.batch_cap


def test_recovery_ladder_float_rung(tiny):
    """A forward that always raises walks the ladder down to the float
    forward (rung 3), as the reference does."""
    rc, tc, _, tparams, images = tiny
    port = tserve.NCServingEngine(tparams, tc, max_batch=2, device="cpu")

    def broken(x, schedule):
        raise RuntimeError("injected")

    port._forward = broken
    port.submit(tserve.NCRequest(rid=0, image=images[0]))
    port.run()
    (req,) = port.completed
    assert req.degraded == "float" and port.degraded_batches == 1
    assert req.logits.shape == (tc.classes,)
    assert port.retries == 1


@pytest.mark.parametrize("first_ok", [False, True])
def test_kernel_error_is_not_served_degraded(tiny, first_ok):
    """A kernel that fails to build or launch raises out of ``step`` at any
    rung of the ladder; it is never answered from the float forward."""
    rc, tc, _, tparams, images = tiny
    port = tserve.NCServingEngine(tparams, tc, max_batch=2, device="cpu")
    calls = []

    def broken(x, schedule):
        calls.append(schedule)
        if first_ok and len(calls) == 1:
            raise RuntimeError("transient")  # the ladder's retry then fails
        raise tk.KernelError("bitserial_gemm launch failed: cudaError_t 209")

    port._forward = broken
    port.submit(tserve.NCRequest(rid=0, image=images[0]))
    with pytest.raises(tk.KernelError, match="cudaError_t 209"):
        port.run()
    assert len(calls) == (2 if first_ok else 1)
    assert not port.completed and port.degraded_batches == 0


def test_warmup_replan_keeps_logits(tiny):
    rc, tc, _, tparams, images = tiny
    port = tserve.NCServingEngine(tparams, tc, max_batch=2,
                                  warmup_replan=True, device="cpu")
    done = _drive(port, images[:4], tserve.NCRequest)
    assert port.warmup_replans == 1
    for r in done:
        alone, _ = ti.nc_forward(tparams, images[r.rid], config=tc,
                                 device="cpu")
        assert torch.equal(alone, r.logits)


def test_engine_device_and_unported_flags(tiny):
    rc, tc, _, tparams, _ = tiny
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            tserve.NCServingEngine(tparams, tc)
    with pytest.raises(NotImplementedError):
        tserve.NCServingEngine(tparams, tc, integrity=True, device="cpu")
    with pytest.raises(NotImplementedError):
        tserve.NCServingEngine(tparams, tc, compressed=True, device="cpu")
    with pytest.raises(ValueError, match="gemm, walk"):
        tserve.NCServingEngine(tparams, tc, engine="host", device="cpu")
    port = tserve.NCServingEngine(tparams, tc, device="cpu")
    port.latency_model.observe(2, 1.0)
    port.set_engine("walk")  # a new body drops the calibration
    assert port.engine == "walk" and port.latency_model.samples == 0


def test_cli_serves_on_cpu(capsys):
    assert tserve.main(["--neural-cache", "--device", "cpu", "--requests",
                        "1", "--max-batch", "1"]) == 0
    assert "logits finite: True" in capsys.readouterr().out
