"""``chip_smoke.py``'s ``bitserial-ops`` phase, run on the CPU.

On the card the phase runs the §III ops over the 35 MB LLC's 1,032,192
compute bit lines, the dots at Conv2d_2b's and the FC's shapes, and a
full-width batch-1 ``nc_forward(engine="walk")``.  Here the same phase
functions run at 64 rows of K = 288 (18,432 lanes), ``nc_dot`` at 37 rows
of K = 200 and the reduced Inception config, on CPU tensors, with the CUDA
calls the phase makes stubbed out and the kernel wrappers counted where the
card counts launches (the plain versions run on the CPU).  Every check must
hold; a word flipped in the walk's product must fail the ops and the walk
forward.
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
from repro_torch.core import backends, bitserial, cache_geometry  # noqa: E402
from repro_torch.core import nc_layers  # noqa: E402
from repro_torch.kernels import bitserial_matmul as bsm  # noqa: E402
from repro_torch.models import inception  # noqa: E402

torch.set_num_threads(1)

LANES = cs.OPS_K * 64
DOT = (37, 200)


@pytest.fixture
def cpu_phase(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(cs, "FC_DOT", DOT)
    for name in ("bitserial_matmul", "bitserial_matmul_a4"):
        real = getattr(bsm, name)

        def counted(*a, _real=real, **k):
            counted_fns[_real.__name__].launches += 1
            return _real(*a, **k)

        counted.launches = 0
        counted_fns[name] = counted
        monkeypatch.setattr(bsm, name, counted)
    bitserial.SKIP_STATS.reset()
    yield
    bitserial.ZERO_SKIP = True
    bitserial.SKIP_STATS.reset()


counted_fns: dict = {}


@pytest.fixture(scope="module")
def model():
    cfg = inception.REDUCED
    params = inception.init_params(torch.Generator().manual_seed(0),
                                   config=cfg, device="cpu")
    rng = np.random.default_rng(0)
    image = rng.random((cfg.img, cfg.img, 3), dtype=np.float32)
    return cfg, params, image


def _phase(model):
    cfg, params, image = model
    return cs.phase_bitserial_ops(inception, nc_layers, bitserial, backends,
                                  cache_geometry, bsm, params, image, "cpu",
                                  cfg, lanes=LANES)


def _flip_product(monkeypatch):
    """Flip the top product plane of the first word of every multiply."""
    real = bitserial._mul_words

    def flipped(aw, bw):
        prod = real(aw, bw).clone()
        prod.reshape(prod.shape[0], -1)[-1, 0] ^= 1
        return prod

    monkeypatch.setattr(bitserial, "_mul_words", flipped)


def test_phase_holds(cpu_phase, model, capsys):
    dot8, dot4 = _phase(model)
    assert dot8 == 1 and dot4 == 1  # one diagonal block of 37 rows each
    out = capsys.readouterr().out
    assert out.count("7 ops bit-equal") == 4
    m = re.search(r"sparse flat: .* multiply words (\d+)/(\d+) elided, "
                  r"planes (\d+)/(\d+)", out)
    assert int(m.group(1)) > 0 and int(m.group(3)) > 0
    assert "bitserial_dot 64 rows x K 288: equal to x . w" in out
    for name in cs.LAYERS_ON_CPU:
        assert f"{name} on CPU tensors: output, ConvStats" in out
    m = re.search(r"walk multiplier words (\d+), elided (\d+)", out)
    assert int(m.group(1)) > 0
    assert cs.OPS_CYCLES["add"] == 9 and cs.OPS_CYCLES["multiply"] == 102
    assert cs.DOT_CYCLES == bitserial.dot_cycles(cs.OPS_K, 8, 24)
    assert LANES * 56 == cache_geometry.XEON_E5_35MB.compute_slots


def test_flipped_product_word_fails_the_ops(cpu_phase, monkeypatch):
    _flip_product(monkeypatch)
    with pytest.raises(AssertionError, match="values differ from integer"):
        cs.phase_ops_full_width(bitserial, LANES, "cpu")


def test_flipped_product_word_fails_the_walk_forward(cpu_phase, model,
                                                     monkeypatch):
    _flip_product(monkeypatch)
    cfg, params, image = model
    with pytest.raises(AssertionError, match="walk (logits|layer reports) "
                       "differ from gemm's"):
        cs.phase_walk_forward(inception, nc_layers, bitserial, backends, bsm,
                              params, image, "cpu", cfg)
