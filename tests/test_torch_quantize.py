"""The port's quantization scalars against the JAX reference, bit for bit.

``choose_qparams`` and ``fixed_point_multiplier`` run in float32 with
round-half-even in both packages; scales must be the same float32 value,
zero points, mantissas and shifts the same integers (tolerance: none).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantize as rq
from repro.models import inception as ri
from repro_torch.core import quantize as tq
from repro_torch.models import inception as ti

torch.set_num_threads(1)


def _same_qp(a, b):
    assert np.float32(a.scale) == np.float32(b.scale)
    assert np.float32(b.scale) == b.scale  # the port holds a float32 value
    assert int(a.zero_point) == b.zero_point
    assert (a.bits, a.signed) == (b.bits, b.signed)


def _same_multiplier(real):
    # the reference's int64 cast saturates an exact 2^31 mantissa only in
    # JAX's default 32-bit mode, which is how it runs (other test modules
    # switch x64 on process-wide, so the mode is set here explicitly)
    with jax.enable_x64(False):
        m_r, s_r = rq.fixed_point_multiplier(jnp.float32(real))
    m_t, s_t = tq.fixed_point_multiplier(real)
    assert (int(m_r), int(s_r)) == (m_t, s_t), real


@pytest.mark.parametrize("cfg_name", ["reduced", "full"])
def test_choose_qparams_every_layer_weight_range(cfg_name):
    """Every conv/fc layer's weight range (seeded He-normal weights) gives
    the same qparams, for the reduced and the FULL specs."""
    cfg = ri.REDUCED if cfg_name == "reduced" else ri.FULL
    rng = np.random.default_rng(0)
    for name, r, s, c, m in ri._iter_convs(cfg):
        w = (rng.standard_normal(r * s * c * 8).astype(np.float32)
             * np.float32((2.0 / (r * s * c)) ** 0.5))
        lo, hi = np.float32(w.min()), np.float32(w.max())
        _same_qp(rq.choose_qparams(jnp.float32(lo), jnp.float32(hi)),
                 tq.choose_qparams(float(lo), float(hi)))


@pytest.mark.parametrize("bits,signed", [(8, False), (8, True), (4, False),
                                         (2, False), (1, False)])
def test_choose_qparams_edge_ranges(bits, signed):
    rng = np.random.default_rng(bits + signed)
    ranges = [(0.0, 0.0), (0.0, 1.0), (-1.0, 0.0), (-3.5, 7.25), (1.0, 2.0),
              (-2.0, -1.0), (1e-30, 1e-29)]
    ranges += [tuple(sorted(rng.standard_normal(2) * 10)) for _ in range(20)]
    for lo, hi in ranges:
        _same_qp(rq.choose_qparams(jnp.float32(lo), jnp.float32(hi),
                                   bits=bits, signed=signed),
                 tq.choose_qparams(lo, hi, bits=bits, signed=signed))


def test_fixed_point_multiplier_powers_of_two_and_neighbours():
    """ceil(log2(x)) flips only where log2 returns an exact integer, so
    powers of two and their +-1 ulp float32 neighbours are the cases where
    XLA's and torch's log2 could disagree."""
    for e in range(-40, 1):
        p = np.float32(2.0 ** e)
        for x in (np.nextafter(p, np.float32(0)), p,
                  np.nextafter(p, np.float32(np.inf))):
            _same_multiplier(float(x))


def test_fixed_point_multiplier_random():
    rng = np.random.default_rng(3)
    for x in rng.random(500) ** 3:
        _same_multiplier(float(np.float32(x)))


def test_fixed_point_multiplier_tiny_forward_multipliers():
    """The multipliers a tiny forward requantizes with (the reference's own
    run records them through fixed_point_multiplier)."""
    seen = []
    orig = rq.fixed_point_multiplier

    def spy(real, bits=31):
        seen.append(float(real))
        return orig(real, bits)

    cfg = ri.reduced_config(img=47, width_div=8, classes=8, stages=("a",))
    params = ri.init_params(jax.random.key(0), config=cfg)
    x = np.random.default_rng(0).random((1, cfg.img, cfg.img, 3),
                                        dtype=np.float32)
    rq.fixed_point_multiplier = spy
    try:
        ri.nc_forward(params, x, config=cfg, engine="jit")
    finally:
        rq.fixed_point_multiplier = orig
    assert len(seen) > 10  # conv epilogues and branch concats
    for real in seen:
        _same_multiplier(real)


def test_requantize_fixedpoint_and_requant_image():
    rng = np.random.default_rng(4)
    acc = rng.integers(-(1 << 20), 1 << 24, size=(3, 5, 7))
    for real in (0.5, 0.013, 0.0001234, 0.9999):
        with jax.enable_x64(False):
            m_r, s_r = rq.fixed_point_multiplier(jnp.float32(real))
        m_t, s_t = tq.fixed_point_multiplier(real)
        for zp in (0, 17):
            want = np.asarray(ri._requant_image(acc, real, zp))
            got = ti._requant_image(torch.from_numpy(acc), real, zp)
            assert (want == got.numpy()).all()
            # the generic integer requant agrees with the host int64 path
            ref64 = np.clip(((acc * int(m_r) + (1 << (int(s_r) - 1)))
                             >> int(s_r)) + zp, 0, 255)
            got2 = tq.requantize_fixedpoint(torch.from_numpy(acc), m_t, s_t,
                                            zero_point=zp)
            assert (ref64 == got2.numpy()).all()
