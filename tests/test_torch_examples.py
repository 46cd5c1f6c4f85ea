"""The port's example entry points (``repro_torch.examples``) against the
reference's ``examples/``, on the CPU.

* ``quickstart``: the §III lines and the simulator's lines equal the
  reference example's text (9 and 102 cycles, 4.72 ms, 18.3x, 7.7x); the
  GEMMs' relative errors on the reference's ``jax.random`` operands within
  1e-6 of the same computation through the reference's kernels (the
  errors are means of float32 products summed in another order).
* ``serve_quantized --neural-cache``: the reference's reduced Inception
  with its own weights (``params_from_jax``) under
  ``seed=7,filter=0.1,compute=0.05``, compressed, with a warmup re-plan:
  both engines on the fake clock of ``test_torch_serve_slo.py`` (wall time
  decides admission), so the printed lines (histogram, SLO and
  calibration, residency, fault ledger) equal the reference example's but
  the emulation wall, and every served request's logits are byte-equal.
* the LM demo: the W8/W4 dequantized trees bit-equal to the reference's
  ``dequantize_tree``, and the fp32, W8 and W4 runs' greedy tokens equal
  to the reference ``ServingEngine``'s on the same prompts.
* ``train_lm``: the example's config against the reference's (the same
  76.1 M parameters); at 2 layers x d64 the example trains
  300 steps on the CPU (the production schedule warms up over 200 steps,
  so fewer steps leave the loss flat), its losses finite and falling, its
  checkpoints written.  The loop itself is held by ``test_torch_train.py``.
* ``multipod_dryrun`` on a reduced cell (a (2, 2) mesh of a fake world):
  the record printed as JSON, the roofline lines, the H100's 80 GiB, and
  no "16GB".
* ``paper_repro``: its lines are held by ``test_torch_paper.py``.
* each module's CLI at these sizes exits 0 with ``--device cpu``, and
  ``--device cuda`` raises without a GPU.
"""
import dataclasses
import importlib.util
import json
import math
import os
import pathlib
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget
from repro.configs import reduced_config as rreduced
from repro.kernels import ops as rops
from repro.core import quantize as rq
from repro.launch import serve as rserve
from repro.models import inception as ri
from repro.models import transformer as RT
from repro.quant import quantize_lm_params as rquantize
from repro_torch import tree
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduced_config as treduced
from repro_torch.configs.base import ShapeSpec
from repro_torch.examples import multipod_dryrun as tdry
from repro_torch.examples import paper_repro as tpaper
from repro_torch.examples import quickstart as tquick
from repro_torch.examples import serve_quantized as tserveq
from repro_torch.examples import train_lm as ttrain
from repro_torch.launch import serve as tserve
from repro_torch.models import inception as ti
from repro_torch.models import transformer as TT
from repro_torch.quant import quantize_lm_params as tquantize
from test_torch_serve_slo import _fake_time

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FAULTS = "seed=7,filter=0.1,compute=0.05"


def _reference_example(name: str):
    """A module of the reference's ``examples/`` folder, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------
def test_quickstart_arithmetic_and_simulator_equal_reference(capsys):
    ref = _reference_example("quickstart")
    ref.demo_bitserial()
    ref.demo_simulator()
    want = capsys.readouterr().out
    bits = tquick.demo_bitserial("cpu")
    sim = tquick.demo_simulator()
    assert capsys.readouterr().out == want
    assert bits["add_exact"] and bits["mul_exact"]
    assert (bits["add_cycles"], bits["mul_cycles"]) == (9, 102)
    assert bits["reduce"] == bits["reduce_want"]
    assert (f"{sim['ms']:.2f}", f"{sim['vs_cpu']:.1f}",
            f"{sim['vs_gpu']:.1f}") == ("4.72", "18.3", "7.7")


def _reference_gemm_errors(x, w) -> dict:
    """examples/quickstart.py's demo_tpu_kernels, returning the errors."""
    import jax.numpy as jnp

    def err(y):
        return float(jnp.abs(y - x @ w).mean() / jnp.abs(x @ w).mean())

    qp = rq.choose_qparams_symmetric(jnp.max(jnp.abs(x)))
    xq = rq.quantize(x, qp)
    wq, wscale = rq.quantize_per_channel(w)
    out = {"w8a8": err(rops.quant_matmul(xq, wq, qp.scale,
                                         wscale.reshape(-1)))}
    for bits in tquick.GEMM_BITS:
        wqb, wsb = rq.quantize_per_channel(w, bits=bits)
        planes = rops.pack_weights(wqb.astype(jnp.int32), bits)
        out[f"bitserial{bits}"] = err(rops.bitserial_matmul(
            xq, planes, qp.scale, wsb.reshape(-1), n_bits=bits))
    return out


def test_quickstart_gemm_errors_equal_reference():
    k1, k2 = jax.random.split(jax.random.key(7))
    x = jax.random.normal(k1, (128, 256))
    w = jax.random.normal(k2, (256, 128)) * 0.2
    want = _reference_gemm_errors(x, w)
    got = tquick.demo_kernels(torch.from_numpy(np.asarray(x)),
                              torch.from_numpy(np.asarray(w)))
    assert got.keys() == want.keys()
    for key in want:
        assert abs(got[key] - want[key]) <= 1e-6, (key, got[key], want[key])
    assert got["w8a8"] < got["bitserial4"] < got["bitserial2"]


# ---------------------------------------------------------------------------
# serve_quantized --neural-cache
# ---------------------------------------------------------------------------
def _pinned_clock(monkeypatch, module, cls, clock, engines, key):
    """``module.NCServingEngine`` made with the fake clock's ``now_fn``."""
    def make(*args, **kw):
        engines[key] = cls(*args, now_fn=lambda: clock["t"], **kw)
        return engines[key]
    monkeypatch.setattr(module, "NCServingEngine", make)


def test_neural_cache_demo_equals_reference(monkeypatch, capsys):
    ref = _reference_example("serve_quantized")
    monkeypatch.setenv("NC_BACKEND", "jit")
    clock, engines = {"t": 0.0}, {}
    monkeypatch.setattr(rserve, "time", _fake_time(clock))
    monkeypatch.setattr(tserve, "time", _fake_time(clock))
    _pinned_clock(monkeypatch, ref, rserve.NCServingEngine, clock, engines,
                  "ref")
    _pinned_clock(monkeypatch, tserveq, tserve.NCServingEngine, clock,
                  engines, "port")
    kw = dict(fault_profile=FAULTS, compressed=True, warmup_replan=True)
    ref.main_neural_cache(5000.0, 6, **kw)
    want = capsys.readouterr().out
    rc = ri.reduced_config(**tserveq.NC_CONFIG)
    cfg = tserveq.nc_config()
    params = ti.params_from_jax(ri.init_params(jax.random.key(0), config=rc),
                                device="cpu")
    got = tserveq.main_neural_cache(params, cfg, tserveq.nc_images(cfg, 6),
                                    5000.0, device="cpu", **kw)
    out = capsys.readouterr().out

    def masked(text):
        return re.sub(r"in \d+\.\d+s emulated", "in <wall> emulated", text)

    assert masked(out) == masked(want)
    assert "faults (seed 7)" in out and "0 failed" in out
    assert got["faults"]["detected"] == got["faults"]["corrupt_attempts"] > 0
    assert got["stats"]["batch_histogram"] == engines["ref"].stats()[
        "batch_histogram"]
    r_done = {r.rid: r for r in engines["ref"].completed}
    assert sorted(r.rid for r in got["done"]) == sorted(r_done) == list(
        range(6))
    for r in got["done"]:
        assert (np.asarray(r_done[r.rid].logits).view(np.uint32)
                == r.logits.numpy().view(np.uint32)).all()


# ---------------------------------------------------------------------------
# serve_quantized, the LM
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def lm():
    rcfg = rreduced(rget("qwen2-7b"), n_layers=4, d_model=128, d_ff=256,
                    vocab_size=512, head_dim=32)
    tcfg = tserveq.lm_config()
    rparams = RT.init_lm(rcfg, jax.random.key(0))
    tparams = TT.params_from_jax(jax.tree.map(np.asarray, rparams),
                                 device="cpu")
    return rcfg, tcfg, rparams, tparams


def test_lm_config_and_prompts_are_the_reference_example_s(lm):
    rcfg, tcfg, _, _ = lm
    assert dataclasses.asdict(tcfg).keys() == dataclasses.asdict(rcfg).keys()
    for k, v in dataclasses.asdict(rcfg).items():
        if k != "jdtype":
            assert dataclasses.asdict(tcfg)[k] == v, k
    assert tcfg.dtype == "float32" and tcfg.hd == 32
    rng = np.random.default_rng(1)
    want = [rng.integers(2, rcfg.vocab_size, 24).astype(np.int32)
            for _ in range(8)]
    assert all((a == b).all() for a, b in zip(tserveq.lm_prompts(tcfg), want))


@pytest.mark.parametrize("bits", [8, 4])
def test_dequantized_trees_bit_equal_reference(lm, bits):
    ref = _reference_example("serve_quantized")
    _, _, rparams, tparams = lm
    want = jax.tree.leaves(ref.dequantize_tree(rquantize(rparams, bits=bits)))
    got = tree.leaves(tserveq.dequantize_tree(tquantize(tparams, bits=bits)))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        assert (a.numpy().view(np.uint32) == b.view(np.uint32)).all()


def test_lm_demo_tokens_equal_reference_engine(lm, capsys):
    ref = _reference_example("serve_quantized")
    rcfg, tcfg, rparams, tparams = lm
    prompts = tserveq.lm_prompts(tcfg)
    runs = tserveq.main_lm(tcfg, tparams, prompts, device="cpu")
    out = capsys.readouterr().out
    trees = {"fp32": rparams}
    for bits in (8, 4):
        trees[f"w{bits}"] = ref.dequantize_tree(rquantize(rparams, bits=bits))
    for tag, p in trees.items():
        eng = rserve.ServingEngine(rcfg, p, max_batch=4, max_len=128)
        for i, pr in enumerate(prompts):
            eng.submit(rserve.Request(rid=i, prompt=pr, max_tokens=8))
        want = {r.rid: r.out for r in eng.run()}
        assert runs[tag]["out"] == want, tag
        assert runs[tag]["steps"] == eng.steps
        assert runs[tag]["tokens"] == 64
    for bits in (8, 4):
        agree = np.mean([runs[f"w{bits}"]["out"][i] == runs["fp32"]["out"][i]
                         for i in range(8)])
        assert runs[f"w{bits}"]["agreement"] == agree
        assert f"greedy agreement with fp32: {agree * 100:.0f}%" in out
    assert out.startswith("[serve] fp32 baseline vs weight-quantized")
    assert out.rstrip().endswith("[serve] OK")


# ---------------------------------------------------------------------------
# train_lm
# ---------------------------------------------------------------------------
def test_train_lm_config_is_the_reference_example_s():
    cfg = ttrain.example_config()
    want = dataclasses.replace(rget("olmo-1b"), **ttrain.EXAMPLE_CONFIG)
    assert cfg.param_count() == want.param_count()
    # 76.1 M with olmo's tied embeddings (the reference's comment says
    # "~110M", which would count an untied head)
    assert cfg.param_count() == 76_087_296
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_ff,
            cfg.vocab_size, cfg.dtype, cfg.remat) == (
        12, 512, 8, 2048, 50304, "float32", "none")
    assert cfg.family == tget("olmo-1b").family


def test_train_lm_reduced_run(tmp_path, capsys):
    cfg = ttrain.example_config(**ttrain.REDUCED)
    res = ttrain.run(cfg, steps=300, batch=4, seq=32, ckpt_dir=str(tmp_path),
                     log_every=100, device="cpu")
    losses = res["losses"]
    assert len(losses) == 300 and all(math.isfinite(v) for v in losses)
    assert res["k"] == 30 and res["last"] < res["first"] - 0.5
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_100", "step_200", "step_300"]
    out = capsys.readouterr().out
    assert "[example] training 0M-param dense LM for 300 steps" in out
    assert f"first-30 avg {res['first']:.3f}" in out and "[example] OK" in out


# ---------------------------------------------------------------------------
# multipod_dryrun
# ---------------------------------------------------------------------------
def test_multipod_dryrun_reduced_cell(capsys):
    cfg = treduced(tget("qwen2-7b"))
    rec = tdry.dryrun_cell("qwen2-7b", "train_4k", cfg=cfg,
                           spec=ShapeSpec("train_4k", 64, 4, "train"),
                           mesh_shape=(2, 2))
    out = capsys.readouterr().out
    body, tail = out.split("\n\n[", 1)
    assert json.loads(body) == json.loads(json.dumps(rec))
    lines = ("[" + tail).splitlines()
    assert lines[0] == "[qwen2-7b x train_4k @ 2x2]"
    assert lines[1] == (f"  peak {rec['peak_bytes_per_device'] / 1e9:.2f} "
                        f"GB/device, fits 80 GiB HBM (H100): True")
    rl = rec["roofline"]
    assert lines[2].endswith(f"-> {rl['dominant']}-bound")
    assert rec["fits_hbm"] is True and rec["chips"] == 4
    assert "16GB" not in out and "16 GB" not in out


# ---------------------------------------------------------------------------
# the command lines
# ---------------------------------------------------------------------------
CLI = {
    "quickstart": [],
    "serve_quantized": [],
    "serve_quantized-nc": ["--neural-cache", "--requests", "3",
                           "--fault-profile", FAULTS, "--compressed",
                           "--warmup-replan"],
    "train_lm": ["--reduced", "--batch", "4", "--seq", "32"],
    "multipod_dryrun": ["olmo-1b", "train_4k", "--reduced"],
    "paper_repro": [],
}


@pytest.mark.parametrize("name", sorted(CLI))
def test_cli_runs_on_the_cpu(name, tmp_path):
    args = list(CLI[name])
    if name == "train_lm":
        args += ["--ckpt-dir", str(tmp_path / "ckpt")]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", f"repro_torch.examples.{name.split('-')[0]}",
         "--device", "cpu", *args], env=env, cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert r.stdout.strip()


@pytest.mark.parametrize("module", [tquick, tserveq, ttrain, tdry, tpaper],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_cuda_without_gpu_raises(module):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        module.main(["--device", "cuda"] + (
            ["--reduced"] if module in (ttrain, tdry) else []))
