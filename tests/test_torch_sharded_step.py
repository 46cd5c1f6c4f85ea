"""The port's sharded steps against the unsharded ones and the reference's
``build_jitted_step``.

* ``default_microbatches(cfg, shape, mesh)`` equals the reference's for
  every arch x shape on both production mesh shapes.
* For a reduced dense (qwen2-7b: one KV head, so the decode cache shards
  its length), MoE (moonshot) and hybrid (hymba) config, in float32, the
  train, prefill and decode steps built by ``build_sharded_step`` on a
  4-rank gloo world's (2, 2) mesh match the port's unsharded steps and
  the reference's ``build_jitted_step`` on a (2, 2) mesh of 4 host devices
  (a subprocess) within 1e-5, from the reference's weights: losses and
  updated parameters for train, last-position logits for prefill, logits
  for decode (from the reference's prefill caches).
* ``quantized_matmul`` (weight-only and W8A8) of rows split over both
  axes of that mesh runs on each rank's rows and equals the unsharded
  product.
* ``VARIANTS`` equals the reference's, and every variant builds its
  train, prefill and decode steps on a fake (2, 2) world.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as RREG
from repro.configs import get_config as rget
from repro.configs import shapes_for as rshapes
from repro.launch import steps as RS
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduced_config as treduced
from repro_torch.configs import shapes_for as tshapes
from repro_torch.configs.base import ShapeSpec
from repro_torch.distributed.sharding import AbstractMesh
from repro_torch.launch import steps as S

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("qwen2-7b", "moonshot-v1-16b-a3b", "hymba-1.5b")
TOL = 1e-5


class FakeMesh:
    def __init__(self, shape, axes):
        self.axis_names = axes
        self.devices = np.empty(shape)


@pytest.mark.parametrize("arch", sorted(RREG))
def test_default_microbatches_equal_reference(arch):
    for shape, axes in (((16, 16), ("data", "model")),
                        ((2, 16, 16), ("pod", "data", "model"))):
        for rs, ts in zip(rshapes(rget(arch)), tshapes(tget(arch))):
            for b in (ts.global_batch, 4, 1):
                rsh = RS.ShapeSpec(rs.name, rs.seq_len, b, rs.kind)
                tsh = ShapeSpec(ts.name, ts.seq_len, b, ts.kind)
                assert (S.default_microbatches(tget(arch), tsh,
                                               AbstractMesh(shape, axes))
                        == RS.default_microbatches(rget(arch), rsh,
                                                   FakeMesh(shape, axes)))


def test_variants_equal_reference():
    assert S.VARIANTS == RS.VARIANTS


@pytest.mark.parametrize("variant", S.VARIANTS)
def test_variant_builds_on_fake_world(variant):
    from repro_torch.launch.mesh import fake_world, named_mesh

    cfg = treduced(tget("moonshot-v1-16b-a3b"))
    with fake_world(4):
        mesh = named_mesh("cuda", (2, 2), ("data", "model"))
        for kind, b in (("train", 4), ("prefill", 2), ("decode", 2)):
            bundle = S.build_sharded_step(cfg, ShapeSpec("v", 64, b, kind),
                                          mesh, variant=variant)
            assert bundle.kind == kind and callable(bundle.step)
            assert bundle.cfg.act_spec[3] is mesh


# ---------------------------------------------------------------------------
# the sharded steps, run
# ---------------------------------------------------------------------------
_REF = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config, reduced_config
    from repro.configs.base import ShapeSpec
    from repro.launch import steps as S
    from repro.launch.mesh import make_mesh_compat, set_mesh_compat
    from repro.models import transformer as T
    out = sys.argv[1]
    mesh = make_mesh_compat((2, 2), ("data", "model"))
    for arch in sys.argv[2:]:
        cfg = reduced_config(get_config(arch))
        params = T.init_lm(cfg, jax.random.key(0))
        rng = np.random.default_rng(0)
        tok = rng.integers(0, cfg.vocab_size, (4, 33)).astype(np.int32)
        lab = rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
        res = {"params": jax.tree.leaves(params), "tok": tok, "lab": lab}
        opt_state = S.make_optimizer(cfg).init(params)
        _, caches = T.prefill(cfg, params, tok[:2, :32], max_len=33)
        with set_mesh_compat(mesh):
            b = S.build_jitted_step(cfg, ShapeSpec("t", 32, 4, "train"),
                                    mesh, donate=False)
            p2, _, m = b.step(params, opt_state,
                              {"tokens": tok[:, :32], "labels": lab})
            res["loss"] = [m["loss"]]
            res["new_params"] = jax.tree.leaves(p2)
            b = S.build_jitted_step(cfg, ShapeSpec("p", 32, 2, "prefill"),
                                    mesh)
            res["prefill"] = [b.step(params, {"tokens": tok[:2, :32]})[0]]
            b = S.build_jitted_step(cfg, ShapeSpec("d", 33, 2, "decode"),
                                    mesh, donate=False)
            res["decode"] = [b.step(params, caches,
                                    {"tokens": tok[:2, 32:],
                                     "pos": jnp.int32(32)})[0]]
            res["caches"] = jax.tree.leaves(caches)
        flat = {}
        for k, v in res.items():
            if k in ("tok", "lab"):
                flat[k] = v
            else:
                for i, x in enumerate(v):
                    flat[f"{k}/{i}"] = np.asarray(x)
        np.savez(os.path.join(out, arch + ".npz"), **flat)
    print("REF_OK")
""")

_PORT = textwrap.dedent("""
    import dataclasses, json, os, sys
    import numpy as np
    import torch
    import torch.multiprocessing as mp

    def leaves(z, key):
        n = len([k for k in z.files if k.startswith(key + "/")])
        return [torch.from_numpy(z[f"{key}/{i}"]) for i in range(n)]

    def maxerr(a, b):
        return max((float((x - y).abs().max()) for x, y in zip(a, b)),
                   default=0.0)

    def work(rank, out, archs):
        torch.set_num_threads(1)
        from repro_torch import tree
        from repro_torch.configs import get_config, reduced_config
        from repro_torch.configs.base import ShapeSpec
        from repro_torch.launch import steps as S
        from repro_torch.launch.mesh import gloo_world, make_local_mesh
        from repro_torch.models import transformer as T
        res = {}
        with gloo_world(rank, 4, os.path.join(out, "store")):
            mesh = make_local_mesh(2, 2, device="cpu")
            for arch in archs:
                cfg = reduced_config(get_config(arch))
                z = np.load(os.path.join(out, arch + ".npz"))
                _, pdef = tree.flatten(S.abstract_params(cfg))
                params = tree.unflatten(pdef, leaves(z, "params"))
                tok = torch.from_numpy(z["tok"])
                lab = torch.from_numpy(z["lab"])
                r = {}
                # train
                shape = ShapeSpec("t", 32, 4, "train")
                batch = {"tokens": tok[:, :32], "labels": lab}
                b = S.build_sharded_step(cfg, shape, mesh, params=params,
                                         batch=batch)
                p2, _, m2 = b.step(*b.example_args)
                got = [x.full_tensor() for x in tree.leaves(p2)]
                ucfg = dataclasses.replace(b.cfg, act_spec=None)
                opt = S.make_optimizer(ucfg)
                p1, _, m1 = S.make_train_step(
                    ucfg, opt, S.default_microbatches(cfg, shape, mesh))(
                        params, opt.init(params), batch)
                loss = float(m2["loss"].full_tensor())
                r["train"] = {
                    "loss_vs_unsharded": abs(loss - float(m1["loss"])),
                    "loss_vs_ref": abs(loss - float(z["loss/0"])),
                    "params_vs_unsharded": maxerr(got, tree.leaves(p1)),
                    "params_vs_ref": maxerr(got, leaves(z, "new_params"))}
                # prefill
                b = S.build_sharded_step(cfg, ShapeSpec("p", 32, 2,
                                                        "prefill"), mesh,
                                         params=params,
                                         batch={"tokens": tok[:2, :32]})
                with torch.no_grad():
                    l2 = b.step(*b.example_args)[0].full_tensor()
                    l1 = T.prefill(cfg, params, tok[:2, :32])[0]
                r["prefill"] = {
                    "vs_unsharded": float((l2 - l1).abs().max()),
                    "vs_ref": float((l2 - torch.from_numpy(
                        z["prefill/0"])).abs().max())}
                # decode, from the reference's prefill caches
                dshape = ShapeSpec("d", 33, 2, "decode")
                _, cdef = tree.flatten(S.abstract_caches(cfg, dshape))
                caches = tree.unflatten(cdef, leaves(z, "caches"))
                with torch.no_grad():
                    b = S.build_sharded_step(
                        cfg, dshape, mesh, params=params,
                        batch={"tokens": tok[:2, 32:]}, caches=caches,
                        pos=32)
                    l2 = b.step(*b.example_args)[0].full_tensor()
                    l1 = T.decode_step(cfg, params, tok[:2, 32:],
                                       tree.map(torch.clone, caches), 32)[0]
                r["decode"] = {
                    "vs_unsharded": float((l2 - l1).abs().max()),
                    "vs_ref": float((l2 - torch.from_numpy(
                        z["decode/0"])).abs().max())}
                res[arch] = r
            # the PTQ linear on rows split over both mesh axes
            from torch.distributed.tensor import Shard, distribute_tensor
            from repro_torch.core.quantize import (choose_qparams,
                                                   quantize_per_channel)
            from repro_torch.quant import ptq
            g = torch.Generator().manual_seed(0)
            x = torch.randn(8, 64, generator=g)
            q, sc = quantize_per_channel(torch.randn(64, 32, generator=g),
                                         axis=-1, bits=8)
            wq = {"q": q, "scale": sc.reshape(-1).float()}
            xs = distribute_tensor(x, mesh, [Shard(0), Shard(0)])
            res["ptq"] = {}
            for name, qp in (("weight_only", None),
                             ("w8a8", choose_qparams(x.min(), x.max()))):
                got = ptq.quantized_matmul(xs, wq, qp)
                res["ptq"][name] = [
                    float((got.full_tensor()
                           - ptq.quantized_matmul(x, wq, qp)).abs().max()),
                    list(got.to_local().shape)]
        if rank == 0:
            with open(os.path.join(out, "port.json"), "w") as f:
                json.dump(res, f)

    if __name__ == "__main__":
        mp.spawn(work, args=(sys.argv[1], sys.argv[2:]), nprocs=4)
""")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REF, str(out), *ARCHS],
                       env=env, capture_output=True, text=True, timeout=120,
                       cwd=ROOT)
    assert "REF_OK" in r.stdout, r.stdout + r.stderr[-4000:]
    script = out / "port_worker.py"
    script.write_text(_PORT)
    r = subprocess.run([sys.executable, str(script), str(out), *ARCHS],
                       env=env, capture_output=True, text=True, timeout=120,
                       cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr[-4000:]
    return json.loads((out / "port.json").read_text())


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_unsharded_and_reference(results, arch, kind):
    errs = results[arch][kind]
    assert errs and all(e <= TOL for e in errs.values()), errs


@pytest.mark.parametrize("mode", ["weight_only", "w8a8"])
def test_sharded_quantized_matmul_runs_on_local_rows(results, mode):
    """``quantized_matmul`` of rows split 4 ways runs on each rank's 2 rows
    (``local_map``) and equals the unsharded product."""
    err, local_shape = results["ptq"][mode]
    assert local_shape == [2, 32] and err <= TOL
