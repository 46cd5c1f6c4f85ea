"""Heads that do not divide the ``model`` axis, on a real mesh.

qwen2-7b's 28 query heads and 4 KV heads over the 16-wide ``model`` axis
of the production meshes split a projection's output off the head
boundaries, which DTensor cannot view into heads (``multipod_dryrun``
found it).  ``layers._split_heads`` gathers such a split before the view
and ``layers._merge_heads`` splits the merged output again where the
output projection splits its rows; ``transformer._gold_logits`` picks the
label's logit from vocab-split logits as a masked sum.  Here a reduced
qwen2-7b with 3 query heads over 1 KV head (16 each, d_model 48) runs on
a 4-rank gloo world's (2, 2) mesh, in float32: the sharded train step's
loss and updated parameters and the sharded prefill's logits must match
the unsharded steps within 1e-5, and the masked-sum gold logits of a
vocab-split DTensor must equal ``take_along_dim`` of the whole logits.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5

_WORKER = textwrap.dedent("""
    import dataclasses, json, os, sys
    import torch
    import torch.multiprocessing as mp

    def work(rank, out):
        torch.set_num_threads(1)
        from torch.distributed.tensor import Replicate, Shard, distribute_tensor
        from repro_torch import tree
        from repro_torch.configs import get_config, reduced_config
        from repro_torch.configs.base import ShapeSpec
        from repro_torch.launch import steps as S
        from repro_torch.launch.mesh import gloo_world, make_local_mesh
        from repro_torch.models import transformer as T
        cfg = reduced_config(get_config("qwen2-7b"), d_model=48, n_heads=3,
                             n_kv_heads=1, head_dim=16)
        g = torch.Generator().manual_seed(0)
        params = T.init_lm(cfg, g, device="cpu")
        tok = torch.randint(0, cfg.vocab_size, (4, 32), generator=g,
                            dtype=torch.int32)
        lab = torch.randint(0, cfg.vocab_size, (4, 32), generator=g,
                            dtype=torch.int32)
        res = {}
        with gloo_world(rank, 4, os.path.join(out, "store")):
            mesh = make_local_mesh(2, 2, device="cpu")
            shape = ShapeSpec("t", 32, 4, "train")
            batch = {"tokens": tok, "labels": lab}
            b = S.build_sharded_step(cfg, shape, mesh, params=params,
                                     batch=batch)
            p2, _, m2 = b.step(*b.example_args)
            ucfg = dataclasses.replace(b.cfg, act_spec=None)
            opt = S.make_optimizer(ucfg)
            p1, _, m1 = S.make_train_step(
                ucfg, opt, S.default_microbatches(cfg, shape, mesh))(
                    params, opt.init(params), batch)
            res["loss"] = abs(float(m2["loss"].full_tensor())
                              - float(m1["loss"]))
            res["params"] = max(
                float((x.full_tensor() - y).abs().max())
                for x, y in zip(tree.leaves(p2), tree.leaves(p1)))
            b = S.build_sharded_step(cfg, ShapeSpec("p", 32, 2, "prefill"),
                                     mesh, params=params,
                                     batch={"tokens": tok[:2]})
            with torch.no_grad():
                l2 = b.step(*b.example_args)[0].full_tensor()
                l1 = T.prefill(cfg, params, tok[:2])[0]
            res["prefill"] = float((l2 - l1).abs().max())
            logits = torch.randn(4, 8, cfg.vocab_size, generator=g)
            idx = torch.randint(0, cfg.vocab_size, (4, 8), generator=g)
            split = distribute_tensor(logits, mesh, [Shard(0), Shard(2)])
            rows = distribute_tensor(idx, mesh, [Shard(0), Replicate()])
            gold = T._gold_logits(split, rows).full_tensor()
            want = torch.take_along_dim(logits, idx[..., None], dim=-1)[..., 0]
            res["gold_equal"] = bool(torch.equal(gold, want))
        if rank == 0:
            with open(os.path.join(out, "res.json"), "w") as f:
                json.dump(res, f)

    if __name__ == "__main__":
        mp.spawn(work, args=(sys.argv[1],), nprocs=4)
""")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("heads")
    script = out / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, str(script), str(out)], env=env,
                       capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr[-4000:]
    return json.loads((out / "res.json").read_text())


@pytest.mark.parametrize("what", ["loss", "params", "prefill"])
def test_non_dividing_heads_match_unsharded(results, what):
    assert results[what] <= TOL, results


def test_masked_sum_gold_logits_equal_take_along_dim(results):
    assert results["gold_equal"] is True
