"""Elastic restart across packages and meshes.

* A checkpoint the reference saves on one device (float32 and bfloat16
  leaves) restores in the port onto a (2, 2) mesh of 4 gloo ranks with
  ``restore_checkpoint(..., shardings=)``: every leaf's shards lie where
  the spec puts them and the gathered leaf equals the saved one.
* The restore copies one shard a rank from host memory: on a fake
  (2, 2) world each leaf's local tensor is the rank's slice of the saved
  leaf and owns no more storage than that slice, and every copy made is of
  one shard.
* The port saves a tree of DTensors from that mesh (``AsyncCheckpointer``:
  every rank joins the gather, rank 0 writes), and the reference restores
  it onto a (2, 2) mesh of 4 host devices with its own ``shardings=``.
"""
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import torch

from repro.checkpoint import save_checkpoint as r_save

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PORT = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.multiprocessing as mp

    def work(rank, ck, ck2):
        torch.set_num_threads(1)
        from repro_torch.checkpoint import AsyncCheckpointer, restore_checkpoint
        from repro_torch.distributed.sharding import NamedSharding
        from repro_torch.launch.mesh import gloo_world, make_local_mesh
        with gloo_world(rank, 4, ck2 + ".store"):
            mesh = make_local_mesh(2, 2, device="cpu")
            like = {"w": torch.zeros(8, 8), "b": torch.zeros(8),
                    "h": torch.zeros(4, 8, dtype=torch.bfloat16)}
            sh = {"params": {"w": NamedSharding(mesh, ("data", "model")),
                             "b": NamedSharding(mesh, ("model",)),
                             "h": NamedSharding(mesh, (None, "data"))}}
            step, out, extras = restore_checkpoint(
                ck, {"params": like}, device="cpu", shardings=sh)
            assert step == 7 and extras["data"]["next_index"] == 3
            p = out["params"]
            assert tuple(p["w"].to_local().shape) == (4, 4)
            assert tuple(p["b"].to_local().shape) == (4,)
            assert tuple(p["h"].to_local().shape) == (4, 4)
            assert p["h"].dtype == torch.bfloat16
            for t in p.values():  # each rank holds its shard, not the leaf
                lt = t.to_local()
                assert (lt.untyped_storage().nbytes()
                        == lt.numel() * lt.element_size())
            assert torch.equal(p["w"].full_tensor(),
                               torch.arange(64.0).reshape(8, 8))
            assert torch.equal(p["b"].full_tensor(), torch.ones(8))
            assert torch.equal(p["h"].full_tensor(),
                               (torch.arange(32.0) / 8).reshape(4, 8).to(
                                   torch.bfloat16))
            ckpt = AsyncCheckpointer(ck2)
            ckpt.save(9, {"params": {"w": p["w"] * 2, "b": p["b"]}},
                      extras={"data": {"next_index": 5}})
            ckpt.wait()

    if __name__ == "__main__":
        mp.spawn(work, args=tuple(sys.argv[1:3]), nprocs=4)
""")

_REF_RESTORE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.checkpoint import restore_checkpoint
    from repro.launch.mesh import make_mesh_compat
    mesh = make_mesh_compat((2, 2), ("data", "model"))
    like = {"w": jnp.zeros((8, 8)), "b": jnp.zeros((8,))}
    sh = {"params": {"w": NamedSharding(mesh, P("model", "data")),
                     "b": NamedSharding(mesh, P("data"))}}
    step, out, extras = restore_checkpoint(sys.argv[1], {"params": like},
                                           shardings=sh)
    assert step == 9 and extras["data"]["next_index"] == 5
    w = out["params"]["w"]
    assert len(w.sharding.device_set) == 4, w.sharding
    np.testing.assert_array_equal(np.asarray(w),
                                  2 * np.arange(64.0).reshape(8, 8))
    np.testing.assert_array_equal(np.asarray(out["params"]["b"]), np.ones(8))
    print("RESTORED_ELASTIC")
""")


def test_checkpoints_reshard_across_packages_and_meshes(tmp_path):
    ck, ck2 = str(tmp_path / "ref"), str(tmp_path / "port")
    params = {"w": jnp.arange(64.0).reshape(8, 8), "b": jnp.ones((8,)),
              "h": (jnp.arange(32.0) / 8).reshape(4, 8).astype(jnp.bfloat16)}
    r_save(ck, 7, {"params": params}, extras={"data": {"next_index": 3}})
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    script = tmp_path / "worker.py"
    script.write_text(_PORT)
    r = subprocess.run([sys.executable, str(script), ck, ck2], env=env,
                       capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr[-4000:]
    assert sorted(os.listdir(ck2)) == ["step_9"]
    r = subprocess.run([sys.executable, "-c", _REF_RESTORE, ck2], env=env,
                       capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert "RESTORED_ELASTIC" in r.stdout, r.stdout + r.stderr[-4000:]


def test_restore_copies_only_the_rank_shard(tmp_path):
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.distributed.sharding import NamedSharding
    from repro_torch.launch.mesh import fake_world, named_mesh

    full = {"w": torch.arange(64.0).reshape(8, 8),
            "b": torch.arange(8.0),
            "h": (torch.arange(32.0) / 8).reshape(4, 8).to(torch.bfloat16)}
    save_checkpoint(tmp_path, 3, {"params": full})
    copies = []

    class Copies(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten._to_copy.default:
                copies.append(args[0].numel())
            return func(*args, **(kwargs or {}))

    with fake_world(4):  # this process is rank 0: data 0, model 0
        mesh = named_mesh("cpu", (2, 2), ("data", "model"))
        sh = {"w": NamedSharding(mesh, ("data", "model")),
              "b": NamedSharding(mesh, ("data",)),
              "h": NamedSharding(mesh, (None, "model"))}
        like = {k: torch.zeros_like(v) for k, v in full.items()}
        with Copies():
            _, out, _ = restore_checkpoint(tmp_path, {"params": like},
                                           device="cpu",
                                           shardings={"params": sh})
        p = out["params"]
        want = {"w": full["w"][:4, :4], "b": full["b"][:4],
                "h": full["h"][:, :4]}
        for k, t in p.items():
            lt = t.to_local()
            assert tuple(t.shape) == tuple(full[k].shape)
            assert lt.dtype == full[k].dtype
            assert torch.equal(lt, want[k]), k
            assert lt.untyped_storage().nbytes() == want[k].numel() \
                * want[k].element_size(), k
    assert sorted(copies) == sorted(v.numel() for v in want.values())
