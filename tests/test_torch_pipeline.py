"""The port's GPipe schedule against the unpipelined stack and the
reference's ``gpipe_apply``.

On 4 gloo ranks (a subprocess; 4 stages, 8 layers, 6 microbatches of 2)
``gpipe_apply`` is bit-equal to the port's unpipelined layer loop on every
rank, from full staged parameters and from DTensors sharded over the
``stage`` axis, and within 1e-6 of the reference's ``gpipe_apply`` on 4
host devices (a second subprocess).  ``bubble_fraction`` and
``split_stages`` equal the reference's.
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.pipeline import bubble_fraction as r_bubble
from repro.distributed.pipeline import split_stages as r_split
from repro_torch import tree
from repro_torch.distributed.pipeline import bubble_fraction, split_stages

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, L, M, MB, D = 4, 8, 6, 2, 16


def test_bubble_fraction_equals_reference():
    for s in range(1, 9):
        for m in range(1, 17):
            assert bubble_fraction(s, m) == r_bubble(s, m)


def test_split_stages_equals_reference():
    rng = np.random.default_rng(0)
    params = {"W": rng.standard_normal((L, D, D)).astype(np.float32),
              "b": {"x": rng.standard_normal((L, 3)).astype(np.float32)}}
    want = r_split(jax.tree.map(jnp.asarray, params), S)
    got = split_stages(tree.map(torch.from_numpy, params), S)
    for g, w in zip(tree.leaves(got), jax.tree.leaves(want)):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(AssertionError):
        split_stages({"W": torch.zeros(6, 2)}, 4)


_REF = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.distributed.pipeline import gpipe_apply, split_stages
    from repro.launch.mesh import make_mesh_compat
    z = np.load(sys.argv[1])
    Ws, x = jnp.asarray(z["Ws"]), jnp.asarray(z["x"])
    mesh = make_mesh_compat((4,), ("stage",))

    def layer_scan(W_stack, h):
        def body(c, W):
            return jnp.tanh(c @ W), None
        out, _ = jax.lax.scan(body, h, W_stack)
        return out

    staged = split_stages({"W": Ws}, 4)["W"]
    out = gpipe_apply(lambda p, h: layer_scan(p, h), staged, x, mesh)
    np.save(sys.argv[2], np.asarray(out))
    print("REF_OK")
""")

_PORT = textwrap.dedent("""
    import os, sys
    import numpy as np
    import torch
    import torch.multiprocessing as mp

    def work(rank, npz, out):
        torch.set_num_threads(1)
        from torch.distributed.tensor import Shard, distribute_tensor
        from repro_torch.distributed.pipeline import gpipe_apply, split_stages
        from repro_torch.launch.mesh import gloo_world, named_mesh
        z = np.load(npz)
        Ws, x = torch.from_numpy(z["Ws"]), torch.from_numpy(z["x"])

        def stack(W_stack, h):
            for W in W_stack:
                h = torch.tanh(h @ W)
            return h

        ref = torch.stack([stack(Ws, xm) for xm in x])
        staged = split_stages({"W": Ws}, 4)["W"]
        with gloo_world(rank, 4, out + ".store"):
            mesh = named_mesh("cpu", (4,), ("stage",))
            y = gpipe_apply(stack, staged, x, mesh)
            ys = gpipe_apply(stack, distribute_tensor(
                staged, mesh, [Shard(0)], src_data_rank=None), x, mesh)
        assert torch.equal(y, ref) and torch.equal(ys, ref), rank
        if rank == 0:
            np.save(out, y.numpy())

    if __name__ == "__main__":
        mp.spawn(work, args=tuple(sys.argv[1:3]), nprocs=4)
""")


def test_gpipe_bit_equal_to_stack_and_close_to_reference(tmp_path):
    rng = np.random.default_rng(0)
    npz = tmp_path / "in.npz"
    np.savez(npz, Ws=(rng.standard_normal((L, D, D)) / np.sqrt(D)).astype(
        np.float32), x=rng.standard_normal((M, MB, D)).astype(np.float32))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    script = tmp_path / "worker.py"
    script.write_text(_PORT)
    port = subprocess.Popen(
        [sys.executable, str(script), str(npz), str(tmp_path / "port.npy")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=ROOT)
    r = subprocess.run([sys.executable, "-c", _REF, str(npz),
                        str(tmp_path / "ref.npy")], env=env,
                       capture_output=True, text=True, timeout=120, cwd=ROOT)
    try:
        out, err = port.communicate(timeout=120)
    finally:
        if port.poll() is None:
            port.kill()
            port.wait()
    assert port.returncode == 0, out + err[-4000:]
    assert "REF_OK" in r.stdout, r.stdout + r.stderr[-4000:]
    got, want = np.load(tmp_path / "port.npy"), np.load(tmp_path / "ref.npy")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert bubble_fraction(S, M) == pytest.approx(3 / 9)
