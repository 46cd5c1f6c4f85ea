"""Atomic, async checkpointing in the reference's format (the port of
``repro.checkpoint.checkpoint``).

  * **Atomic**: writes go to ``step_N.tmp-<nonce>/`` and are renamed to
    ``step_N/`` only after fsync, so a preempted save never corrupts the
    latest checkpoint; a restart picks up the newest complete directory.
  * **Async**: :class:`AsyncCheckpointer` snapshots tensors to host memory
    on the training thread and serializes and writes them on a worker
    thread, overlapping the next training steps; ``wait()`` joins before
    the next save or at exit and raises the worker's error.

Format: one ``.npz`` per tree (``leaf_i`` in JAX's leaf order, see
:mod:`repro_torch.tree`) and a ``manifest.json`` with the step, each
tree's ``treedef`` (informational) and ``n_leaves``, and ``extras``.  So
either package restores the other's checkpoints.  A bfloat16 leaf is
written as the reference writes it, its two bytes as numpy's ``|V2``; on
restore a ``|V2`` leaf is read back as bfloat16 bits, and any other dtype
is cast to the like-leaf's.  (The reference itself cannot restore its
``|V2`` leaves: numpy has no cast from them.)

On a mesh a DTensor leaf is saved whole (``full_tensor``, a collective
every rank joins; only rank 0 writes), and ``restore_checkpoint(...,
shardings=)`` reshards on load: each full leaf is read into host memory
and laid out by its target
:class:`~repro_torch.distributed.sharding.NamedSharding`, only the rank's
shard copied to the device, so a checkpoint
saved on any mesh (or by the reference on any device count) restores onto
any other.
"""
from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import tempfile
import threading
from typing import Any

import numpy as np
import torch

from repro_torch import tree
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import distribute_from_host

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "AsyncCheckpointer"]

_STEP_RE = re.compile(r"^step_(\d+)$")
_BF16_BYTES = np.dtype("V2")


# ---------------------------------------------------------------------------
# tensors <-> numpy
# ---------------------------------------------------------------------------
def _to_numpy(x) -> np.ndarray:
    """A leaf as the numpy array the reference would write: a bfloat16
    tensor as its raw two bytes (``|V2``)."""
    if not torch.is_tensor(x):
        return np.asarray(x)
    if hasattr(x, "full_tensor"):  # a DTensor: gather its shards
        x = x.full_tensor()
    x = x.detach().to("cpu", copy=True)  # a snapshot, also of a CPU tensor
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(_BF16_BYTES)
    return x.numpy()


def _from_numpy(a: np.ndarray, like: torch.Tensor,
                dev: torch.device) -> torch.Tensor:
    if a.dtype == _BF16_BYTES:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=dev, dtype=like.dtype)


# ---------------------------------------------------------------------------
# trees <-> one .npz each
# ---------------------------------------------------------------------------
def _save_tree(path: pathlib.Path, name: str, tree_: Any) -> dict:
    leaves, treedef = tree.flatten(tree_)
    flat = {f"leaf_{i}": _to_numpy(x) for i, x in enumerate(leaves)}
    np.savez(path / f"{name}.npz", **flat)
    return {"treedef": str(treedef), "n_leaves": len(flat)}


def _load_tree(path: pathlib.Path, name: str, like: Any,
               dev: torch.device, shardings: Any = None) -> Any:
    """The tree ``name`` read one leaf at a time; with ``shardings`` (a
    tree of NamedSharding like ``like``) each leaf is laid out from host
    memory, only this rank's shard copied to ``dev``."""
    like_leaves, treedef = tree.flatten(like)
    shards = ([None] * len(like_leaves) if shardings is None
              else tree.leaves(shardings))
    host = torch.device("cpu")
    out = []
    with np.load(path / f"{name}.npz") as z:
        if len(z.files) != len(like_leaves):
            raise ValueError(
                f"checkpoint {name}: {len(z.files)} leaves, expected "
                f"{len(like_leaves)} — structure changed?")
        if len(shards) != len(like_leaves):
            raise ValueError(f"shardings of {name}: {len(shards)} leaves, "
                             f"expected {len(like_leaves)}")
        for i, (l, sh) in enumerate(zip(like_leaves, shards)):
            a = z[f"leaf_{i}"]
            if sh is None:
                out.append(_from_numpy(a, l, dev))
            else:
                out.append(distribute_from_host(_from_numpy(a, l, host), sh,
                                                dev))
    return tree.unflatten(treedef, out)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------
def save_checkpoint(ckpt_dir: str | os.PathLike, step: int,
                    trees: dict[str, Any], extras: dict | None = None) -> str:
    """Write ``trees`` (name -> tree of tensors or numpy arrays)
    atomically; returns the final path."""
    root = pathlib.Path(ckpt_dir)
    root.mkdir(parents=True, exist_ok=True)
    final = root / f"step_{step}"
    tmp = pathlib.Path(tempfile.mkdtemp(prefix=f"step_{step}.tmp-", dir=root))
    try:
        manifest = {"step": step, "trees": {}, "extras": extras or {}}
        for name, tree_ in trees.items():
            manifest["trees"][name] = _save_tree(tmp, name, tree_)
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        fd = os.open(tmp, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return str(final)


def latest_step(ckpt_dir: str | os.PathLike) -> int | None:
    root = pathlib.Path(ckpt_dir)
    if not root.exists():
        return None
    steps = [int(m.group(1)) for p in root.iterdir()
             if (m := _STEP_RE.match(p.name))
             and (p / "manifest.json").exists()]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str | os.PathLike, likes: dict[str, Any],
                       step: int | None = None, *,
                       device: str | torch.device | None = None,
                       shardings: dict[str, Any] | None = None):
    """Restore trees by name onto ``device`` (default ``"cuda"``), each
    leaf in its like-leaf's dtype; reshards onto ``shardings`` (name ->
    tree of :class:`~repro_torch.distributed.sharding.NamedSharding`
    like the tree) if given: every rank reads each full leaf into host
    memory and copies only its shard to the device.

    Returns (step, {name: tree}, extras) or (None, None, None) when no
    complete checkpoint exists (fresh start).
    """
    dev = resolve_device(device)
    root = pathlib.Path(ckpt_dir)
    step = latest_step(root) if step is None else step
    if step is None:
        return None, None, None
    path = root / f"step_{step}"
    manifest = json.loads((path / "manifest.json").read_text())
    out = {}
    for name, like in likes.items():
        out[name] = _load_tree(path, name, like, dev,
                               (shardings or {}).get(name))
    return step, out, manifest.get("extras", {})


def _rank() -> int:
    import torch.distributed as dist

    return (dist.get_rank() if dist.is_available() and dist.is_initialized()
            else 0)


class AsyncCheckpointer:
    """Snapshot on the caller thread, serialize and write on a worker
    thread; keeps the newest ``keep`` checkpoints."""

    def __init__(self, ckpt_dir: str | os.PathLike, keep: int = 3):
        self.ckpt_dir = pathlib.Path(ckpt_dir)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, step: int, trees: dict[str, Any],
             extras: dict | None = None) -> None:
        self.wait()
        # snapshot to host memory now: the caller updates the tensors next
        host_trees = {name: tree.map(_to_numpy, tree_)
                      for name, tree_ in trees.items()}

        if _rank() != 0:  # every rank joined the snapshot; one writes
            return

        def work():
            try:
                save_checkpoint(self.ckpt_dir, step, host_trees, extras)
                self._gc()
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(
            int(m.group(1)) for p in self.ckpt_dir.iterdir()
            if (m := _STEP_RE.match(p.name)))
        for s in steps[: -self.keep]:
            shutil.rmtree(self.ckpt_dir / f"step_{s}", ignore_errors=True)
