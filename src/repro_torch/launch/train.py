"""Fault-tolerant training loop (the port of ``repro.launch.train``).

  * **checkpoint/restart**: atomic, async checkpoints every
    ``--ckpt-every`` steps, with the optimizer state and the data
    iterator's position; on start the newest complete checkpoint is
    restored.  The format is the reference's, so either package resumes
    the other's run.
  * **preemption**: SIGTERM/SIGINT force a final checkpoint before exit.
  * **straggler watchdog**: each step's wall time is tracked against an
    EWMA; steps slower than ``watchdog_factor`` x EWMA are flagged in the
    history.
  * **NaN handling**: a non-finite loss is logged, and the next step's
    clip takes its effects.

Usage:
    python -m repro_torch.launch.train --arch olmo-1b --reduced --steps 20 --device cpu
    python -m repro_torch.launch.train --arch hymba-1.5b --reduced --steps 200 --ckpt-dir build/ckpt
"""
from __future__ import annotations

import argparse
import dataclasses
import signal
import sys
import time

import numpy as np
import torch

from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint)
from repro_torch.configs import REGISTRY, get_config, reduced_config
from repro_torch.configs.base import SHAPES, ShapeSpec
from repro_torch.data import DataIterator, SyntheticLMDataset
from repro_torch import tree
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (ShardingReport, distribute,
                                              make_batch_sharding,
                                              make_param_shardings)
from repro_torch.launch import steps as S
from repro_torch.models import transformer as T


@dataclasses.dataclass
class TrainState:
    params: object
    opt_state: object
    step: int = 0


class Watchdog:
    """EWMA straggler detector."""

    def __init__(self, factor: float = 3.0, alpha: float = 0.2):
        self.factor, self.alpha, self.ewma = factor, alpha, None
        self.flagged: list[int] = []

    def observe(self, step: int, dt: float) -> bool:
        if self.ewma is None:
            self.ewma = dt
            return False
        slow = dt > self.factor * self.ewma
        if slow:
            self.flagged.append(step)
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return slow


def train(cfg, shape: ShapeSpec, *, steps: int, ckpt_dir: str | None,
          ckpt_every: int = 50, mesh=None, seed: int = 0,
          log_every: int = 10, watchdog_factor: float = 3.0,
          device: str | torch.device | None = None):
    """Train ``cfg`` on the synthetic stream for ``steps`` steps (counted
    from 0, so a resumed run continues to the same total) on ``device``
    (default ``"cuda"``).  Returns ``(params, opt_state, history)``, one
    history entry a step run: ``step``, ``loss``, ``grad_norm``,
    ``time_s``, ``straggler``.

    Given a ``mesh`` (:func:`repro_torch.launch.mesh.make_local_mesh`) the
    parameters, optimizer state and batches are DTensors laid out by the
    sharding rules, the activations by ``cfg.act_spec``, and the
    microbatch count counts the batch shards, as the reference's ``train``
    does; a checkpoint restores onto the mesh.  Without one the run stays
    on ``device`` unsharded."""
    dev = resolve_device(device)
    tok_sh = params_sh = opt_sh = None
    if mesh is not None:
        tok_sh = make_batch_sharding(cfg, mesh, shape, ShardingReport())
        cfg = dataclasses.replace(
            cfg, act_spec=S._act_spec(cfg, shape, mesh, tok_sh.spec) + (mesh,))
    optimizer = S.make_optimizer(cfg, total=steps)
    n_mb = S.default_microbatches(cfg, shape, mesh)
    step_fn = S.make_train_step(cfg, optimizer, n_mb)

    dataset = SyntheticLMDataset(cfg.vocab_size, shape.seq_len,
                                 shape.global_batch, seed=seed)
    it = DataIterator(dataset, dev, sharding=tok_sh)

    params = T.init_lm(cfg, torch.Generator(dev).manual_seed(seed),
                       device=dev)
    opt_state = optimizer.init(params)
    if mesh is not None:
        params_sh = make_param_shardings(cfg, mesh, params)
        opt_sh = S._opt_state_shardings(optimizer, params_sh, opt_state,
                                        mesh)
        params = tree.map(distribute, params, params_sh)
        opt_state = tree.map(distribute, opt_state, opt_sh)
        step_fn = S._under_mesh(step_fn)
    start = 0

    ckpt = AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    if ckpt_dir and latest_step(ckpt_dir) is not None:
        step0, trees, extras = restore_checkpoint(
            ckpt_dir, {"params": params, "opt_state": opt_state}, device=dev,
            shardings=(None if mesh is None else
                       {"params": params_sh, "opt_state": opt_sh}))
        params, opt_state = trees["params"], trees["opt_state"]
        it.load_state_dict(extras["data"])
        start = step0
        print(f"[train] resumed from step {start}", flush=True)

    # --- preemption hook ---------------------------------------------------
    preempted = {"flag": False}

    def on_term(signum, frame):
        preempted["flag"] = True

    old_handlers = {s: signal.signal(s, on_term)
                    for s in (signal.SIGTERM, signal.SIGINT)}

    wd = Watchdog(watchdog_factor)
    history = []
    try:
        for step in range(start, steps):
            batch = next(it)
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            slow = wd.observe(step, dt)
            history.append({"step": step, "loss": loss,
                            "grad_norm": float(metrics["grad_norm"]),
                            "time_s": dt, "straggler": slow})
            if not np.isfinite(loss):
                print(f"[train] step {step}: non-finite loss, "
                      f"skipping optimizer effects via next clip",
                      flush=True)
            if step % log_every == 0 or step == steps - 1:
                print(f"[train] step {step:5d} loss {loss:.4f} "
                      f"gnorm {history[-1]['grad_norm']:.3f} "
                      f"{dt*1e3:.0f} ms" + (" [STRAGGLER]" if slow else ""),
                      flush=True)
            do_ckpt = ckpt and ((step + 1) % ckpt_every == 0
                                or preempted["flag"] or step == steps - 1)
            if do_ckpt:
                ckpt.save(step + 1,
                          {"params": params, "opt_state": opt_state},
                          extras={"data": it.state_dict(), "arch": cfg.name})
            if preempted["flag"]:
                print(f"[train] preempted at step {step}; checkpoint "
                      f"flushed, exiting", flush=True)
                break
    finally:
        if ckpt:
            ckpt.wait()
        for s, h in old_handlers.items():
            signal.signal(s, h)
    return params, opt_state, history


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(REGISTRY))
    ap.add_argument("--shape", default="train_4k", choices=sorted(SHAPES))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU-trainable)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs on the CPU)")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    shape = SHAPES[args.shape]
    if args.reduced:
        cfg = reduced_config(cfg)
        shape = ShapeSpec("reduced", args.seq, args.batch, "train")
    _, _, history = train(cfg, shape, steps=args.steps,
                          ckpt_dir=args.ckpt_dir,
                          ckpt_every=args.ckpt_every, device=args.device)
    losses = [h["loss"] for h in history]
    print(f"[train] done: first loss {losses[0]:.4f} -> last "
          f"{losses[-1]:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
