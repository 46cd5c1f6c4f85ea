"""Train a 76 M-parameter LM for a few hundred steps on the port.

Uses the full training path: the config system, the synthetic data
pipeline, the train step, AdamW, async checkpointing and the watchdog
(:func:`repro_torch.launch.train.train`), with the reference example's
olmo-family config (12 x d512, 8 heads, d_ff 2048, vocab 50304, float32,
no rematerialization, 128-token attention chunks: 76.1 M parameters with
olmo's tied embeddings, which the reference's comment counts as ~110 M).
Prints the mean loss of the first and last tenth of the steps and asserts
that it fell.

Run:  python -m repro_torch.examples.train_lm [--steps 300] [--device cpu]
      python -m repro_torch.examples.train_lm --reduced --device cpu

A directory that already holds this run's checkpoints resumes from the
newest one (pass a fresh ``--ckpt-dir`` to start over).
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch.train import train

# 12 x d512 olmo-family (GPT-2-small scale)
EXAMPLE_CONFIG = dict(n_layers=12, d_model=512, n_heads=8, n_kv_heads=8,
                      d_ff=2048, vocab_size=50304, head_dim=64,
                      dtype="float32", remat="none", attn_chunk_q=128,
                      attn_chunk_kv=128)
# the same family at 2 x d64 (vocab 512): --reduced, for a run on the CPU
REDUCED = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
               d_ff=128, vocab_size=512)


def example_config(**overrides):
    """The example's olmo-family config; ``overrides`` replace its fields
    (the tests shrink it)."""
    return dataclasses.replace(get_config("olmo-1b"),
                               **{**EXAMPLE_CONFIG, **overrides})


def run(cfg, *, steps: int, batch: int, seq: int, ckpt_dir: str | None,
        ckpt_every: int = 100, log_every: int = 20, device=None) -> dict:
    """Train ``cfg`` for ``steps`` steps of ``batch`` x ``seq`` tokens on
    ``device`` and check that the loss fell.  Returns the loss history
    (``losses``), the first- and last-tenth means (``first``, ``last``,
    over ``k`` steps each) and the mean step wall (``step_s``, the first
    step excluded when there are more)."""
    print(f"[example] training {cfg.param_count() / 1e6:.0f}M-param "
          f"{cfg.family} LM for {steps} steps")
    shape = ShapeSpec("example", seq, batch, "train")
    _, _, hist = train(cfg, shape, steps=steps, ckpt_dir=ckpt_dir,
                       ckpt_every=ckpt_every, log_every=log_every,
                       device=device)
    if not hist:
        raise RuntimeError(f"no step ran: the newest checkpoint in "
                           f"{ckpt_dir} is already at step {steps}")
    losses = [h["loss"] for h in hist]
    k = max(1, len(losses) // 10)
    first, last = float(np.mean(losses[:k])), float(np.mean(losses[-k:]))
    print(f"[example] loss: first-{k} avg {first:.3f} -> last-{k} avg "
          f"{last:.3f}")
    if not last < first:
        raise AssertionError("loss did not improve")
    print("[example] OK")
    times = [h["time_s"] for h in hist]
    return {"losses": losses, "first": first, "last": last, "k": k,
            "step_s": float(np.mean(times[1:] or times))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="build/train_lm",
                    help="checkpoint directory (default build/train_lm "
                         "under the working directory)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu trains on the "
                         "CPU)")
    ap.add_argument("--reduced", action="store_true",
                    help="train the 2 x d64 config of the same family "
                         "instead (seconds on a CPU)")
    args = ap.parse_args(argv)
    cfg = example_config(**(REDUCED if args.reduced else {}))
    run(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
        ckpt_dir=args.ckpt_dir, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
