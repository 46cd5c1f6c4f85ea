"""Step builders: the train, prefill and decode steps of one config (the
port of the one-device half of ``repro.launch.steps``).

    make_optimizer(cfg)                       -> AdamW
    make_train_step(cfg, optimizer, n_mb)     -> train_step
    default_microbatches(cfg, shape)          -> gradient-accumulation count
    make_prefill_step(cfg) / make_decode_step(cfg)

A train step takes ``lm_loss`` and its gradients through autograd
(:func:`value_and_grad`), applies AdamW and returns the new parameters and
optimizer state with the loss and the unclipped gradients' global norm.
The reference's sharding (``input_specs``, ``abstract_*``, the
``grad_specs`` constraint, ``build_jitted_step`` and its variants) has no
counterpart on one card.
"""
from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import (AdamW, apply_updates, cosine_schedule,
                                     global_norm)

__all__ = ["make_optimizer", "make_train_step", "value_and_grad",
           "default_microbatches", "make_prefill_step", "make_decode_step"]


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
def make_optimizer(cfg: ModelConfig, *, lr: float = 3e-4, warmup: int = 200,
                   total: int = 10_000) -> AdamW:
    """AdamW with int8 moments for models whose float32 moments would not
    fit 16 GB a chip at 256-way sharding (the reference's rule)."""
    quantize = cfg.param_count() * 8 / 256 > 6e9  # m+v bytes per chip
    return AdamW(lr=cosine_schedule(lr, warmup, total),
                 quantize_moments=quantize)


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------
def value_and_grad(cfg: ModelConfig, params, batch):
    """``(loss, grads)``: ``lm_loss`` on ``batch`` (``tokens`` or
    ``embeds``, and ``labels``) and its gradient, a tree like ``params``
    (each leaf in its parameter's dtype; zeros for a leaf the loss does not
    reach).  ``params`` are not modified."""
    leaves, treedef = tree.flatten(params)
    ps = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss = T.lm_loss(cfg, tree.unflatten(treedef, ps),
                         batch.get("tokens"), batch["labels"],
                         embeds=batch.get("embeds"))
        grads = torch.autograd.grad(loss, ps, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), tree.unflatten(treedef, grads)


def make_train_step(cfg: ModelConfig, optimizer: AdamW,
                    n_microbatches: int = 1):
    """Loss + grad + AdamW update.  ``n_microbatches > 1`` splits the batch
    and accumulates float32 gradients over the microbatches, scaling loss
    and gradients by ``1 / n_microbatches``: the live activations shrink
    by that factor (standard gradient accumulation)."""

    def train_step(params, opt_state, batch):
        if n_microbatches == 1:
            loss, grads = value_and_grad(cfg, params, batch)
        else:
            mbs = {k: v.reshape((n_microbatches,
                                 v.shape[0] // n_microbatches)
                                + tuple(v.shape[1:]))
                   for k, v in batch.items()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["labels"].device)
            grads = tree.map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(n_microbatches):
                li, gi = value_and_grad(cfg, params,
                                        {k: v[i] for k, v in mbs.items()})
                grads = tree.map(lambda a, b: a + b.to(torch.float32),
                                 grads, gi)
                loss = loss + li
            scale = 1.0 / n_microbatches
            loss = loss * scale
            grads = tree.map(lambda g: g * scale, grads)
        with torch.profiler.record_function("adamw"):  # a profiler span
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = apply_updates(params, updates)
        gnorm = global_norm(tree.leaves(grads))
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def default_microbatches(cfg: ModelConfig, shape: ShapeSpec,
                         budget_bytes: float = 2.5e9) -> int:
    """Smallest power-of-two microbatch count whose saved-activation set
    fits the budget, and that divides the batch: the reference's rule on a
    mesh whose axes all have size 1 (one card), where neither the batch
    nor the ff width is sharded, whatever the parallelism mode.  Saved
    bytes a layer a token under the remat policy the reference picks
    (``full`` above 10 B parameters, else ``dots``), in bf16: ``full`` ->
    d; ``dots`` -> 2d + the qkv projections + the mixer's 3 d_inner + the
    two ff outputs (none for MoE, whose expert products are recomputed)."""
    if shape.kind != "train":
        return 1
    d, batch = cfg.d_model, shape.global_batch
    if cfg.param_count() > 10e9:  # remat "full"
        per_tok = d
    else:  # remat "dots"
        attn = ((cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.hd
                if cfg.has_attention else 0)
        ssm = 3 * cfg.d_inner if cfg.has_ssm else 0
        ff = 0 if cfg.is_moe else 2 * cfg.d_ff
        per_tok = 2 * d + attn + ssm + ff
    act = cfg.n_layers * batch * shape.seq_len * per_tok * 2
    mb = 1
    while act / mb > budget_bytes and mb < batch:
        mb *= 2
    while batch % mb != 0 and mb < batch:
        mb *= 2
    return min(mb, batch)


def make_prefill_step(cfg: ModelConfig, max_len: int | None = None):
    def prefill_step(params, batch):
        return T.prefill(cfg, params, batch.get("tokens"),
                         embeds=batch.get("embeds"), max_len=max_len)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, caches, batch):
        return T.decode_step(cfg, params, batch["tokens"], caches,
                             batch["pos"])

    return decode_step
