"""The train, prefill and decode steps of one config,
unsharded or sharded over a mesh (the port of ``repro.launch.steps``).

    make_optimizer(cfg)                          -> AdamW
    make_train_step(cfg, optimizer, n_mb)        -> train_step
    default_microbatches(cfg, shape, mesh=None)  -> gradient-accumulation count
    make_prefill_step(cfg) / make_decode_step(cfg)
    build_sharded_step(cfg, shape, mesh)         -> StepBundle

A train step takes ``lm_loss`` and its gradients through autograd
(:func:`value_and_grad`), applies AdamW and returns the new parameters and
optimizer state with the loss and the unclipped gradients' global norm.

:func:`build_sharded_step` is the counterpart of ``build_jitted_step``: the
parameters, optimizer state, batch and caches become DTensors laid out by
the sharding rules (:mod:`repro_torch.distributed.sharding`), ``cfg.act_spec``
carries the activation layout and the mesh to the model's constraints, and
DTensor inserts the collectives the layouts imply (where GSPMD does in the
reference); row-independent layers, the loss and the optimizer run on
local shards through ``local_map`` (see ``models/transformer.py``).  On
a fake world (:func:`repro_torch.launch.mesh.fake_world`) with no tensors
given, the example arguments are ``meta`` DTensors: the dry run
dispatches the step without computing or allocating anything.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.distributed.sharding import (
    NamedSharding,
    ShardingReport,
    distribute,
    is_dtensor,
    make_batch_sharding,
    make_cache_shardings,
    make_param_shardings,
    plan_parallelism,
)
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import (AdamW, MomentState, apply_updates,
                                     cosine_schedule, global_norm)

__all__ = ["input_specs", "abstract_params", "abstract_caches",
           "make_optimizer", "abstract_opt_state", "make_train_step",
           "value_and_grad", "default_microbatches", "make_prefill_step",
           "make_decode_step", "build_sharded_step", "StepBundle",
           "VARIANTS"]

_META = torch.device("meta")


# ---------------------------------------------------------------------------
# abstract inputs (meta tensors: shapes and dtypes, no allocation)
# ---------------------------------------------------------------------------
def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict[str, Any]:
    """Model inputs for one (arch x shape) cell, as ``meta`` tensors.

    ``vision_patch`` archs take precomputed patch embeddings; everything
    else takes token ids.  Decode kinds take a [B, 1] token and the scalar
    cache position; their caches come from :func:`abstract_caches`.
    """
    B, S = shape.global_batch, shape.seq_len

    def sds(shp, dtype):
        return torch.empty(shp, dtype=dtype, device=_META)

    if shape.kind == "train":
        if cfg.frontend == "vision_patch":
            return {"embeds": sds((B, S, cfg.d_model), cfg.jdtype),
                    "labels": sds((B, S), torch.int32)}
        return {"tokens": sds((B, S), torch.int32),
                "labels": sds((B, S), torch.int32)}
    if shape.kind == "prefill":
        if cfg.frontend == "vision_patch":
            return {"embeds": sds((B, S, cfg.d_model), cfg.jdtype)}
        return {"tokens": sds((B, S), torch.int32)}
    # decode: one new token against a seq_len-deep cache
    return {"tokens": sds((B, 1), torch.int32),
            "pos": sds((), torch.int32)}


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree of ``init_lm`` as ``meta`` tensors (shapes and
    dtypes, the reference's leaf order), built from the leaves' shapes
    rather than drawn."""
    template = T._layer_init(cfg, None, _META)
    params = {
        "embed": torch.empty((cfg.vocab_size, cfg.d_model),
                             dtype=cfg.jdtype, device=_META),
        "stages": [T._empty_stacked(template, st.length, _META)
                   for st in T.plan_stages(cfg)],
        "final_norm": L.norm_init(cfg, _META),
    }
    if not cfg.tie_embeddings:
        params["head"] = torch.empty((cfg.d_model, cfg.vocab_size),
                                     dtype=cfg.jdtype, device=_META)
    return params


def abstract_caches(cfg: ModelConfig, shape: ShapeSpec) -> list[dict]:
    return T.init_caches(cfg, shape.global_batch, shape.seq_len,
                         device=_META)


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


def abstract_opt_state(optimizer: AdamW, params):
    """``optimizer.init`` of (``meta``) parameters."""
    return optimizer.init(params)


def _opt_state_shardings(optimizer: AdamW, params_sh, opt_state, mesh):
    """Moment shardings: mirror the param sharding.  A quantized moment's
    int8 ``q`` is shape-preserving, so it shards exactly like its
    parameter, over every mesh axis the parameter uses; its per-channel
    scale drops the last dim's sharding."""
    p_leaves = tree.leaves(params_sh)

    def moment(ms, psh):
        if isinstance(ms, MomentState):
            spec = tuple(psh.spec) + (None,) * (len(ms.q.shape)
                                                - len(psh.spec))
            sspec = (spec[:-1] + (None,)) if len(ms.scale.shape) else ()
            return MomentState(NamedSharding(mesh, spec),
                               NamedSharding(mesh, sspec))
        return psh

    def tup(key):
        return tuple(moment(ms, psh)
                     for ms, psh in zip(opt_state[key], p_leaves))

    return {"m": tup("m"), "v": tup("v"),
            "count": NamedSharding(mesh, ())}


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------

def value_and_grad(cfg: ModelConfig, params, batch):
    """``(loss, grads)``: ``lm_loss`` on ``batch`` (``tokens`` or
    ``embeds``, and ``labels``) and its gradient, a tree like ``params``
    (each leaf in its parameter's dtype; zeros for a leaf the loss does not
    reach).  The gradient of a DTensor parameter is laid out like the
    parameter (a partial sum is reduce-scattered onto its shards).
    ``params`` are not modified."""
    leaves, treedef = tree.flatten(params)
    ps = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss = T.lm_loss(cfg, tree.unflatten(treedef, ps),
                         batch.get("tokens"), batch["labels"],
                         embeds=batch.get("embeds"))
        grads = torch.autograd.grad(loss, ps, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    grads = [g.redistribute(p.device_mesh, p.placements)
             if is_dtensor(g) else g for p, g in zip(leaves, grads)]
    return loss.detach(), tree.unflatten(treedef, grads)


def _place(x, sh: NamedSharding):
    if not is_dtensor(x) or tuple(x.placements) == sh.placements:
        return x
    return x.redistribute(sh.mesh, sh.placements)


def make_train_step(cfg: ModelConfig, optimizer: AdamW,
                    n_microbatches: int = 1, grad_specs=None):
    """Loss + grad + AdamW update.  ``n_microbatches > 1`` splits the batch
    and accumulates float32 gradients over the microbatches, scaling loss
    and gradients by ``1 / n_microbatches``: the live activations shrink
    by that factor (standard gradient accumulation).

    ``grad_specs`` (a tree of :class:`NamedSharding` matching params, for
    DTensor parameters) lays each microbatch's gradients and the
    accumulator out by it inside the loop, the reference's constraint."""

    def _constrain_grads(g):
        if grad_specs is None:
            return g
        return tree.map(_place, g, grad_specs)

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
            grads = _constrain_grads(tree.map(
                lambda p: torch.zeros_like(p, dtype=torch.float32), params))
            for i in range(n_microbatches):
                li, gi = value_and_grad(cfg, params,
                                        {k: v[i] for k, v in mbs.items()})
                gi = _constrain_grads(gi)
                grads = _constrain_grads(tree.map(
                    lambda a, b: a + b.to(torch.float32), grads, gi))
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


def default_microbatches(cfg: ModelConfig, shape: ShapeSpec, mesh=None,
                         budget_bytes: float = 2.5e9) -> int:
    """Smallest power-of-two microbatch count whose saved-activation set
    fits the budget (the reference's rule).  Saved bytes/layer/local-token
    under the remat policy (``full`` above 10 B parameters, else ``dots``),
    in bf16: ``full`` -> d;  ``dots`` -> 2d + the qkv projections + the
    mixer's 3 d_inner + the two ff outputs (model-sharded in tp mode; none
    for MoE, whose expert products are recomputed).  The local tokens are
    the batch over its shards (and, in tp mode, the sequence over
    ``model``).  ``mesh=None`` is one card: every axis of size 1."""
    if shape.kind != "train":
        return 1
    mode = plan_parallelism(cfg)
    n_batch_shards = 1
    sizes = ({} if mesh is None
             else dict(zip(mesh.mesh_dim_names, tuple(mesh.shape))))
    axes = (("pod", "data") if mode == "tp" else ("pod", "data", "model"))
    b = shape.global_batch
    for a in axes:
        n = sizes.get(a, 1)
        if b % n == 0:
            n_batch_shards *= n
            b //= n
    tok_loc = shape.global_batch * shape.seq_len / n_batch_shards
    if mode == "tp" and shape.seq_len % sizes.get("model", 1) == 0:
        tok_loc /= sizes.get("model", 1)  # sequence parallelism (_act_spec)
    d = cfg.d_model
    if cfg.param_count() > 10e9:  # remat "full"
        per_tok = d
    else:  # remat "dots"
        ff_eff = (cfg.d_ff // sizes.get("model", 1)) if mode == "tp" \
            else cfg.d_ff
        attn = ((cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.hd
                if cfg.has_attention else 0)
        ssm = 3 * cfg.d_inner if cfg.has_ssm else 0
        moe_ff = 0 if cfg.is_moe else 2 * ff_eff
        per_tok = 2 * d + attn + ssm + moe_ff
    act = cfg.n_layers * tok_loc * per_tok * 2  # bf16
    # each microbatch's *global* batch must still divide the batch shards
    mb_cap = max(shape.global_batch // n_batch_shards, 1)
    mb = 1
    while act / mb > budget_bytes and mb < mb_cap:
        mb *= 2
    while shape.global_batch % mb != 0 and mb < mb_cap:
        mb *= 2
    return min(mb, mb_cap)


def make_prefill_step(cfg: ModelConfig, max_len: int | None = None):
    def prefill_step(params, batch, caches=None):
        return T.prefill(cfg, params, batch.get("tokens"),
                         embeds=batch.get("embeds"), max_len=max_len,
                         caches=caches)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, caches, batch):
        return T.decode_step(cfg, params, batch["tokens"], caches,
                             batch["pos"])

    return decode_step


# ---------------------------------------------------------------------------
# sharded assembly
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class StepBundle:
    """Everything the launcher / dry run needs for one (arch x shape) cell:
    ``step(*example_args)`` runs the sharded step."""
    cfg: ModelConfig
    shape: ShapeSpec
    mesh: Any
    step: Any
    example_args: tuple
    report: ShardingReport
    kind: str


def _dryrun_cfg(cfg: ModelConfig, shape: ShapeSpec) -> ModelConfig:
    """Remat policy for a sharded train step: big models full-remat each
    layer, small ones only save the weight products' outputs — the knob a
    production run would set."""
    if shape.kind != "train" or cfg.remat != "none":
        return cfg
    policy = "full" if cfg.param_count() > 10e9 else "dots"
    return dataclasses.replace(cfg, remat=policy)


def _ax(mesh, name: str) -> int:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape))).get(name, 1)


def _act_spec(cfg: ModelConfig, shape: ShapeSpec, mesh, tok_spec) -> tuple:
    """(batch_axes, seq_axes, vocab_axis) for activation constraints.

    TP mode adds Megatron-style sequence parallelism: between blocks the
    residual stream is sharded over ``model`` on the *sequence* dim, so the
    per-device saved-activation stack shrinks by the TP degree.
    ``cfg.act_spec`` holds this triple and the mesh.
    """
    b, s = tok_spec[0], (tok_spec[1] if len(tok_spec) > 1 else None)
    used = set(b) if isinstance(b, tuple) else ({b} if b else set())
    used |= set(s) if isinstance(s, tuple) else ({s} if s else set())
    if (s is None and shape.kind in ("train", "prefill")
            and plan_parallelism(cfg) == "tp" and "model" not in used
            and shape.seq_len % _ax(mesh, "model") == 0):
        s = "model"
        used.add("model")
    v = "model" if ("model" not in used
                    and cfg.vocab_size % _ax(mesh, "model") == 0) else None
    return (b, s, v)


VARIANTS = ("baseline", "remat_none", "remat_dots", "ep_resident",
            "w8_weights", "kv8", "w8kv8", "no_seqpar", "mb_half",
            "logits_bf16", "grad_shard", "loss_vtp", "loss_vtp_mb_half",
            "sp_gather", "combo_tp", "combo_tp_mb8")


def _distribute_tree(x, shardings):
    return tree.map(distribute, x, shardings)


def _place_tree(x, shardings):
    return tree.map(_place, x, shardings)


def _under_mesh(fn):
    """``fn`` with plain tensors it creates (positions, masks, constants:
    the same on every rank) taken as replicated DTensors where they meet
    DTensor operands."""
    from torch.distributed.tensor.experimental import implicit_replication

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with implicit_replication():
            return fn(*args, **kwargs)

    return run


def build_sharded_step(cfg: ModelConfig, shape: ShapeSpec, mesh, *,
                       variant: str = "baseline", params=None, batch=None,
                       caches=None, pos: int | None = None) -> StepBundle:
    """The sharded step of one cell on ``mesh`` (the counterpart of
    ``build_jitted_step``), ``variant`` one §Perf change (see VARIANTS and
    the reference's docstring).

    ``params`` (the full tree, the same on every rank), ``batch`` (full
    tensors) and, for decode, ``caches`` and the position ``pos`` make the
    example arguments real DTensors; left out they are ``meta`` DTensors
    (the dry run; ``pos`` defaults to ``seq_len - 1``).  A train step's
    optimizer state is ``optimizer.init`` of the full parameters,
    distributed; a prefill step's caches are zeros, distributed.  The
    decode position is a Python int: the port picks the cache slot on the
    host.
    """
    assert variant in VARIANTS, variant
    cfg = _dryrun_cfg(cfg, shape)
    if variant == "remat_none":
        cfg = dataclasses.replace(cfg, remat="none")
    elif variant == "remat_dots":
        cfg = dataclasses.replace(cfg, remat="dots")
    elif variant == "logits_bf16":
        cfg = dataclasses.replace(cfg, loss_dtype="bfloat16")
    elif variant in ("kv8", "w8kv8") and shape.kind != "train":
        cfg = dataclasses.replace(cfg, kv_dtype="int8")
    elif variant in ("loss_vtp", "loss_vtp_mb_half"):
        cfg = dataclasses.replace(cfg, loss_vocab_tp=True)
    elif variant == "sp_gather":
        cfg = dataclasses.replace(cfg, megatron_sp=True)
    elif variant in ("combo_tp", "combo_tp_mb8"):  # sp_gather + loss_vtp
        cfg = dataclasses.replace(cfg, megatron_sp=True, loss_vocab_tp=True)
    report = ShardingReport()
    full_batch = input_specs(cfg, shape) if batch is None else dict(batch)
    tok_sh = make_batch_sharding(cfg, mesh, shape, report)
    aspec = _act_spec(cfg, shape, mesh, tuple(tok_sh.spec))
    if variant == "no_seqpar":
        aspec = (aspec[0], None, aspec[2])
    cfg = dataclasses.replace(cfg, act_spec=aspec + (mesh,))
    full_params = abstract_params(cfg) if params is None else params
    params_sh = make_param_shardings(cfg, mesh, full_params, report)
    if variant == "ep_resident":
        params_sh = _ep_resident_shardings(params_sh, mesh)
    batch_sh = {}
    for k in full_batch:
        if k in ("tokens", "labels"):
            batch_sh[k] = tok_sh
        elif k == "embeds":
            batch_sh[k] = NamedSharding(mesh, tuple(tok_sh.spec) + (None,))
        else:  # pos scalar
            batch_sh[k] = NamedSharding(mesh, ())
    if shape.kind == "decode":
        given = full_batch.get("pos")
        if pos is None:
            pos = (shape.seq_len - 1 if given is None or given.device == _META
                   else int(given))
        full_batch["pos"] = pos
        batch_sh.pop("pos", None)
    dbatch = {k: (distribute(v, batch_sh[k]) if k in batch_sh else v)
              for k, v in full_batch.items()}

    if variant in ("w8_weights", "w8kv8") and shape.kind != "train":
        full_params, params_sh = _quantized_abstract_params(
            cfg, mesh, params_sh, full_params)
    dparams = _distribute_tree(full_params, params_sh)
    logits_sh = NamedSharding(mesh, (
        make_batch_sharding(cfg, mesh, shape).spec[0],
        "model" if cfg.vocab_size % _ax(mesh, "model") == 0 else None))

    if shape.kind == "train":
        optimizer = make_optimizer(cfg)
        opt_state = optimizer.init(full_params)
        opt_sh = _opt_state_shardings(optimizer, params_sh, opt_state, mesh)
        n_mb = default_microbatches(cfg, shape, mesh)
        if variant in ("mb_half", "loss_vtp_mb_half", "combo_tp_mb8"):
            n_mb = max(1, n_mb // 2)
        if n_mb > 1:
            report.fallbacks.append(
                f"gradient accumulation: {n_mb} microbatches")
        inner = make_train_step(
            cfg, optimizer, n_mb,
            grad_specs=params_sh if variant == "grad_shard" else None)

        def train_step(p, o, b):
            p, o, metrics = inner(p, o, b)
            return _place_tree(p, params_sh), _place_tree(o, opt_sh), metrics

        step = train_step
        args = (dparams, _distribute_tree(opt_state, opt_sh), dbatch)
    elif shape.kind == "prefill":
        zeros = (abstract_caches(cfg, shape) if params is None else
                 T.init_caches(cfg, shape.global_batch, shape.seq_len,
                               device=tree.leaves(params)[0].device))
        caches_sh = make_cache_shardings(cfg, mesh, shape, zeros, report)
        inner = make_prefill_step(cfg)
        if variant in ("w8_weights", "w8kv8"):
            inner_p = inner
            inner = lambda p, b, c: inner_p(_dequant_tree(p, cfg.jdtype),
                                            b, c)

        def prefill_step(p, b):
            logits, c = inner(p, b, _distribute_tree(zeros, caches_sh))
            return _place(logits, logits_sh), _place_tree(c, caches_sh)

        step = prefill_step
        args = (dparams, dbatch)
    else:  # decode
        full_caches = abstract_caches(cfg, shape) if caches is None else caches
        caches_sh = make_cache_shardings(cfg, mesh, shape, full_caches,
                                         report)
        inner = make_decode_step(cfg)
        if variant in ("w8_weights", "w8kv8"):
            inner_d = inner
            inner = lambda p, c, b: inner_d(_dequant_tree(p, cfg.jdtype),
                                            c, b)

        def decode_step(p, c, b):
            logits, c = inner(p, c, b)
            return _place(logits, logits_sh), _place_tree(c, caches_sh)

        step = decode_step
        args = (dparams, _distribute_tree(full_caches, caches_sh), dbatch)

    return StepBundle(cfg=cfg, shape=shape, mesh=mesh,
                      step=_under_mesh(step), example_args=args,
                      report=report, kind=shape.kind)


# ---------------------------------------------------------------------------
# §Perf variant helpers
# ---------------------------------------------------------------------------
def _is_qleaf(x) -> bool:
    return isinstance(x, dict) and "q" in x and "scale" in x


def _dequant_tree(params_q, dtype):
    """{'q': int8, 'scale': f32} leaves -> dense weights (at use)."""

    def leaf(x):
        if _is_qleaf(x):
            scale = x["scale"]
            if scale.ndim == 1:
                scale = scale[None, :]
            return x["q"].to(dtype) * scale.to(dtype)
        return x

    return tree.map(leaf, params_q, is_leaf=_is_qleaf)


def _quantized_abstract_params(cfg: ModelConfig, mesh, params_sh,
                               params=None):
    """Int8 weight tree + matching shardings (w8_weights variant):
    ``quantize_lm_params`` of ``params`` (default: the ``meta`` tree)."""
    from repro_torch.quant import quantize_lm_params

    qparams = quantize_lm_params(abstract_params(cfg) if params is None
                                 else params)

    def shard(qx, psh):
        if not _is_qleaf(qx):
            return psh
        # scales are per-channel over the whole stack (leading dims of 1):
        # replicate — they're O(channels) bytes.
        sspec = (None,) * qx["scale"].ndim
        return {"q": NamedSharding(mesh, tuple(psh.spec)),
                "scale": NamedSharding(mesh, sspec)}

    qsh = tree.map(shard, qparams, params_sh, is_leaf=_is_qleaf)
    return qparams, qsh


def _ep_resident_shardings(params_sh, mesh):
    """Expert weights sharded on E only (weight-stationary EP)."""

    def leaf(path, sh):
        parts = path.split("/")
        if len(parts) >= 2 and parts[-2] == "moe" and \
                parts[-1] in ("wi", "wg", "wo"):
            spec = list(sh.spec)
            nd = len(spec)
            new = [None] * nd
            new[nd - 3] = spec[nd - 3]  # keep the expert axis only
            return NamedSharding(mesh, tuple(new))
        return sh

    return tree.map_with_path(leaf, params_sh)
