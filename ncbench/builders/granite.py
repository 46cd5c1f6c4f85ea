"""Granite 4.0-H Small served by ``repro_torch``'s ``ServingEngine``.

The configuration file holds the published ``config.json`` (with the held
experts' count in ``num_local_experts``); :func:`model_config` reads the
program's ``MixedLayerConfig`` from it.  The weights are drawn here from
the seed, in the plain reference's names and layout, and copied into the
program's stacked leaves through one layout adapter
(:func:`program_layer`); the reference keeps its own copy.

A request is a prompt of seeded random ids and a continuation of seeded
tokens, fed through the cache in place of the model's argmax; the answer
is the logits kept at the check's ``steps`` (0: the prefill's last
position, k: decode step k).  A drawn batch is one int64 tensor ``[n,
2 + S + prompt_max + continuation]`` on the device, one row a request:
the prompt's length P, the number S of steps kept and the S steps, then
the prompt and the continuation, then -1.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def model_config(cfg: dict):
    """The program's configuration for the configuration file ``cfg``."""
    from repro_torch.configs.base import MixedLayerConfig

    d, heads = int(cfg["hidden_size"]), int(cfg["num_attention_heads"])
    expand, p = int(cfg["mamba_expand"]), int(cfg["mamba_d_head"])
    if (int(cfg["mamba_n_heads"]) * p != expand * d
            or int(cfg["mamba_n_groups"]) != 1 or not cfg["mamba_conv_bias"]
            or cfg["mamba_proj_bias"] or cfg["attention_bias"]
            or cfg["hidden_act"] != "silu" or not cfg["tie_word_embeddings"]
            or cfg["normalization_function"] != "rmsnorm"):
        raise ValueError("a Granite layout the program does not build")
    return MixedLayerConfig(
        name=cfg["arch"], family="hybrid",
        n_layers=int(cfg["num_hidden_layers"]), d_model=d, n_heads=heads,
        n_kv_heads=int(cfg["num_key_value_heads"]), head_dim=d // heads,
        d_ff=int(cfg["intermediate_size"]),
        vocab_size=int(cfg["vocab_size"]), tie_embeddings=True,
        n_experts=int(cfg["experts_published"]),
        top_k=int(cfg["num_experts_per_tok"]), moe_impl="dropless",
        ssm_state=int(cfg["mamba_d_state"]), ssm_expand=expand,
        ssm_head_dim=p, ssm_conv=int(cfg["mamba_d_conv"]),
        ssm_chunk=int(cfg["mamba_chunk_size"]),
        layer_types=tuple(cfg["layer_types"]),
        shared_ff=int(cfg["shared_intermediate_size"]),
        experts_held=int(cfg["num_local_experts"]),
        expert_share=int(cfg["expert_share"]),
        embedding_multiplier=float(cfg["embedding_multiplier"]),
        residual_multiplier=float(cfg["residual_multiplier"]),
        attention_multiplier=float(cfg["attention_multiplier"]),
        logits_scaling=float(cfg["logits_scaling"]),
        position_embedding=cfg["position_embedding_type"],
        norm_eps=float(cfg["rms_norm_eps"]), dtype=cfg["dtype"])


def _draw_layer(cfg: dict, kind: str, gen: torch.Generator,
                device: torch.device) -> dict:
    """One layer's weights, drawn from ``gen`` in the reference's names and
    layout (``x @ W``; Mamba-2: ``in_proj``, ``conv_weight`` [C, K],
    ``conv_bias``, ``dt_bias``, ``A_log``, ``D``, ``norm``, ``out_proj``;
    attention: ``q``, ``k``, ``v``, ``o``; the two norms, the router, the
    held experts and the shared expert, each ``gate``, ``up``, ``down``).
    Matrices are normal / sqrt(fan in), the convolution uniform in +-1 /
    sqrt(d_conv) and ``dt_bias``, ``A_log`` as Mamba-2 initializes them;
    norms and ``D`` are 1 + 0.1 normal, so that a term left out shows.
    Kept as the deployment holds them: the router and ``dt_bias``,
    ``A_log``, ``D`` in float32, the rest in ``cfg["dtype"]``."""
    wt, f32 = getattr(torch, cfg["dtype"]), torch.float32
    d = int(cfg["hidden_size"])

    def normal(*shape, fan_in: int, dtype=wt):
        w = torch.randn(shape, generator=gen, dtype=f32, device=device)
        return (w / fan_in ** 0.5).to(dtype)

    def uniform(*shape, lo: float, hi: float):
        return torch.empty(shape, dtype=f32, device=device).uniform_(
            lo, hi, generator=gen)

    def near_one(n: int, dtype=wt):
        return (1 + 0.1 * torch.randn(n, generator=gen, dtype=f32,
                                      device=device)).to(dtype)

    lp = {"kind": kind, "input_norm": near_one(d), "post_norm": near_one(d)}
    if kind == "mamba":
        nh, P = int(cfg["mamba_n_heads"]), int(cfg["mamba_d_head"])
        N, K = int(cfg["mamba_d_state"]), int(cfg["mamba_d_conv"])
        di, b = nh * P, K ** -0.5
        dt = torch.exp(uniform(nh, lo=math.log(1e-3), hi=math.log(1e-1)))
        lp.update(in_proj=normal(d, 2 * di + 2 * N + nh, fan_in=d),
                  conv_weight=uniform(di + 2 * N, K, lo=-b, hi=b).to(wt),
                  conv_bias=uniform(di + 2 * N, lo=-b, hi=b).to(wt),
                  dt_bias=dt + torch.log(-torch.expm1(-dt)),  # softplus^-1
                  A_log=torch.log(uniform(nh, lo=1.0, hi=16.0)),
                  D=near_one(nh, f32), norm=near_one(di),
                  out_proj=normal(di, d, fan_in=di))
    else:
        H, Hkv = int(cfg["num_attention_heads"]), int(
            cfg["num_key_value_heads"])
        hd = d // H
        lp.update(q=normal(d, H * hd, fan_in=d), k=normal(d, Hkv * hd, fan_in=d),
                  v=normal(d, Hkv * hd, fan_in=d),
                  o=normal(H * hd, d, fan_in=H * hd))
    held, ff = int(cfg["num_local_experts"]), int(cfg["intermediate_size"])
    sff = int(cfg["shared_intermediate_size"])
    lp.update(router=normal(d, int(cfg["experts_published"]), fan_in=d,
                            dtype=f32),
              experts={"gate": normal(held, d, ff, fan_in=d),
                       "up": normal(held, d, ff, fan_in=d),
                       "down": normal(held, ff, d, fan_in=ff)},
              first_expert=int(cfg["expert_share"]) * held,
              shared={"gate": normal(d, sff, fan_in=d),
                      "up": normal(d, sff, fan_in=d),
                      "down": normal(sff, d, fan_in=sff)})
    return lp


def program_layer(lp: dict) -> dict:
    """The layout adapter: one layer of the reference's weights ``lp`` in
    the program's names (``models/transformer.py``'s layer tree), as
    views."""
    out = {"norm1": {"w": lp["input_norm"]}, "norm2": {"w": lp["post_norm"]}}
    if lp["kind"] == "mamba":
        out["ssm"] = {"in_proj": lp["in_proj"], "conv_w": lp["conv_weight"].T,
                      "conv_b": lp["conv_bias"], "A_log": lp["A_log"],
                      "D": lp["D"], "dt_bias": lp["dt_bias"],
                      "norm_w": lp["norm"], "out_proj": lp["out_proj"]}
    else:
        out["attn"] = {"wq": lp["q"], "wk": lp["k"], "wv": lp["v"],
                       "wo": lp["o"]}
    ex, sh = lp["experts"], lp["shared"]
    out["moe"] = {"router": lp["router"], "wi": ex["up"], "wg": ex["gate"],
                  "wo": ex["down"]}
    out["shared"] = {"wi": sh["up"], "wg": sh["gate"], "wo": sh["down"]}
    return out


def _stacked(layer: dict, n: int, device) -> dict:
    """Empty leaves ``[n, ...]`` for a stage of ``n`` layers like
    ``layer``."""
    return {k: (_stacked(v, n, device) if isinstance(v, dict) else
                torch.empty((n,) + tuple(v.shape), dtype=v.dtype,
                            device=device))
            for k, v in layer.items()}


def _copy_slot(stacked: dict, layer: dict, i: int) -> None:
    for k, v in layer.items():
        if isinstance(v, dict):
            _copy_slot(stacked[k], v, i)
        else:
            stacked[k][i].copy_(v)


def make_params(cfg: dict, gen: torch.Generator, device: torch.device):
    """The seeded weights, drawn here in the reference's layout: the
    embedding (times 0.02), each layer (:func:`_draw_layer`) and the final
    norm, in that order from ``gen``.  Each layer is copied into the
    program's stacked leaves on ``device`` (``"program"``, through
    :func:`program_layer`) and kept for the reference (``"embed"``,
    ``"final_norm"``, ``"layers"``) on the host, where the plain reference
    takes each layer to the device in its turn."""
    from repro_torch.models.transformer import plan_stages

    mcfg = model_config(cfg)
    host = torch.device("cpu")
    wt, f32 = getattr(torch, cfg["dtype"]), torch.float32
    d, V = int(cfg["hidden_size"]), int(cfg["vocab_size"])
    embed = (torch.randn((V, d), generator=gen, dtype=f32, device=device)
             * 0.02).to(wt)
    stages, layers = [], []
    for st in plan_stages(mcfg):
        stacked = None
        for i in range(st.length):
            lp = _draw_layer(cfg, st.kind, gen, device)
            if stacked is None:
                stacked = _stacked(program_layer(lp), st.length, device)
            _copy_slot(stacked, program_layer(lp), i)
            layers.append(_to(lp, host))
            del lp
        stages.append(stacked)
    final = (1 + 0.1 * torch.randn(d, generator=gen, dtype=f32,
                                   device=device)).to(wt)
    program = {"embed": embed.clone(), "stages": stages,
               "final_norm": {"w": final.clone()}}
    return {"program": program, "embed": embed.to(host),
            "final_norm": final.to(host), "layers": layers}


def _to(tree: dict, device) -> dict:
    return {k: (_to(v, device) if isinstance(v, dict) else
                v.to(device) if isinstance(v, torch.Tensor) else v)
            for k, v in tree.items()}


def split_row(row: list) -> tuple[int, list, list]:
    """``(P, steps, tokens)`` of one request's row (a list): the prompt's
    length, the steps whose logits are kept, the prompt and continuation."""
    n, s = row[0], row[1]
    return n, row[2:2 + s], [t for t in row[2 + s:] if t >= 0]


def make_images(cfg: dict, n: int, gen: torch.Generator,
                device: torch.device) -> torch.Tensor:
    """``n`` requests of the cell's traffic (``cfg["traffic"]``), drawn on
    the device, keeping the check's ``steps``: int64 rows (module
    docstring)."""
    t = cfg["traffic"]
    lo, hi, cont = int(t["prompt_min"]), int(t["prompt_max"]), int(
        t["continuation"])
    lengths = torch.empty(n, dtype=torch.float32, device=device).log_normal_(
        float(np.log(t["prompt_median"])), float(t["prompt_sigma"]),
        generator=gen)
    lengths = lengths.round().clamp(lo, hi).to(torch.int64)
    ids = torch.randint(0, int(cfg["vocab_size"]), (n, hi + cont),
                        generator=gen, device=device)
    # the continuation follows each prompt directly: ids past P + cont are
    # padding
    col = torch.arange(hi + cont, device=device)
    ids = torch.where(col[None, :] < lengths[:, None] + cont, ids, -1)
    steps = [int(k) for k in cfg["check"]["steps"]]
    head = torch.tensor([len(steps)] + steps, dtype=torch.int64,
                        device=device).expand(n, -1)
    return torch.cat([lengths[:, None], head, ids], dim=1)


class _Drain:
    """The client of one batch: submits its requests to the engine and
    steps it until every one is answered (prefills, then decode steps of
    the whole batch, each slot at its own position)."""

    def __init__(self, engine):
        self.engine = engine

    def submit(self, req) -> None:
        self.engine.submit(req)

    def step(self) -> bool:
        self.engine.run()
        return True


def build_engine(params, cfg: dict, traffic: dict, device: torch.device):
    """``ServingEngine`` over the program's weights, ``max_batch`` the
    traffic's batch and ``max_len`` the longest prompt with its
    continuation.  The harness hands the request generator the
    configuration alone, so the cell's traffic is recorded in it here."""
    from repro_torch.launch.serve import ServingEngine

    cfg["traffic"] = dict(traffic)
    if device.type == "cuda":
        from repro_torch.kernels import cuda_build
        cuda_build.build("flash_attention")
    max_len = int(traffic["prompt_max"]) + int(traffic["continuation"]) + 1
    return _Drain(ServingEngine(model_config(cfg), params["program"],
                                max_batch=int(traffic["batch"]),
                                max_len=max_len, device=device))


def request(rid: int, row: torch.Tensor):
    """The request of one drawn row: its prompt, and its continuation fed
    in place of the model's argmax, keeping the logits of the row's
    steps."""
    from repro_torch.launch.serve import Request

    n, steps, toks = split_row(row.tolist())
    return Request(rid=rid, prompt=np.asarray(toks[:n], np.int32),
                   forced=np.asarray(toks[n:], np.int32),
                   max_tokens=len(toks) - n + 1, keep=tuple(steps))


def collect(engine, batch):
    """The answers of a served batch: ``(ok, logits [steps, V])`` per
    request, ``ok`` unless it failed or a kept step is missing.  The
    engine's completed list is emptied and the requests' tokens let go."""
    engine.engine.completed.clear()
    out = []
    for r in batch:
        ok = not r.failed and all(k in r.kept for k in r.keep)
        out.append((ok, torch.stack([r.kept[k] for k in r.keep])
                    if ok else None))
        r.prompt = r.forced = None
        r.kept = {}
    return out


def launches() -> int:
    """Kernel 4's launches so far (the program's own counter)."""
    from repro_torch.kernels import flash_attention

    return flash_attention.flash_attention.launches


# nothing wrapped: the program's own spans (``repro_torch.tracing``) are
# read instead, and a wrapper's syncs would pace the decode
SPANS = ()
