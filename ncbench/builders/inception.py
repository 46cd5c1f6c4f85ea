"""Inception v3 served by ``repro_torch``'s ``NCServingEngine``.

The benchmark makes the inputs: float weights drawn on the device from the
seed in one call (He-normal filters, unit BN scale, zero bias, as
``repro_torch.models.inception.init_params`` sets them), pruned by the
configuration's last-k rule, and seeded images in [0, 1).  The plain
reference gets the same weights and images.
"""
from __future__ import annotations

import torch

from ncbench.references import inception as ref


def make_params(cfg: dict, gen: torch.Generator, device: torch.device):
    """Float32 weights ``{name: {"w": [R, S, C, M], "scale", "bias"}}`` on
    ``device``, drawn from ``gen`` in one call; the last
    ``round(M * prune_fraction)`` filters of every convolution are zero."""
    layers = ref.layer_shapes(cfg)
    sizes = [r * s * c * m for _, r, s, c, m, _, _ in layers]
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    prune = float(cfg.get("prune_fraction", 0.0))
    params, at = {}, 0
    for (name, r, s, c, m, _, _), n in zip(layers, sizes):
        w = flat[at:at + n].view(r, s, c, m) * (2.0 / (r * s * c)) ** 0.5
        at += n
        k = int(round(m * prune)) if name != "FullyConnected" else 0
        if k:
            w[..., m - k:] = 0.0
        params[name] = {"w": w,
                        "scale": torch.ones(m, dtype=torch.float32,
                                            device=device),
                        "bias": torch.zeros(m, dtype=torch.float32,
                                            device=device)}
    return params


def make_images(cfg: dict, n: int, gen: torch.Generator,
                device: torch.device) -> torch.Tensor:
    img = int(cfg["img"])
    return torch.rand((n, img, img, 3), generator=gen, device=device,
                      dtype=torch.float32)


def network_config(cfg: dict):
    """The program's ``InceptionConfig`` for ``cfg``."""
    from repro_torch.models import inception

    if cfg.get("mixed", "all") == "all" and int(cfg.get("width_div", 1)) == 1:
        return inception.InceptionConfig(img=int(cfg["img"]),
                                         classes=int(cfg["classes"]))
    stage = {v[0]: k for k, v in inception._STAGE_BLOCKS.items()}
    return inception.reduced_config(
        img=int(cfg["img"]), width_div=int(cfg["width_div"]),
        classes=int(cfg["classes"]),
        stages=tuple(stage[b] for b in cfg["mixed"]))


def engine_params(params, cfg: dict):
    """The weights as the engine is handed them.  With ``"filters":
    "host"`` the float filters and their scales are handed over on the
    host, where the engine quantizes them once, and each forward moves the
    uint8 filters to the card; the biases stay where they were made."""
    if cfg.get("filters", "device") != "host":
        return params
    return {name: dict(p, w=p["w"].cpu(), scale=p["scale"].cpu())
            for name, p in params.items()}


def build_engine(params, cfg: dict, traffic: dict, device: torch.device):
    """The configuration's ``NCServingEngine`` (its own defaults but the
    settings ``cfg["engine"]`` names), batches of ``traffic["batch"]``,
    on the weights placed as ``cfg["filters"]`` says."""
    from repro_torch.core import cache_geometry
    from repro_torch.launch.serve import NCServingEngine

    if device.type == "cuda":
        from repro_torch.kernels import cuda_build
        cuda_build.build("bitserial_gemm")
    return NCServingEngine(
        engine_params(params, cfg), network_config(cfg), max_batch=int(traffic["batch"]),
        geom=getattr(cache_geometry, cfg["geometry"]),
        engine=cfg["backend"], device=device, **cfg.get("engine", {}))


def request(rid: int, image: torch.Tensor):
    from repro_torch.launch.serve import NCRequest

    return NCRequest(rid=rid, image=image)


def collect(engine, batch):
    """The answers of a served batch as a client takes them: ``(ok,
    logits)`` per request, ``ok`` unless it failed or was served degraded.
    The engine's completed list is emptied and the images let go, so that
    nothing of a batch stays once it is answered."""
    engine.completed.clear()
    out = [(not r.failed and r.degraded is None and r.logits is not None,
            r.logits) for r in batch]
    for r in batch:
        r.image = None
    return out


def launches() -> int:
    """Kernel 1's launches so far (the program's own counter)."""
    from repro_torch.kernels import bitserial_matmul

    return bitserial_matmul.bitserial_matmul.launches


# the layers the traced run wraps: span name -> "module:attr"
SPANS = (
    ("forward", "repro_torch.models.inception:nc_forward"),
    ("layer", "repro_torch.core.nc_layers:nc_conv2d"),
    ("minmax", "repro_torch.core.bitserial:bitserial_minmax"),
    ("dot", "repro_torch.core.bitserial:packed_dot_words"),
)
