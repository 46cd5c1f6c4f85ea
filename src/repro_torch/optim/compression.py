"""Gradient compression with error feedback (the port of
``repro.optim.compression``).

int8 quantization in blocks of ``QBLOCK`` values with one float32 scale
each, with *error feedback* (Seide et al. / EF-SGD): the quantization
residual is carried into the next step, so the compression bias vanishes
over time.  The compressed form is what would cross the slowest link of an
all-reduce: about 4x fewer bytes than float32.

Usage:
    cg, new_ef = compress_gradients(grads, ef_state)
    grads = decompress(cg, grads)
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import tree
from repro_torch.optim.adamw import _div

__all__ = ["CompressedGrads", "compress_gradients", "decompress",
           "error_feedback_update", "ef_init"]

QBLOCK = 512
_F32 = torch.float32


class CompressedGrads(NamedTuple):
    q: torch.Tensor  # int8 blocks [n_blocks, QBLOCK]
    scale: torch.Tensor  # float32 [n_blocks, 1]


def _is_compressed(x) -> bool:
    return isinstance(x, CompressedGrads)


def _compress_leaf(g: torch.Tensor, ef: torch.Tensor):
    gf = g.to(_F32) + ef
    flat = gf.reshape(-1)
    pad = (-flat.shape[0]) % QBLOCK
    if pad:
        flat = F.pad(flat, (0, pad))
    blocks = flat.reshape(-1, QBLOCK)
    scale = torch.clamp_min(
        _div(torch.amax(torch.abs(blocks), dim=-1, keepdim=True), 127.0),
        1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    recon = (q.to(_F32) * scale).reshape(-1)
    n = gf.numel()
    new_ef = (gf.reshape(-1) - recon[:n]).reshape(g.shape)
    return CompressedGrads(q, scale.to(_F32)), new_ef


def ef_init(params):
    return tree.map(lambda p: torch.zeros(p.shape, dtype=_F32,
                                          device=p.device), params)


def compress_gradients(grads, ef_state):
    """Returns (compressed tree, new error-feedback tree)."""
    leaves, treedef = tree.flatten(grads)
    ef_leaves = tree.leaves(ef_state)
    cs, efs = [], []
    for g, e in zip(leaves, ef_leaves):
        c, ne = _compress_leaf(g, e)
        cs.append(c)
        efs.append(ne)
    return tree.unflatten(treedef, cs), tree.unflatten(treedef, efs)


def decompress(compressed, shapes_like):
    def leaf(c, g):
        flat = (c.q.to(_F32) * c.scale).reshape(-1)
        return flat[:g.numel()].reshape(g.shape).to(g.dtype)

    return tree.map(leaf, compressed, shapes_like, is_leaf=_is_compressed)


def error_feedback_update(grads, ef_state):
    """One combined compress -> decompress round (what a fused collective
    does); returns (effective grads, new ef state)."""
    comp, new_ef = compress_gradients(grads, ef_state)
    eff = decompress(comp, grads)
    return eff, new_ef
