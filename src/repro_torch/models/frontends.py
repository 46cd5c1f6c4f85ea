"""Stub modality frontends (the port of ``repro.models.frontends``).

The audio and vision families serve their LM backbone only: the real
EnCodec and InternViT towers are out of scope.  ``stub_embeddings`` stands
in for precomputed patch or frame embeddings (a ``vision_patch`` prefill
takes them as ``embeds``), ``stub_tokens`` for EnCodec-style token ids.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device

__all__ = ["stub_embeddings", "stub_tokens"]


def stub_embeddings(cfg: ModelConfig, generator: torch.Generator, batch: int,
                    seq_len: int, *,
                    device: str | torch.device | None = None) -> torch.Tensor:
    """Precomputed patch/frame embeddings stand-in: ``[B, S, d_model]`` in
    ``cfg.dtype`` on ``device`` (default ``"cuda"``), normal x 0.02 drawn in
    float32 from ``generator`` (a generator on that device)."""
    dev = resolve_device(device)
    x = torch.randn((batch, seq_len, cfg.d_model), generator=generator,
                    dtype=torch.float32, device=dev)
    return (x * 0.02).to(cfg.jdtype)


def stub_tokens(cfg: ModelConfig, generator: torch.Generator, batch: int,
                seq_len: int, *,
                device: str | torch.device | None = None) -> torch.Tensor:
    """EnCodec-style token ids: int32 ``[B, S]`` in ``[0, vocab)`` on
    ``device`` (default ``"cuda"``)."""
    dev = resolve_device(device)
    return torch.randint(0, cfg.vocab_size, (batch, seq_len),
                         generator=generator, dtype=torch.int64,
                         device=dev).to(torch.int32)
