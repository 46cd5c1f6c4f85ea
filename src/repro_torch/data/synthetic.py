"""Deterministic synthetic LM data pipeline (the port of
``repro.data.synthetic``).

  * **Deterministic**: batch ``i`` is a pure function of (seed, i, host):
    the numpy stream is the reference's, so tokens and labels are
    byte-equal to its batches and a restart at step N reproduces them.
  * **Shard-aware**: each data-parallel host materializes only its slice
    of the global batch (``host_id``/``num_hosts``), or every rank of a
    mesh lays the global batch out as a DTensor (``DataIterator``'s
    ``sharding``).
  * **Checkpointable**: the iterator's state is one integer
    (``next_index``); it rides inside the training checkpoint, so resume
    never replays or skips a batch.

The token stream mixes Zipf-distributed unigrams with repeated-motif
spans, a non-trivial but learnable distribution.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["SyntheticLMDataset", "DataIterator"]


@dataclasses.dataclass(frozen=True)
class SyntheticLMDataset:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    motif_len: int = 16
    motif_prob: float = 0.5

    def _rng(self, index: int, host: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, index, host]))

    def host_batch(self, index: int, host_id: int = 0,
                   num_hosts: int = 1) -> dict[str, np.ndarray]:
        """The (host-local) slice of global batch ``index``."""
        if self.global_batch % num_hosts:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split over {num_hosts} hosts")
        b = self.global_batch // num_hosts
        rng = self._rng(index, host_id)
        v = self.vocab_size
        # Zipf unigrams (clipped to vocab)
        toks = rng.zipf(self.zipf_a, size=(b, self.seq_len + 1)).astype(
            np.int64)
        toks = (toks - 1) % max(v - 2, 1) + 2  # reserve 0=pad, 1=bos
        # overwrite random spans with repeated motifs (learnable structure)
        n_spans = max(1, self.seq_len // (4 * self.motif_len))
        for row in range(b):
            if (rng.random() > self.motif_prob
                    or self.seq_len <= self.motif_len):
                continue
            for _ in range(n_spans):
                start = int(rng.integers(0, self.seq_len - self.motif_len))
                motif = rng.integers(2, v, size=self.motif_len // 4)
                span = np.tile(motif, 4)[: self.motif_len]
                toks[row, start: start + self.motif_len] = span
        toks[:, 0] = 1  # bos
        tokens = toks[:, :-1].astype(np.int32)
        labels = toks[:, 1:].astype(np.int32)
        return {"tokens": tokens, "labels": labels}

    def global_arrays(self, index: int,
                      device: str | torch.device | None = None,
                      sharding=None) -> dict[str, torch.Tensor]:
        """Global batch ``index`` as int32 tensors on ``device`` (default
        ``"cuda"``); given a ``sharding``
        (:func:`repro_torch.distributed.sharding.make_batch_sharding`), as
        DTensors laid out by it."""
        dev = resolve_device(device)
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in self.host_batch(index).items()}
        if sharding is not None:
            from repro_torch.distributed.sharding import distribute

            batch = {k: distribute(v, sharding) for k, v in batch.items()}
        return batch


@dataclasses.dataclass
class DataIterator:
    """Stateful wrapper whose state is checkpointable (one int).  Given a
    ``sharding`` (:func:`repro_torch.distributed.sharding.make_batch_sharding`)
    each global batch is placed as a DTensor laid out by it: every rank
    builds the same global batch and keeps its shard."""

    dataset: SyntheticLMDataset
    device: str | torch.device | None = None
    next_index: int = 0
    sharding: object = None

    def __next__(self):
        batch = self.dataset.global_arrays(self.next_index, self.device,
                                           self.sharding)
        self.next_index += 1
        return batch

    def __iter__(self):
        return self

    # -- checkpoint protocol ------------------------------------------------
    def state_dict(self) -> dict:
        return {"next_index": self.next_index}

    def load_state_dict(self, state: dict) -> None:
        self.next_index = int(state["next_index"])
