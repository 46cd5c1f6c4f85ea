"""Synthetic LM data (the port of ``repro.data``)."""
from repro_torch.data.synthetic import DataIterator, SyntheticLMDataset

__all__ = ["SyntheticLMDataset", "DataIterator"]
