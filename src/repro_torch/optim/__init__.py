"""Optimizer and gradient compression (the port of ``repro.optim``)."""
from repro_torch.optim.adamw import (AdamW, adamw, apply_updates,
                                     cosine_schedule)
from repro_torch.optim.compression import (compress_gradients,
                                           error_feedback_update)

__all__ = ["AdamW", "adamw", "apply_updates", "cosine_schedule",
           "compress_gradients", "error_feedback_update"]
