"""Optimiser and learning-rate schedule (port of ``repro.optim``)."""
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update, \
    adamw_update_
from repro_torch.optim.schedules import cosine_warmup

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "adamw_update_",
           "cosine_warmup"]
