"""Roofline terms of a step on the H100 (port of ``repro.roofline``):
the report (:mod:`~repro_torch.roofline.analysis`) and the counter of a
program's FLOPs, bytes and collective bytes, one op at a time
(:mod:`~repro_torch.roofline.cost`)."""
from repro_torch.roofline import analysis, cost

__all__ = ["analysis", "cost"]
