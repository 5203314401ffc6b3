"""LM training: the fault-tolerant Trainer and its checkpoints (port of
``repro.train``)."""
