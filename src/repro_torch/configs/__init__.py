"""LM model configs: the dense, full-attention architectures the port
serves (:mod:`repro_torch.configs.registry`)."""
