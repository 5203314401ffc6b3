"""Model configs: the dense, full-attention LM architectures the port
serves (:mod:`repro_torch.configs.registry`) and the paper's three NeRF
model configs (:mod:`repro_torch.configs.cicero_nerf`)."""
