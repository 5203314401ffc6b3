"""Model configs: the dense and MoE LM architectures the port
serves (:mod:`repro_torch.configs.registry`) and the paper's three NeRF
model configs (:mod:`repro_torch.configs.cicero_nerf`)."""
