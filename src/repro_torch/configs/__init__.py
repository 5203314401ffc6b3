"""Model configs: the dense, MoE, hybrid and SSM LM architectures the
port serves (:mod:`repro_torch.configs.registry`) and the paper's three
NeRF model configs (:mod:`repro_torch.configs.cicero_nerf`)."""
