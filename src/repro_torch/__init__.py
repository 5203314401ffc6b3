"""repro_torch — the PyTorch/CUDA port of :mod:`repro` (the JAX/Pallas
reference, which stays beside it unchanged).

The port grows slice by slice; this package holds the staged SpaRW +
MVoxel-streaming render path (``repro_torch.api.make_renderer(...).render``)
with hand-written CUDA kernels for the Gathering Unit
(:mod:`repro_torch.kernels.gather_trilerp`) and the fused radiance MLP
(:mod:`repro_torch.kernels.fused_nerf_mlp`). It imports ``torch``, numpy
and the standard library only — never ``jax`` and never ``repro``.
"""
