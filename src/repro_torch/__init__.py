"""repro_torch — the PyTorch/CUDA port of :mod:`repro` (the JAX/Pallas
reference, which stays beside it unchanged).

The port grows slice by slice; this package holds the staged and fused
SpaRW + MVoxel-streaming render paths
(``repro_torch.api.make_renderer(...).render``) and the multi-session
serving engine (``.serve``; multi-scene with
``RenderServeEngine(..., scene_loader=...)``), with hand-written CUDA
kernels for the Gathering Unit and its mixed-scene variant
(:mod:`repro_torch.kernels.gather_trilerp`), the fused radiance MLP
(:mod:`repro_torch.kernels.fused_nerf_mlp`) and the fused tick's
one-sweep dual gather and its mixed-scene variant
(:mod:`repro_torch.kernels.streaming_pipeline`). It imports ``torch``,
numpy and the standard library only — never ``jax`` and never ``repro``.
"""
