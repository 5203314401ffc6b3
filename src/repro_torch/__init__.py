"""repro_torch — the PyTorch/CUDA port of :mod:`repro` (the JAX/Pallas
reference, which stays beside it unchanged).

The port grows slice by slice. It holds the staged and fused SpaRW +
MVoxel-streaming render paths (``repro_torch.api.make_renderer(...)
.render``) for the paper's three model families (dense, hash and VM
grids) and the analytic oracle, the multi-session render serving engine
(``.serve``; multi-scene with ``RenderServeEngine(...,
scene_loader=...)``), and the LM
substrate's serving path (``repro_torch.serve.ServeEngine`` over the
dense GQA transformer of :mod:`repro_torch.models`, configs in
:mod:`repro_torch.configs`); the render path's session sharding over
``torch.distributed`` ranks (``RenderConfig.shard``) and the reference's
multi-device helpers (:mod:`repro_torch.parallel`,
:mod:`repro_torch.launch`), with the mesh context that binds the LM's
activation constraints and MoE's expert-parallel branch, and the dry-run
launcher with its roofline report (:mod:`repro_torch.launch.dryrun`,
:mod:`repro_torch.roofline`). Every TPU kernel of the reference has a
hand-written CUDA kernel here: the Gathering Unit and its mixed-scene
variant (:mod:`repro_torch.kernels.gather_trilerp`), the fused radiance
MLP (:mod:`repro_torch.kernels.fused_nerf_mlp`), the fused tick's
one-sweep dual gather and its mixed-scene variant
(:mod:`repro_torch.kernels.streaming_pipeline`) and flash attention
(:mod:`repro_torch.kernels.flash_attention`). It imports ``torch``,
numpy and the standard library only — never ``jax`` and never ``repro``.
"""
