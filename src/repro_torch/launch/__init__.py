"""Launch helpers (port of ``repro.launch``): the production and smoke
device meshes, and the dry-run of every (arch x shape x mesh) cell
(:mod:`repro_torch.launch.dryrun`, run as ``python -m
repro_torch.launch.dryrun``; not imported here, so that importing the
meshes costs nothing)."""
from repro_torch.launch import mesh

__all__ = ["mesh"]
