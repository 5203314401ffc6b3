"""Launch helpers (port of ``repro.launch`` without its dry-run
compiler): the production and smoke device meshes."""
from repro_torch.launch import mesh

__all__ = ["mesh"]
