"""NeRF primitives: rays, scenes, the dense, hash and VM grids, decoder,
volume rendering, the models over them, and their training."""
from repro_torch.nerf import grids, mlp, models, rays, scenes, train, volrend

__all__ = ["grids", "mlp", "models", "rays", "scenes", "train", "volrend"]
