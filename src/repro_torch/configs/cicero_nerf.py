"""The paper's own three NeRF model configs (DVGO / Instant-NGP / TensoRF)
and the SpaRW pipeline defaults, value for value as the reference's
``repro.configs.cicero_nerf``.

    from repro_torch.configs.cicero_nerf import NERF_CONFIGS
    cfg = dataclasses.replace(NERF_CONFIGS["cicero-ngp"], backend="streaming")
    model = NerfModel(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cuda")
"""
from dataclasses import dataclass
from typing import Optional

from repro_torch.nerf.models import NerfConfig


@dataclass(frozen=True)
class CiceroPipelineCfg:
    window: int = 16  # warping window (Fig. 22 sweeps 1..31)
    phi_deg: Optional[float] = None  # warp-angle threshold (Fig. 26: 1..16)
    mvoxel_edge: int = 8  # 8^3-point MVoxels (paper section V)
    rit_capacity: int = 512


# full-scale configs (the paper's widths: 800x800 frames, 192 samples)
DVGO = NerfConfig(kind="dvgo", grid_res=160, channels=12, decoder="mlp",
                  mlp_hidden=64, num_samples=192)
NGP = NerfConfig(kind="ngp", hash_levels=8, hash_table_size=2**19,
                 hash_base_res=16, hash_max_res=1024, decoder="mlp",
                 mlp_hidden=64, num_samples=192)
TENSORF = NerfConfig(kind="tensorf", grid_res=300, tensorf_rank=48,
                     channels=27, decoder="mlp", mlp_hidden=64,
                     num_samples=192)

# bench-scale configs (CPU-measurable quality experiments)
DVGO_BENCH = NerfConfig(kind="dvgo", grid_res=64, channels=4,
                        decoder="direct", num_samples=64)
NGP_BENCH = NerfConfig(kind="ngp", hash_levels=6, hash_table_size=2**14,
                       hash_base_res=8, hash_max_res=128, decoder="mlp",
                       mlp_hidden=32, num_samples=64)
TENSORF_BENCH = NerfConfig(kind="tensorf", grid_res=64, tensorf_rank=8,
                           channels=8, decoder="mlp", mlp_hidden=32,
                           num_samples=64)

NERF_CONFIGS = {
    "cicero-dvgo": DVGO,
    "cicero-ngp": NGP,
    "cicero-tensorf": TENSORF,
}
NERF_BENCH_CONFIGS = {
    "cicero-dvgo": DVGO_BENCH,
    "cicero-ngp": NGP_BENCH,
    "cicero-tensorf": TENSORF_BENCH,
}
