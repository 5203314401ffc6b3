"""Architecture registry of the port (port of ``repro.configs.registry``).

All ten of the reference's architectures; their ``CONFIG`` and
``REDUCED`` are the reference's, value for value. ``list_archs``,
``runnable_cells`` and ``skipped_cells`` are the reference's accounting of
the (arch, shape) cells its dry-run launcher visits, pure functions of the
configs and of ``base.SHAPES``; the launcher itself is ROADMAP.md A3c.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.configs import (command_r_35b, deepseek_coder_33b,
                                 internvl2_1b, jamba_1_5_large_398b,
                                 llama4_maverick_400b_a17b, minitron_4b,
                                 moonshot_v1_16b_a3b, qwen2_5_32b,
                                 whisper_small, xlstm_350m)
from repro_torch.configs.base import SHAPES, ModelConfig

# the reference's order, which list_archs and the cells follow
_MODULES = [llama4_maverick_400b_a17b, moonshot_v1_16b_a3b,
            jamba_1_5_large_398b, qwen2_5_32b, command_r_35b, minitron_4b,
            deepseek_coder_33b, xlstm_350m, whisper_small, internvl2_1b]

ARCHS: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}
REDUCED: Dict[str, ModelConfig] = {m.CONFIG.name: m.REDUCED for m in _MODULES}


def get(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def get_reduced(name: str) -> ModelConfig:
    return REDUCED[get(name).name]


def list_archs() -> List[str]:
    return list(ARCHS)


def runnable_cells() -> List[Tuple[str, str]]:
    """All (arch, shape) dry-run cells, honouring per-arch skips."""
    return [(arch, shape) for arch, cfg in ARCHS.items() for shape in SHAPES
            if shape not in cfg.skip_shapes]


def skipped_cells() -> List[Tuple[str, str, str]]:
    return [(arch, shape, "sub-quadratic attention required")
            for arch, cfg in ARCHS.items() for shape in cfg.skip_shapes]
