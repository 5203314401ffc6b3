"""Architecture registry of the port (port of ``repro.configs.registry``).

The dense, MoE, hybrid (jamba) and SSM (xlstm) architectures are ported;
their ``CONFIG`` and ``REDUCED`` are the reference's, value for value.
Asking for one of the reference's other architectures (whisper, internvl)
raises and names the roadmap item. The
reference's dry-run accounting (``list_archs``, ``runnable_cells``,
``skipped_cells``) comes with its launcher (ROADMAP.md A3).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import (command_r_35b, deepseek_coder_33b,
                                 jamba_1_5_large_398b,
                                 llama4_maverick_400b_a17b, minitron_4b,
                                 moonshot_v1_16b_a3b, qwen2_5_32b,
                                 xlstm_350m)
from repro_torch.configs.base import ModelConfig

_MODULES = [llama4_maverick_400b_a17b, jamba_1_5_large_398b,
            moonshot_v1_16b_a3b, qwen2_5_32b, command_r_35b, minitron_4b,
            deepseek_coder_33b, xlstm_350m]

ARCHS: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}
REDUCED: Dict[str, ModelConfig] = {m.CONFIG.name: m.REDUCED for m in _MODULES}

# the reference's architectures that the port does not run yet
NOT_PORTED: Dict[str, str] = {
    "whisper-small": "audio",
    "internvl2-1b": "vlm",
}


def get(name: str) -> ModelConfig:
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} (family {NOT_PORTED[name]}) is not ported; see "
            "ROADMAP.md (A2c: the LM substrate's frontend families)")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def get_reduced(name: str) -> ModelConfig:
    return REDUCED[get(name).name]
