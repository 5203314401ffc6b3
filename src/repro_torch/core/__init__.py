"""SpaRW core: config, warping, schedule, flat ray batches, the engine, and
the paper's numpy statistics (cost model, SRAM layout, streaming traffic)."""
from repro_torch.core import (config, costmodel, engine, layout, pipeline,
                              schedule, sparw, streaming)
from repro_torch.core.config import (  # noqa: F401
    RenderConfig,
    RenderRequest,
    RenderResult,
    RenderStats,
    ShardConfig,
)

__all__ = ["config", "costmodel", "engine", "layout", "pipeline", "schedule",
           "sparw", "streaming", "RenderConfig", "RenderRequest",
           "RenderResult", "RenderStats", "ShardConfig"]
