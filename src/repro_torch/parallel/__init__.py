"""The port's multi-device layer over ``torch.distributed`` (port of
``repro.parallel``): the process-group helpers
(:mod:`~repro_torch.parallel.dist`), gradient compression,
sequence-sharded decode attention, gpipe pipelining and the sharding
strategies with their DTensor placements."""
from repro_torch.parallel import compression, decode_attention, dist, \
    pipeline, sharding

__all__ = ["compression", "decode_attention", "dist", "pipeline",
           "sharding"]
