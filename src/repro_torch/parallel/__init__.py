"""The port's multi-device layer over ``torch.distributed`` (port of
``repro.parallel`` without its sharding strategies): the process-group
helpers (:mod:`~repro_torch.parallel.dist`), gradient compression,
sequence-sharded decode attention and gpipe pipelining."""
from repro_torch.parallel import compression, decode_attention, dist, \
    pipeline

__all__ = ["compression", "decode_attention", "dist", "pipeline"]
