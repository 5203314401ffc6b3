"""A program's FLOPs, bytes and collective bytes, counted one op at a time
as it runs (the port's twin of ``repro.roofline.hlo_cost``, which parses a
compiled XLA module's HLO).

:func:`analyze` runs a callable under :class:`CostCounter`, a
``TorchDispatchMode``, and returns the keys the reference's walker
returns, for the ops this rank executes:

  flops      - 2 prod(result) prod(contracting) of each matmul-like op
               (``torch.utils.flop_counter``'s formulas; kernel B6's
               operator registers its own, 4 B H Sq Sk D)
  bytes      - the sum over every op executed of its result and operand
               bytes, views included: the walker's HBM-traffic proxy, an
               upper bound (an eager program fuses nothing)
  coll_by_op / coll_counts - the result bytes and the number of each
               collective (``all-gather``, ``all-reduce``,
               ``reduce-scatter``, ``all-to-all``, ``collective-permute``:
               a point-to-point receive), functional or in place
  weighted_coll_bytes - the same bytes ring-weighted, an all-reduce x2
               (a reduce-scatter and an all-gather)
  weighted_coll_bytes_bf16wire - the weighted bytes with their float32
               share halved (the reference's counterfactual wire)

An eager loop executes every trip, so no trip correction is needed (the
walker multiplies each ``while`` body by its trip count). Under DTensor a
dispatch mode sees each op on global shapes first; the counter declines
it (``NotImplemented``), DTensor runs it, and the local ops and the
collectives of its redistributions come back to the counter: it counts
what this rank runs, never the global op, nor the fake-tensor run by which
DTensor infers a global op's output shape. A broadcast has no HLO twin
here and is not counted.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

_COLL_FACTOR = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}
# op name (``namespace::name``) -> collective kind; for the in-place c10d
# ops the bytes are the tensors they write
_COLLECTIVES = {
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::all_reduce_": "all-reduce",
    "_c10d_functional::all_reduce_coalesced": "all-reduce",
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::all_gather_into_tensor_out": "all-gather",
    "_c10d_functional::all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional::reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional::all_to_all_single": "all-to-all",
    "c10d::allreduce_": "all-reduce",
    "c10d::allgather_": "all-gather",
    "c10d::_allgather_base_": "all-gather",
    "c10d::allgather_into_tensor_coalesced_": "all-gather",
    "c10d::reduce_scatter_": "reduce-scatter",
    "c10d::_reduce_scatter_base_": "reduce-scatter",
    "c10d::alltoall_": "all-to-all",
    "c10d::alltoall_base_": "all-to-all",
    "c10d::recv_": "collective-permute",
}
_SKIP = {"_c10d_functional::wait_tensor", "c10d::broadcast_"}


def _tensors(tree) -> list:
    """The tensors of an op's arguments or results (nested lists, tuples
    and dicts)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


class CostCounter(TorchDispatchMode):
    """Counts the ops run inside its ``with`` (see the module docstring);
    :meth:`result` gives the totals in :func:`analyze`'s keys."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.coll: Dict[str, float] = {}
        self.coll_counts: Dict[str, int] = {}
        self.coll_f32 = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat = _tensors((args, kwargs))
        if any(_is_dtensor(t) for t in flat):
            return NotImplemented  # DTensor's; its local ops come back here
        out = func(*args, **kwargs)
        if not any(isinstance(t, FakeTensor) for t in flat):
            # (DTensor infers each global op's output shape on fake tensors)
            self._count(func, args, kwargs, out, flat)
        return out

    def _count(self, func, args, kwargs, out, inputs) -> None:
        name = func._schema.name
        if name in _SKIP:
            return
        kind = _COLLECTIVES.get(name)
        if kind is not None:
            # an in-place c10d op writes its first argument
            written = _tensors(args[0] if name.startswith("c10d::")
                               else out)
            b = _nbytes(written)
            self.coll[kind] = self.coll.get(kind, 0.0) + b
            self.coll_counts[kind] = self.coll_counts.get(kind, 0) + 1
            if any(t.dtype == torch.float32 for t in written):
                self.coll_f32 += b * _COLL_FACTOR[kind]
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        self.bytes += _nbytes(inputs) + _nbytes(_tensors(out))

    def result(self) -> Dict[str, object]:
        weighted = sum(v * _COLL_FACTOR[k] for k, v in self.coll.items())
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "coll_by_op": dict(self.coll),
                "coll_counts": dict(self.coll_counts),
                "weighted_coll_bytes": weighted,
                "coll_f32_weighted": self.coll_f32,
                "weighted_coll_bytes_bf16wire": weighted
                - 0.5 * self.coll_f32}


def measure(fn, *args, **kwargs) -> Tuple[object, Dict[str, object]]:
    """``(fn(*args, **kwargs), its counts)``."""
    with CostCounter() as counter:
        out = fn(*args, **kwargs)
    return out, counter.result()


def analyze(fn, *args, **kwargs) -> Dict[str, object]:
    """The counts of one call ``fn(*args, **kwargs)`` (the twin of the
    reference's ``analyze`` / ``analyze_compiled``)."""
    return measure(fn, *args, **kwargs)[1]


def bytes_moved_per_frame(analysis: Dict[str, object],
                          frames_per_tick: int) -> float:
    """A tick's byte count per rendered frame, the serving unit of the
    paper's memory plots. ``analysis`` is an :func:`analyze` result (or
    any mapping with a ``"bytes"`` entry)."""
    if frames_per_tick <= 0:
        raise ValueError(f"frames_per_tick must be positive, got "
                         f"{frames_per_tick}")
    return float(analysis["bytes"]) / float(frames_per_tick)
