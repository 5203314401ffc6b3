"""Shared LM building blocks: dtypes, the initializer, RMSNorm and the
sharding-spec conventions (port of ``repro.models.common``).

Every ``*_init`` function has a sibling ``*_specs`` that returns a tree
of the same structure whose leaves are :class:`P`, the twin of JAX's
``PartitionSpec``: one entry per tensor dim, each None (replicated), a
mesh axis name or a tuple of names (the dim split over several axes, the
major one first). Mesh axes: ``pod`` / ``data`` carry the batch (data
parallelism), ``model`` carries heads, FFN hidden, vocabulary and experts
(tensor and expert parallelism). The port lays the spec trees onto
``torch.distributed`` meshes as DTensor placements
(:mod:`repro_torch.parallel.sharding`).
"""
from __future__ import annotations

from typing import Any, Sequence

import torch

Tree = Any

# logical -> mesh axis names (pod folds into data for data parallelism)
DP = ("pod", "data")
TP = "model"

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


class P(tuple):
    """A partition spec: a tuple of entries, each None, an axis name or a
    tuple of axis names (``P(("pod", "data"), "model")``). It compares
    equal to the plain tuple of its entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):  # pickle and copy rebuild from the entries
        return tuple(self)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def is_spec(x) -> bool:
    return isinstance(x, P)


def map_specs(fn, specs: Tree, *others: Tree) -> Tree:
    """``fn(spec, *leaves)`` over a spec tree and trees of the same
    structure (dicts, lists, tuples and NamedTuples; a :class:`P` is a
    leaf)."""
    if is_spec(specs):
        return fn(specs, *others)
    if isinstance(specs, dict):
        return {k: map_specs(fn, v, *(o[k] for o in others))
                for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        out = [map_specs(fn, v, *(o[i] for o in others))
               for i, v in enumerate(specs)]
        if isinstance(specs, list):
            return out
        return (type(specs)(*out) if hasattr(specs, "_fields")
                else tuple(out))
    raise TypeError(f"not a spec tree: {type(specs).__name__}")


# --- sharding strategy (set by launchers before they build a program) ----
# "tp" / "tp+fsdp": activations batch-sharded over (pod, data), features and
#                   heads over model (Megatron).
# "fsdp":           ZeRO-3 for dense models: no tensor parallelism; the model
#                   axis joins data parallelism, params sharded over every
#                   axis.
_STRATEGY = "tp"


def set_strategy(name: str) -> None:
    global _STRATEGY
    assert name in ("tp", "tp+fsdp", "fsdp"), name
    _STRATEGY = name


def get_strategy() -> str:
    return _STRATEGY


def _remap_entry(entry):
    """The active strategy applied to one spec entry."""
    if _STRATEGY != "fsdp":
        return entry
    if entry == TP or entry == "model":
        return None  # no tensor parallelism
    if (isinstance(entry, (tuple, list)) and "data" in entry
            and "model" not in entry):
        return tuple(entry) + ("model",)  # the model axis joins DP
    return entry


def resolve_spec(spec: P, axis_names) -> P:
    """The strategy's remap, then every mesh axis ``axis_names`` lacks
    dropped (e.g. ``pod`` on a single-pod mesh), so one spec tree serves
    every mesh."""
    out = []
    for entry in spec:
        entry = _remap_entry(entry)
        if entry is None:
            out.append(None)
        elif isinstance(entry, (tuple, list)):
            kept = tuple(a for a in entry if a in axis_names)
            out.append(kept if kept else None)
        else:
            out.append(entry if entry in axis_names else None)
    return P(*out)


def resolve_tree(tree: Tree, axis_names) -> Tree:
    return map_specs(lambda s: resolve_spec(s, axis_names), tree)


def _axis_sizes(mesh) -> dict:
    """Axis name -> size of a ``DeviceMesh`` (``mesh_dim_names`` and
    ``shape``) or of anything with ``axis_names`` and ``axis_sizes``."""
    names = getattr(mesh, "axis_names", None)
    if names is None:
        return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    return dict(zip(names, tuple(mesh.axis_sizes)))


def guard_spec(spec: P, shape, mesh, strict: bool = False) -> P:
    """:func:`resolve_spec` on ``mesh``'s axes, then the placements that
    cannot help dropped: size-1 dims (e.g. the batch of a one-sequence
    cell). A dim its axes do not divide is kept (an uneven split is cheaper
    than replication) but dropped under ``strict`` (a parameter's layout
    must divide)."""
    sizes = _axis_sizes(mesh)
    spec = resolve_spec(spec, tuple(sizes))
    out = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape) or shape[i] <= 1:
            out.append(None)
            continue
        if strict:
            extent = 1
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                extent *= sizes.get(a, 1)
            if extent == 0 or shape[i] % extent != 0:
                out.append(None)
                continue
        out.append(entry)
    return P(*out)


def current_mesh():
    """The mesh in context: the twin of the reference's
    ``current_abstract_mesh``. The port sets no mesh context yet (the
    dry-run, ROADMAP.md A3c, is its first user), so it returns None."""
    return None


def shard(x: torch.Tensor, spec: P) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` guard: the identity
    when no mesh is in context."""
    if current_mesh() is None:
        return x
    raise NotImplementedError(
        "activation sharding constraints under a mesh context come with "
        "the dry-run (ROADMAP.md A3c)")


def ninit(generator: torch.Generator, shape: Sequence[int], scale: float,
          dtype: torch.dtype) -> torch.Tensor:
    """``scale * N(0, 1)`` drawn in float32 on the generator's device, then
    cast (the reference's rule; the numbers differ from ``jax.random``).
    On the meta device (:data:`META`) only the shape and dtype."""
    if generator.device.type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    x = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (scale * x).to(dtype)


class _MetaDraws:
    """Stands in for a generator on the meta device, where torch has none:
    the inits read only its ``device``, and :func:`ninit` draws nothing
    there."""

    device = torch.device("meta")


META = _MetaDraws()


def rmsnorm_init(d: int, dtype: torch.dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm_specs() -> dict:
    return {"scale": P(None)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """In float32, the scale too, then cast back to ``x``'s dtype."""
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * params["scale"].float()
    return out.to(x.dtype)
