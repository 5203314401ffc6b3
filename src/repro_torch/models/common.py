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

import contextlib
from typing import Any, Iterator, Sequence

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


def mesh_axis_sizes(mesh) -> dict:
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
    sizes = mesh_axis_sizes(mesh)
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


_MESH = None


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator:
    """Make ``mesh`` (a ``DeviceMesh``) the mesh in context for the body of
    the ``with``: the twin of the reference's ``jax.set_mesh(mesh)`` /
    ``with mesh:``. The previous mesh (default: none) comes back after.
    Inside, a plain tensor that meets a DTensor in an op (a position
    ``arange``, a mask, a zero accumulator) counts as replicated
    (``implicit_replication``), as a constant does under GSPMD."""
    global _MESH
    previous, _MESH = _MESH, mesh
    try:
        if mesh is None:
            yield mesh
        else:
            from torch.distributed.tensor.experimental import \
                implicit_replication

            with implicit_replication():
                yield mesh
    finally:
        _MESH = previous


def current_mesh():
    """The mesh in context (:func:`use_mesh`), or None: the twin of the
    reference's ``current_abstract_mesh`` (None for its ``.empty``)."""
    return _MESH


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def shard(x: torch.Tensor, spec: P) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` guard. Without a mesh
    in context: ``x``. Under a mesh, a DTensor ``x`` is redistributed to
    ``spec`` guarded on the mesh (its strategy remap, missing axes dropped,
    size-1 dims replicated, and, unlike the reference's GSPMD, which pads
    an uneven split, a dim its axes do not divide replicated too: DTensor
    cannot flatten or view an uneven split), as DTensor placements; a
    plain tensor (a rank's
    block inside an explicit local region, such as MoE's expert-parallel
    branch) passes through unchanged. Redistribution is differentiable:
    the gradient comes back in ``x``'s placements."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    from repro_torch.parallel.sharding import placements

    return x.redistribute(mesh, placements(
        guard_spec(spec, x.shape, mesh, strict=True), mesh))


def whole_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """A DTensor projection ``[B, S, heads * D]`` whose feature dim is split
    in blocks that do not hold whole heads (``heads`` not a multiple of the
    split) gathered along that dim, so that it can be viewed per head;
    anything else as it is. GSPMD pads such a split instead; DTensor
    cannot view one."""
    if not is_dtensor(t):
        return t
    n = 1
    for m, p in enumerate(t.placements):
        if p.is_shard(t.dim() - 1):
            n *= t.device_mesh.size(m)
    if heads % n == 0:
        return t
    from torch.distributed.tensor import Replicate

    return t.redistribute(placements=[Replicate() if p.is_shard(t.dim() - 1)
                                      else p for p in t.placements])


def blockwise(fn, t: torch.Tensor) -> torch.Tensor:
    """``fn(t)`` for an elementwise ``fn``; a DTensor ``t`` on each rank's
    block, laid out as ``t`` (for an op DTensor has no rule for, such as
    ``logsigmoid``'s backward)."""
    if not is_dtensor(t):
        return fn(t)
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(fn(t.to_local()), t.device_mesh, t.placements,
                              run_check=False, shape=t.shape,
                              stride=t.stride())


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
