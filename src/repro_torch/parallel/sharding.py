"""Sharding strategies on the (pod, data, model) production mesh (port of
``repro.parallel.sharding``), and the spec trees laid onto DTensor
placements.

``tp``       Megatron tensor parallelism over ``model``; params replicated
             across ``data``. Right for models up to ~20B.
``tp+fsdp``  ``tp`` plus ZeRO-3-style sharding of every remaining large dim
             over (``pod``, ``data``). Required for the 400B-class archs.
``fsdp``     ZeRO-3 alone: no tensor parallelism, the largest dim of each
             leaf over (``pod``, ``data``, ``model``).

A strategy is a transform of a spec tree (:func:`apply_strategy`), so every
entry point shares it. The reference lays a spec onto its mesh as
``NamedSharding(mesh, guard_spec(spec, shape, mesh, strict=True))``; the
port's twin is :func:`named_sharding`, which maps the guarded spec onto a
``DeviceMesh`` as one DTensor placement per mesh dim: an entry naming mesh
axis ``a`` at tensor dim ``i`` is ``Shard(i)`` on ``a``'s mesh dim, every
other mesh dim ``Replicate()``. An entry of several axes splits its dim
over several mesh dims, the first axis the major one, as DTensor splits a
dim over mesh dims in mesh order; so its axes must come in mesh order.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

from repro_torch.models.common import P, guard_spec, map_specs

Tree = Any

_FSDP_AXES = ("pod", "data")


def _add_fsdp(spec: P, shape) -> P:
    """Shard the largest still-unsharded dim of at least 256 over
    (``pod``, ``data``), unless the spec uses either axis already."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    used = set()
    for e in entries:
        for a in (e if isinstance(e, (tuple, list)) else (e,)):
            if a:
                used.add(a)
    if any(a in used for a in _FSDP_AXES):
        return spec
    # the largest unsharded dim (the first of equals), with headroom so that
    # the strict guard keeps it on the real mesh
    best, best_size = None, 0
    for i, (e, dim) in enumerate(zip(entries, shape)):
        if e is None and dim > best_size and dim >= 256:
            best, best_size = i, dim
    if best is None:
        return spec
    entries[best] = _FSDP_AXES
    return P(*entries)


def _pure_fsdp(spec: P, shape) -> P:
    """ZeRO-3: no tensor parallelism, the largest dim of at least 256 over
    (``pod``, ``data``, ``model``)."""
    entries = [None] * len(shape)
    best, best_size = None, 0
    for i, dim in enumerate(shape):
        if dim > best_size and dim >= 256:
            best, best_size = i, dim
    if best is not None:
        entries[best] = ("pod", "data", "model")
    return P(*entries)


def apply_strategy(spec_tree: Tree, shape_tree: Tree, strategy: str) -> Tree:
    """``strategy`` applied to every spec of ``spec_tree``; ``shape_tree``
    holds a tensor (a meta one will do) of each leaf's shape."""
    if strategy == "tp":
        return spec_tree
    if strategy == "fsdp":
        rule = _pure_fsdp
    elif strategy == "tp+fsdp":
        rule = _add_fsdp
    else:
        raise ValueError(strategy)
    return map_specs(lambda s, t: rule(s, tuple(t.shape)), spec_tree,
                     shape_tree)


def default_strategy(cfg) -> str:
    """The config's strategy; ``tp`` upgraded to ``tp+fsdp`` when the bf16
    params would exceed ~8 GiB a chip over a 16-way model axis."""
    if cfg.sharding_strategy != "tp":
        return cfg.sharding_strategy
    per_chip = cfg.param_count() * 2 / 16
    return "tp+fsdp" if per_chip > 8 * 2**30 else "tp"


# ---------------------------------------------------------------------------
# the spec trees onto DTensor placements
# ---------------------------------------------------------------------------


def placements(spec: P, mesh) -> Tuple:
    """One DTensor placement per dim of ``mesh`` (a ``DeviceMesh``) for a
    resolved ``spec``: ``Shard(i)`` on the mesh dim of each axis entry
    ``i`` names, ``Replicate()`` on the others. An axis ``mesh`` lacks is
    dropped, as :func:`~repro_torch.models.common.resolve_spec` drops it.
    Raises ``ValueError`` for an axis named twice and for an entry whose
    axes are not in mesh order (DTensor splits a dim over mesh dims in
    mesh order, the first the major one)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        dims = [names.index(a) for a in
                (entry if isinstance(entry, tuple) else (entry,))
                if a in names]
        if dims != sorted(set(dims)):
            raise ValueError(f"spec {spec}: entry {entry!r} must name mesh "
                             f"axes once each, in mesh order {names}")
        for j in dims:
            if out[j] != Replicate():
                raise ValueError(f"spec {spec}: mesh axis {names[j]!r} "
                                 f"shards two dims")
            out[j] = Shard(i)
    return tuple(out)


class NamedSharding(NamedTuple):
    """The port's twin of ``jax.sharding.NamedSharding``: a mesh, the
    guarded spec and its DTensor placements."""

    mesh: Any
    spec: P
    placements: Tuple


def named_sharding(mesh, spec: P, shape, strict: bool = True
                   ) -> NamedSharding:
    """``NamedSharding(mesh, guard_spec(spec, shape, mesh, strict))`` as
    DTensor placements. A dim its axes do not divide (kept only when not
    ``strict``) is split unevenly as GSPMD pads it, each block
    ``ceil(n / k)`` long and the last ones short or empty; DTensor splits a
    dim over several mesh dims one mesh dim at a time, which differs from
    that, so such a dim must name one axis."""
    guarded = guard_spec(spec, shape, mesh, strict=strict)
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    for i, entry in enumerate(guarded):
        axes = entry if isinstance(entry, tuple) else (entry,)
        extent = 1
        for a in axes:
            extent *= sizes.get(a, 1) if a else 1
        if entry is not None and len(axes) > 1 and shape[i] % extent:
            raise ValueError(
                f"dim {i} of {tuple(shape)} is split over {axes} "
                f"({extent} blocks), which do not divide it")
    return NamedSharding(mesh, guarded, placements(guarded, mesh))


def sharding_tree(spec_tree: Tree, shape_tree: Tree, mesh,
                  strict: bool = True) -> Tree:
    """:func:`named_sharding` of every leaf (shapes from ``shape_tree``'s
    tensors)."""
    return map_specs(lambda s, t: named_sharding(mesh, s, tuple(t.shape),
                                                 strict), spec_tree,
                     shape_tree)


def local_block(sharding: NamedSharding, shape) -> Tuple[tuple, tuple]:
    """(shape, offset) of this rank's block of a ``shape`` tensor laid out
    by ``sharding``, as DTensor lays it out."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    local, offset = compute_local_shape_and_global_offset(
        tuple(shape), sharding.mesh, list(sharding.placements))
    return tuple(local), tuple(offset)
