"""Pipeline parallelism over a mesh dimension (port of
``repro.parallel.pipeline``): gpipe.

Each of the dimension's P ranks (stages) holds ``L / P`` of the ``L``
stacked layers, and only those (the reference shards the stacked params
over the axis, ``P(axis)``), and runs them over microbatches; activations
pass from stage to stage around a ring. Schedule (P stages, M microbatches,
T = M + P - 1 ticks): at tick t, stage p runs microbatch ``t - p`` if
``0 <= t - p < M``.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.optim.adamw import tree_flatten
from repro_torch.parallel import dist as pdist

Tree = Any


def _layer(params_stacked: Tree, i: int) -> Tree:
    """Layer ``i``'s slice of a tree of stacked ``[L, ...]`` leaves."""
    leaves, unflatten = tree_flatten(params_stacked)
    return unflatten([p[i] for p in leaves])


def _run_layers(layer_fn: Callable, params_stacked: Tree, x: torch.Tensor,
                lo: int, hi: int) -> torch.Tensor:
    for i in range(lo, hi):
        x = layer_fn(_layer(params_stacked, i), x)
    return x


def stage_block(params_stacked: Tree, mesh, axis: str = "pod") -> Tree:
    """This rank's stage block of a tree of stacked ``[L, ...]`` leaves:
    layers ``[p * L / P, (p + 1) * L / P)`` of each leaf (views), for a
    caller that holds every layer and hands :func:`pipelined_forward` only
    its stage's."""
    ax = pdist.axis(mesh, axis)
    leaves, unflatten = tree_flatten(params_stacked)
    num_layers = leaves[0].shape[0]
    if num_layers % ax.size:
        raise ValueError(f"stage_block: {num_layers} layers over "
                         f"{ax.size} stages must divide evenly")
    per = num_layers // ax.size
    return unflatten([p[ax.rank * per:(ax.rank + 1) * per] for p in leaves])


def pipelined_forward(layer_fn: Callable, params_stage: Tree,
                      x: torch.Tensor, *, mesh, num_microbatches: int,
                      axis: str = "pod") -> torch.Tensor:
    """``layer_fn(params_slice, x) -> x`` over ``L`` stacked layers split
    evenly over the P stages of ``mesh``'s dimension ``axis``.

    Stage p passes only its own block of the stacked params,
    ``params_stage``: each leaf ``[L / P, ...]``, layers ``[p * L / P,
    (p + 1) * L / P)`` of the whole stack (:func:`stage_block` cuts it
    from a whole stack); every stage's blocks hold the same number of
    layers. Every rank passes the whole batch ``x`` ``[B, ...]``,
    microbatched along dim 0. Each tick is one paired send and receive
    around the ring; the last stage's outputs are all-reduced, so every
    rank of the dimension returns them.
    """
    ax = pdist.axis(mesh, axis)
    n_stages, stage = ax.size, ax.rank
    leaves = tree_flatten(params_stage)[0]
    per = leaves[0].shape[0]
    if any(p.shape[0] != per for p in leaves) \
            or x.shape[0] % num_microbatches:
        raise ValueError(
            f"pipelined_forward: a stage's leaves must all hold its "
            f"{per} layers (got {[p.shape[0] for p in leaves]}), and batch "
            f"{x.shape[0]} must split into {num_microbatches} microbatches")
    mbs = x.reshape(num_microbatches, -1, *x.shape[1:])
    cur = torch.zeros_like(mbs[0])
    outs = torch.zeros_like(mbs)
    for t in range(num_microbatches + n_stages - 1):
        if stage == 0 and t < num_microbatches:
            cur = mbs[t]
        if 0 <= t - stage < num_microbatches:
            cur = _run_layers(layer_fn, params_stage, cur, 0, per)
            if stage == n_stages - 1:
                outs[t - stage] = cur
        cur = pdist.ring_exchange(cur, ax.group)
    # only the last stage wrote outputs; the others' stay zero
    return pdist.all_reduce(outs, "sum", ax.group).reshape(x.shape)


def reference_forward(layer_fn: Callable, params_stacked: Tree,
                      x: torch.Tensor) -> torch.Tensor:
    """The oracle: every layer in order over the whole batch."""
    num_layers = tree_flatten(params_stacked)[0][0].shape[0]
    return _run_layers(layer_fn, params_stacked, x, 0, num_layers)
