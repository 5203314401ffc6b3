"""Pipeline parallelism over a mesh dimension (port of
``repro.parallel.pipeline``): gpipe.

Each of the dimension's P ranks (stages) holds ``L / P`` of the ``L``
stacked layers and runs them over microbatches; activations pass from
stage to stage around a ring. Schedule (P stages, M microbatches,
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


def pipelined_forward(layer_fn: Callable, params_stacked: Tree,
                      x: torch.Tensor, *, mesh, num_microbatches: int,
                      axis: str = "pod") -> torch.Tensor:
    """``layer_fn(params_slice, x) -> x`` over every stacked layer, the
    layers split evenly over the stages of ``mesh``'s dimension
    ``axis``.

    Every rank passes the whole stacked ``params_stacked`` (leaves
    ``[L, ...]``) and the whole batch ``x`` ``[B, ...]``, microbatched
    along dim 0; stage p runs layers ``[p * L / P, (p + 1) * L / P)``. Each
    tick is one paired send and receive around the ring; the last stage's
    outputs are all-reduced, so every rank of the dimension returns them.
    """
    ax = pdist.axis(mesh, axis)
    n_stages, stage = ax.size, ax.rank
    num_layers = tree_flatten(params_stacked)[0][0].shape[0]
    if num_layers % n_stages or x.shape[0] % num_microbatches:
        raise ValueError(
            f"pipelined_forward: {num_layers} layers over {n_stages} "
            f"stages, batch {x.shape[0]} in {num_microbatches} microbatches "
            f"must both divide evenly")
    per = num_layers // n_stages
    mbs = x.reshape(num_microbatches, -1, *x.shape[1:])
    cur = torch.zeros_like(mbs[0])
    outs = torch.zeros_like(mbs)
    for t in range(num_microbatches + n_stages - 1):
        if stage == 0 and t < num_microbatches:
            cur = mbs[t]
        if 0 <= t - stage < num_microbatches:
            cur = _run_layers(layer_fn, params_stacked, cur, stage * per,
                              (stage + 1) * per)
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
