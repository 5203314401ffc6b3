"""AdamW with a global-norm clip, float32 moments whatever the params'
dtype (port of ``repro.optim.adamw``).

Functional, as the reference: an update returns new tensors and never
writes the params it was given, so caches keyed on a tensor's identity
(``NerfModel.prepare_streaming``'s halo tables, B2's padded weights) can
never serve values from before the update::

    state = adamw_init(params)
    params, state = adamw_update(grads, params, state, step, cfg, lr)

:func:`adamw_update_` is the same update written into the params and
moments it is given, the port of the reference's LM train step, which
donates them (``donate_argnums``): no second copy of the params, the
moments or a float32 copy of the grads is made, only two float32
temporaries the size of the leaf being updated.

Params, grads and moments are nested dicts and lists of tensors (a NeRF's
``{"tables": [...], "decoder": {...}}``). ``torch.optim.AdamW`` is not
the same update: it has no global-norm clip, decays the weights before
the step instead of adding ``weight_decay * p`` into it, and forms its
bias corrections in double precision.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Tuple

import torch

Tree = Any


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip_norm: float = 1.0


def tree_flatten(tree: Tree) -> Tuple[List[torch.Tensor],
                                      Callable[[List], Tree]]:
    """(leaves, unflatten): the tensors of a nested dict / list / tuple in
    the reference's leaf order (dict keys sorted), and a function that
    puts a list of new leaves back in the same structure."""
    leaves: List[torch.Tensor] = []
    build = _unflattener(tree, leaves)
    return leaves, lambda new: build(iter(new))


def _unflattener(tree: Tree, leaves: List[torch.Tensor]) -> Callable:
    # a module-level recursion: a nested recursive closure would hold
    # ``leaves`` in a reference cycle, keeping every step's tensors alive
    # until the cyclic collector runs
    if isinstance(tree, dict):
        keys = sorted(tree)
        subs = [_unflattener(tree[k], leaves) for k in keys]
        return lambda it: {k: sub(it) for k, sub in zip(keys, subs)}
    if isinstance(tree, (list, tuple)):
        subs = [_unflattener(v, leaves) for v in tree]
        kind = type(tree)
        return lambda it: kind(sub(it) for sub in subs)
    leaves.append(tree)
    return next


def adamw_init(params: Tree) -> dict:
    """Zero first and second moments, float32, shaped as ``params``."""
    leaves, unflatten = tree_flatten(params)
    zeros = lambda: unflatten([torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device) for p in leaves])
    return {"m": zeros(), "v": zeros()}


def _in_param_layouts(grads: List[torch.Tensor],
                      params: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each DTensor grad redistributed to its DTensor param's placements:
    a grad left partial (a replicated param used on each rank's rows) is
    summed there, the data-parallel all-reduce or reduce-scatter. Other
    grads as they are."""
    from repro_torch.models.common import is_dtensor

    return [g.redistribute(p.device_mesh, p.placements)
            if is_dtensor(g) and is_dtensor(p) and g.placements
            != p.placements else g for g, p in zip(grads, params)]


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares,
    summed leaf by leaf in the reference's order."""
    leaves, _ = tree_flatten(tree)
    return torch.sqrt(sum((torch.sum(torch.square(leaf.float()))
                           for leaf in leaves), torch.zeros(())))


def adamw_update(grads: Tree, params: Tree, state: dict, step,
                 cfg: AdamWConfig, lr) -> Tuple[Tree, dict]:
    """One AdamW step at ``step`` (0-based; a Python int or a tensor) with
    learning rate ``lr`` -> (new params, new state), in the reference's
    order of operations: clip by the global norm (when
    ``cfg.grad_clip_norm > 0``), float32 bias corrections ``1 - b**t`` at
    ``t = step + 1``, then ``p - lr * (mhat / (sqrt(vhat) + eps) +
    weight_decay * p)`` cast back to the param's dtype."""
    flat_p, unflatten = tree_flatten(params)
    flat_g, _ = tree_flatten(grads)
    flat_m, _ = tree_flatten(state["m"])
    flat_v, _ = tree_flatten(state["v"])
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError("grads, params and the AdamW state differ in "
                         "structure")
    flat_g = _in_param_layouts(flat_g, flat_p)
    if cfg.grad_clip_norm > 0:
        gnorm = global_norm(flat_g)
        scale = torch.clamp(cfg.grad_clip_norm / (gnorm + 1e-9), max=1.0)
        # the reference's promotion: a low-precision grad scales in float32
        flat_g = [g.to(torch.promote_types(g.dtype, scale.dtype)) * scale
                  for g in flat_g]
    t = torch.as_tensor(step).to(torch.float32) + 1.0
    b1 = torch.tensor(cfg.b1, dtype=torch.float32)
    b2 = torch.tensor(cfg.b2, dtype=torch.float32)
    bc1 = 1.0 - b1**t
    bc2 = 1.0 - b2**t
    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        g32 = g.float()
        m = cfg.b1 * m + (1.0 - cfg.b1) * g32
        v = cfg.b2 * v + (1.0 - cfg.b2) * torch.square(g32)
        mhat = m / bc1
        vhat = v / bc2
        upd = mhat / (torch.sqrt(vhat) + cfg.eps)
        if cfg.weight_decay > 0:
            upd = upd + cfg.weight_decay * p.float()
        new_p.append((p.float() - lr * upd).to(p.dtype))
        new_m.append(m)
        new_v.append(v)
    return unflatten(new_p), {"m": unflatten(new_m), "v": unflatten(new_v)}


def adamw_update_(grads: Tree, params: Tree, state: dict, step,
                  cfg: AdamWConfig, lr) -> None:
    """:func:`adamw_update` in place: each leaf of ``params``,
    ``state["m"]`` and ``state["v"]`` is overwritten with its new value,
    leaf by leaf, with the clip's scale applied per leaf. The same float32
    operations in the same order, so the results are bit-equal to
    :func:`adamw_update`'s. ``grads`` are read, never written. DTensor
    grads are first summed into their params' placements."""
    flat_p, _ = tree_flatten(params)
    flat_g, _ = tree_flatten(grads)
    flat_m, _ = tree_flatten(state["m"])
    flat_v, _ = tree_flatten(state["v"])
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError("grads, params and the AdamW state differ in "
                         "structure")
    flat_g = _in_param_layouts(flat_g, flat_p)
    scale = None
    if cfg.grad_clip_norm > 0:
        gnorm = global_norm(flat_g)
        scale = torch.clamp(cfg.grad_clip_norm / (gnorm + 1e-9), max=1.0)
    t = torch.as_tensor(step).to(torch.float32) + 1.0
    b1 = torch.tensor(cfg.b1, dtype=torch.float32)
    b2 = torch.tensor(cfg.b2, dtype=torch.float32)
    bc1 = 1.0 - b1**t
    bc2 = 1.0 - b2**t
    with torch.no_grad():
        for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
            g32 = g.float() if scale is None else g.float() * scale
            tmp = (1.0 - cfg.b1) * g32
            m.mul_(cfg.b1).add_(tmp)
            torch.square(g32, out=tmp)
            del g32
            v.mul_(cfg.b2).add_(tmp.mul_(1.0 - cfg.b2))
            upd = torch.div(m, bc1)  # mhat
            torch.div(v, bc2, out=tmp)  # vhat
            upd.div_(tmp.sqrt_().add_(cfg.eps))
            if cfg.weight_decay > 0:
                upd.add_(cfg.weight_decay * p.float())
            upd.mul_(lr)
            if p.dtype == torch.float32:
                p.sub_(upd)
            else:
                p.copy_(tmp.copy_(p).sub_(upd))
