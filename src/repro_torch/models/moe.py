"""Mixture-of-Experts with two dispatch modes (port of
``repro.models.moe``).

Dispatch is row-grouped: each batch row is a dispatch group with its own
capacity of ``_row_capacity(cfg, S)`` slots per expert, filled in the
(token, k) pair order; a pair past its expert's capacity is dropped (it
lands on a dump row that is cut off, and the combine zeroes it). So every
scatter and gather stays inside the rows a data-parallel rank holds.

``einsum`` (baseline): the queue position is the cumsum of a one-hot over
the pair order. ``streaming`` (the Cicero tie-in, the MoE analogue of
memory-centric rendering): the pairs are sorted by expert id per row (a
stable sort, the RIT), each expert's block starts where ``searchsorted``
finds it, and a pair's position is its rank in the block. The same
capacity rule gives the same slots, so both modes give the same output.

The expert products are ``torch.einsum`` over ``[B, E, cap, D]``, as the
reference computes them outside any kernel.

Under a mesh (:func:`~repro_torch.models.common.use_mesh`) with a model
axis of ``tp > 1`` ranks and ``dp`` data-parallel ranks (``pod`` x
``data``), the reference's condition ``tp > 1 and E % tp == 0 and B % dp
== 0 and S > 1`` takes the expert-parallel branch, the twin of its
``shard_map``: each rank takes its rows (``x``, the slots, the keep mask
and the gates split over the data axes, replicated over ``model``) and
its ``E / tp`` experts' weights (a DTensor's block, all-gathered over the
data axes where FSDP splits it); it scatters only its own experts' pairs,
runs them, combines locally, casts its partial sum to ``x``'s dtype and
sums it over the model axis. A DTensor ``x`` comes back as a DTensor
split over the data axes and replicated over ``model``. Otherwise the
fallback runs the one-device dispatch; under a mesh its ``xe`` is
constrained to the experts over the model axis. With a DTensor ``x`` the
router, the slots and the combine run on each rank's rows (row-grouped,
as the reference's design allows), the auxiliary loss from the sums of
every rank's expert counts and gates. A plain ``x`` under a mesh is the
same global tensor on every rank (:mod:`repro_torch.parallel.dist`'s
idiom): the branch computes the rank's rows and gathers the output over
the data axes, forward only (a gradient through it raises).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.common import DP, TP, P, current_mesh, guard_spec, \
    is_dtensor, mesh_axis_sizes, ninit, shard

# the leaves ``moe_init`` makes in float32 whatever the model's dtype
FLOAT32_LEAVES = ("router",)


def moe_init(generator: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype) -> dict:
    """The router in float32 whatever ``dtype``; experts ``wg``/``wu``
    ``[E, D, F]`` and ``wd [E, F, D]``; the shared expert's SwiGLU."""
    d, e = cfg.d_model, cfg.moe_num_experts
    f = cfg.moe_d_ff or cfg.d_ff
    p = {"router": ninit(generator, (d, e), d**-0.5, torch.float32),
         "wg": ninit(generator, (e, d, f), d**-0.5, dtype),
         "wu": ninit(generator, (e, d, f), d**-0.5, dtype),
         "wd": ninit(generator, (e, f, d), f**-0.5, dtype)}
    if cfg.moe_shared_expert:
        p["shared"] = ffn_mod.ffn_init(generator, d, f, dtype)
    return p


def moe_specs(cfg: ModelConfig) -> dict:
    """The experts over the model axis (expert parallelism)."""
    p = {"router": P(None, None), "wg": P(TP, None, None),
         "wu": P(TP, None, None), "wd": P(TP, None, None)}
    if cfg.moe_shared_expert:
        p["shared"] = ffn_mod.ffn_specs()
    return p


def _gates(router: torch.Tensor, x: torch.Tensor, cfg: ModelConfig
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(gates [B, S, E] float32, gate [B, S, k] in x's dtype, idx [B, S, k]
    int64): the softmax of the float32 router logits and its top k,
    normalized to sum 1."""
    gates = torch.softmax(x.float() @ router, dim=-1)  # [B, S, E]
    gate, idx = torch.topk(gates, cfg.moe_top_k, dim=-1)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return gates, gate.to(x.dtype), idx


def _expert_counts(idx: torch.Tensor, e: int) -> torch.Tensor:
    """How many (token, k) pairs each of the ``e`` experts got, float32."""
    flat = idx.reshape(-1)
    return torch.zeros((e,), dtype=torch.float32, device=idx.device) \
        .index_add_(0, flat, torch.ones_like(flat, dtype=torch.float32))


def _router(params, x: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing in float32. x [B, S, D] -> (idx [B, S, k] int64,
    gate [B, S, k] in x's dtype, aux): the top-k softmax gates normalized
    to sum 1, and the load-balancing loss ``E * sum(density *
    mean_gate)``."""
    e = cfg.moe_num_experts
    gates, gate, idx = _gates(params["router"], x, cfg)
    density = _expert_counts(idx, e) / idx.numel()
    aux = e * torch.sum(density * gates.mean((0, 1)))
    return idx, gate, aux


def _row_capacity(cfg: ModelConfig, s: int) -> int:
    cap = int(cfg.capacity_factor * s * cfg.moe_top_k / cfg.moe_num_experts)
    return max(8, -(-cap // 8) * 8)


def _expert_ffn(params, xe: torch.Tensor) -> torch.Tensor:
    """xe [B, E, cap, D] -> same, through each expert's SwiGLU."""
    h = torch.nn.functional.silu(torch.einsum("becd,edf->becf", xe,
                                              params["wg"]))
    h = h * torch.einsum("becd,edf->becf", xe, params["wu"])
    return torch.einsum("becf,efd->becd", h, params["wd"])


def _scatter(x: torch.Tensor, slots: torch.Tensor, src_token: torch.Tensor,
             n_slots: int) -> torch.Tensor:
    """Row-local dispatch: ``x [b, S, D]``'s token ``src_token[j]`` into
    slot ``slots[:, j]`` of ``[b, n_slots + 1, D]`` (slot ``n_slots`` is the
    dump row), the dump row cut off."""
    b, _, d = x.shape
    rows = torch.arange(b, device=x.device)[:, None]
    xe = torch.zeros((b, n_slots + 1, d), dtype=x.dtype, device=x.device)
    xe[rows, slots] = x[:, src_token]
    return xe[:, :-1]


def _combine(ye: torch.Tensor, slots: torch.Tensor, keep: torch.Tensor,
             gate: torch.Tensor, s: int, k: int) -> torch.Tensor:
    """``ye [b, n_slots, D]`` -> each token's gate-weighted sum of its kept
    pairs' rows, float32 ``[b, S, D]``."""
    b, n_slots, d = ye.shape
    rows = torch.arange(b, device=ye.device)[:, None]
    contrib = ye[rows, torch.clamp(slots, max=n_slots - 1)]
    contrib = torch.where(keep[..., None], contrib, 0.0)
    out = contrib.float() * gate.reshape(b, s * k)[..., None].float()
    return out.reshape(b, s, k, d).sum(2)


def _dispatch_combine(params, x: torch.Tensor, gate: torch.Tensor,
                      cfg: ModelConfig, slot_of_pair: torch.Tensor,
                      keep: torch.Tensor, experts=None) -> torch.Tensor:
    """Scatter the kept pairs' tokens into ``[B, E, cap, D]``, run the
    experts (``experts(xe) -> ye``, default: each expert's SwiGLU on
    ``xe`` constrained to the experts over ``model``), gather each pair's
    row back and sum over k weighted by its gate in float32 (without the
    shared expert).

    slot_of_pair [B, S*k]: the flat ``e * cap + position`` slot of each
    (token, k) pair; keep [B, S*k]: False for a pair past capacity."""
    b, s, d = x.shape
    k, e = cfg.moe_top_k, cfg.moe_num_experts
    cap = _row_capacity(cfg, s)
    src_token = torch.arange(s * k, device=x.device) // k  # [S*k]
    slots = torch.where(keep, slot_of_pair, e * cap)  # the dump row: E*cap
    xe = _scatter(x, slots, src_token, e * cap).reshape(b, e, cap, d)
    if experts is None:
        ye = _expert_ffn(params, shard(xe, P(DP, TP, None, None)))
    else:
        ye = experts(xe)
    return _combine(ye.reshape(b, e * cap, d), slots, keep, gate, s,
                    k).to(x.dtype)


# ---------------------------------------------------------------------------
# under a mesh
# ---------------------------------------------------------------------------


def _ep_taken(mesh, cfg: ModelConfig, b: int, s: int) -> bool:
    """The reference's condition for the expert-parallel branch: only where
    it pays (S > 1: at decode the branch would gather FSDP-split expert
    weights every step, and the fallback is cheaper)."""
    sizes = mesh_axis_sizes(mesh)
    tp = sizes.get("model", 1)
    dp = sizes.get("pod", 1) * sizes.get("data", 1)
    return (tp > 1 and cfg.moe_num_experts % tp == 0 and b % dp == 0
            and s > 1)


def _dims(mesh):
    return tuple(mesh.mesh_dim_names)


def _rows_placements(mesh):
    """The branch's ``in_specs`` for x: dim 0 over the data axes,
    replicated over ``model`` (the raw axes, as ``shard_map`` takes them)."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if a in ("pod", "data") else Replicate()
            for a in _dims(mesh)]


def _expert_block(w: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's ``[E / tp, ...]`` block of an expert weight, replicated
    over the data axes: a DTensor redistributed (an all-gather over the
    data axes where FSDP splits it), its gradient partial over the data
    axes; a plain (whole) tensor cut."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    names = _dims(mesh)
    if is_dtensor(w):
        want = [Shard(0) if a == "model" else Replicate() for a in names]
        grad = [Shard(0) if a == "model" else Partial() for a in names]
        return w.redistribute(mesh, want).to_local(grad_placements=grad)
    tp, m = mesh.size(names.index("model")), mesh.get_local_rank("model")
    n = w.shape[0] // tp
    return w[m * n:(m + 1) * n]


def _local_experts(params, xe: torch.Tensor, mesh) -> torch.Tensor:
    """The expert FFN of a plain ``xe [b, E, cap, D]`` (every rank's same
    tensor) whose weights are DTensors: where ``model`` divides the
    experts, each rank runs its ``E / tp`` experts on their slots and the
    model axis gathers the blocks; otherwise (the strict layout keeps such
    weights whole over ``model``) each rank runs them all (forward
    only)."""
    from torch.distributed.tensor import Replicate

    from repro_torch.parallel import dist as pdist

    names = _dims(mesh)
    tp, e = mesh.size(names.index("model")), xe.shape[1]
    if e % tp:
        whole = {w: params[w].redistribute(
            mesh, [Replicate()] * mesh.ndim).to_local().detach()
            for w in ("wg", "wu", "wd")}
        return _expert_ffn(whole, xe)
    e_loc, m = e // tp, mesh.get_local_rank("model")
    block = {w: _expert_block(params[w], mesh).detach()
             for w in ("wg", "wu", "wd")}
    ye = _expert_ffn(block, xe[:, m * e_loc:(m + 1) * e_loc].contiguous())
    parts = pdist.all_gather0(ye.movedim(1, 0),
                              pdist.axis(mesh, "model").group)
    return parts.movedim(0, 1)


def _forward_only(*tensors) -> None:
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in tensors if isinstance(t, torch.Tensor)):
        raise NotImplementedError(
            "moe: a plain tensor under a mesh runs forward only; pass "
            "DTensors for a gradient")


def _expert_parallel(params, x: torch.Tensor, gate: torch.Tensor,
                     cfg: ModelConfig, slots: torch.Tensor,
                     keep: torch.Tensor, mesh) -> torch.Tensor:
    """The branch's local body on this rank's rows ``x [b_l, S, D]`` (plain
    tensors), its ``slots`` / ``keep`` / ``gate``: the rank's experts
    only, then the partial sum cast to ``x``'s dtype -> ``part [b_l, S,
    D]``, not yet summed over ``model``."""
    b, s, d = x.shape
    k, e = cfg.moe_top_k, cfg.moe_num_experts
    cap = _row_capacity(cfg, s)
    names = _dims(mesh)
    e_loc = e // mesh.size(names.index("model"))
    lo = mesh.get_local_rank("model") * e_loc * cap
    src_token = torch.arange(s * k, device=x.device) // k
    slots = torch.where(keep, slots, e * cap)
    mine = (slots >= lo) & (slots < lo + e_loc * cap) & keep
    sl = torch.where(mine, slots - lo, e_loc * cap)
    xe = _scatter(x, sl, src_token, e_loc * cap).reshape(b, e_loc, cap, d)
    block = {w: _expert_block(params[w], mesh) for w in ("wg", "wu", "wd")}
    ye = _expert_ffn(block, xe).reshape(b, e_loc * cap, d)
    return _combine(ye, sl, mine, gate, s, k).to(x.dtype)


def _gather_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """A plain rank's rows of a dim-0 split over the data axes gathered
    back whole, in the flattened (pod, data) order."""
    from repro_torch.parallel import dist as pdist

    for a in ("data", "pod"):
        if a in _dims(mesh):
            t = pdist.all_gather0(t, pdist.axis(mesh, a).group)
    return t


def _rows_of(t: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's block of a plain ``t``'s dim 0 split over the data
    axes (pod major)."""
    names, idx, n = _dims(mesh), 0, 1
    for a in ("pod", "data"):
        if a in names:
            size = mesh.size(names.index(a))
            idx, n = idx * size + mesh.get_local_rank(a), n * size
    b = t.shape[0] // n
    return t[idx * b:(idx + 1) * b]


def _moe_plain_mesh(params, x: torch.Tensor, cfg: ModelConfig, slots_fn,
                    mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe`` of a plain ``x`` (the same global tensor on every rank)
    under a mesh."""
    from repro_torch.parallel import dist as pdist

    b, s, _ = x.shape
    idx, gate, aux = _router(params, x, cfg)
    slots, keep = slots_fn(idx, cfg, s)
    if _ep_taken(mesh, cfg, b, s):
        _forward_only(x, *(params[w] for w in ("wg", "wu", "wd")))
        part = _expert_parallel(params, _rows_of(x, mesh),
                                _rows_of(gate, mesh), cfg,
                                _rows_of(slots, mesh), _rows_of(keep, mesh),
                                mesh)
        part = pdist.all_reduce(part, "sum", pdist.axis(mesh, "model").group)
        out = _gather_rows(part, mesh)
    elif is_dtensor(params["wg"]):
        _forward_only(x)
        out = _dispatch_combine(params, x, gate, cfg, slots, keep,
                                lambda xe: _local_experts(params, xe, mesh))
    else:
        out = _dispatch_combine(params, x, gate, cfg, slots, keep)
    return out, aux


def _local(t: torch.Tensor, mesh, placements, grad_placements):
    """This rank's block of ``t`` laid out as ``placements`` (a plain ``t``
    is taken as replicated), its gradient read back as
    ``grad_placements``."""
    from torch.distributed.tensor import DTensor, Replicate

    if not is_dtensor(t):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return t.redistribute(mesh, placements).to_local(
        grad_placements=grad_placements)


def _moe_dtensor(params, x, cfg: ModelConfig, slots_fn, mesh
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe`` of a DTensor ``x`` under ``mesh``: the routing, the slots and
    the combine on each rank's rows; the auxiliary loss from the sums of
    every rank's counts and gates."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from repro_torch.parallel.sharding import placements

    b, s, d = x.shape
    k, e = cfg.moe_top_k, cfg.moe_num_experts
    ep = _ep_taken(mesh, cfg, b, s)
    rows = (_rows_placements(mesh) if ep else
            list(placements(guard_spec(P(DP, None, None), x.shape, mesh,
                                       strict=True), mesh)))
    partial = [Partial() if p != Replicate() else Replicate() for p in rows]
    xr = x.redistribute(mesh, rows)
    xl = xr.to_local()
    router = _local(params["router"], mesh, [Replicate()] * mesh.ndim,
                    partial)
    gates, gate, idx = _gates(router, xl, cfg)  # this rank's rows

    def summed(t):
        return DTensor.from_local(t, mesh, partial, run_check=False,
                                  shape=t.shape, stride=t.stride())

    density = summed(_expert_counts(idx, e)) / (b * s * k)
    aux = e * torch.sum(density * (summed(gates.sum((0, 1))) / (b * s)))
    slots, keep = slots_fn(idx, cfg, s)
    if ep:
        # the gates' and x's gradients from this rank's experts are partial
        # over ``model``; the psum's transpose is the identity
        over_model = [Partial() if a == "model" else p
                      for a, p in zip(_dims(mesh), rows)]
        x_ep = xr.to_local(grad_placements=over_model)
        gate_ep = DTensor.from_local(
            gate, mesh, rows, run_check=False,
            shape=(b,) + tuple(gate.shape[1:]),
            stride=gate.stride()).to_local(grad_placements=over_model)
        part = _expert_parallel(params, x_ep, gate_ep, cfg, slots, keep,
                                mesh)
        out = DTensor.from_local(part, mesh, over_model, run_check=False,
                                 shape=x.shape, stride=x.stride()) \
            .redistribute(mesh, rows)
    else:
        def experts(xe):  # the rows' xe as a DTensor, the experts over model
            xe = DTensor.from_local(xe, mesh, rows, run_check=False,
                                    shape=(b,) + tuple(xe.shape[1:]),
                                    stride=xe.stride())
            ye = _expert_ffn(params, shard(xe, P(DP, TP, None, None)))
            return ye.redistribute(mesh, rows).to_local()

        part = _dispatch_combine(params, xl, gate, cfg, slots, keep, experts)
        out = DTensor.from_local(part, mesh, rows, run_check=False,
                                 shape=x.shape, stride=x.stride())
    return out, aux


def _einsum_slots(idx: torch.Tensor, cfg: ModelConfig, s: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(slots, keep) ``[b, S*k]``: the queue position is the cumsum of a
    one-hot along the row."""
    b = idx.shape[0]
    k, e = cfg.moe_top_k, cfg.moe_num_experts
    cap = _row_capacity(cfg, s)
    flat_e = idx.reshape(b, s * k)  # pair order = (token, k)
    onehot = torch.nn.functional.one_hot(flat_e, e)  # [B, S*k, E]
    pos = torch.cumsum(onehot, dim=1) - 1  # queue position per expert
    pos = torch.gather(pos, 2, flat_e[..., None])[..., 0]
    return flat_e * cap + torch.clamp(pos, max=cap - 1), pos < cap


def _streaming_slots(idx: torch.Tensor, cfg: ModelConfig, s: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(slots, keep) ``[b, S*k]``: a stable per-row sort by expert id (the
    RIT); a pair's position is its rank in its expert's block."""
    b = idx.shape[0]
    k, e = cfg.moe_top_k, cfg.moe_num_experts
    cap = _row_capacity(cfg, s)
    flat_e = idx.reshape(b, s * k)
    sorted_e, order = torch.sort(flat_e, dim=1, stable=True)  # the RIT
    experts = torch.arange(e, device=idx.device).expand(b, e).contiguous()
    starts = torch.searchsorted(sorted_e, experts)  # [B, E]
    rank = torch.arange(s * k, device=idx.device)[None] \
        - torch.gather(starts, 1, sorted_e)
    keep_sorted = rank < cap
    slot_sorted = sorted_e * cap + torch.clamp(rank, max=cap - 1)
    # un-sort the slot assignment back to (token, k) pair order
    slots = torch.empty_like(slot_sorted).scatter_(1, order, slot_sorted)
    keep = torch.empty_like(keep_sorted).scatter_(1, order, keep_sorted)
    return slots, keep


def _moe(params, x: torch.Tensor, cfg: ModelConfig, slots_fn
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    mesh = current_mesh()
    if mesh is not None and is_dtensor(x):
        out, aux = _moe_dtensor(params, x, cfg, slots_fn, mesh)
    elif mesh is not None:
        out, aux = _moe_plain_mesh(params, x, cfg, slots_fn, mesh)
    else:
        idx, gate, aux = _router(params, x, cfg)
        slots, keep = slots_fn(idx, cfg, x.shape[1])
        out = _dispatch_combine(params, x, gate, cfg, slots, keep)
    if cfg.moe_shared_expert:
        out = out + ffn_mod.ffn(params["shared"], x)
    return out, aux


def moe_einsum(params, x: torch.Tensor, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Baseline: queue position = cumsum of a one-hot along the row."""
    return _moe(params, x, cfg, _einsum_slots)


def moe_streaming(params, x: torch.Tensor, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RIT-style: a stable per-row sort by expert id gives each expert a
    contiguous block; a pair's queue position is its rank in the block
    (no [B, S*k, E] one-hot). Output equal to :func:`moe_einsum`."""
    return _moe(params, x, cfg, _streaming_slots)


def moe(params, x: torch.Tensor, cfg: ModelConfig
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (out [B, S, D] in x's dtype, aux float32 scalar)."""
    if cfg.moe_dispatch == "streaming":
        return moe_streaming(params, x, cfg)
    return moe_einsum(params, x, cfg)
