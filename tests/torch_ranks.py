"""Rank entry points for the port's multi-rank CPU tests, and their
launcher (pytest collects no test here; this module imports neither JAX
nor a test module, as every spawned rank imports it).

``launch(fn, world, tmp_path, *args)`` starts ``world`` processes with the
``spawn`` method. Each sets one torch thread, joins a gloo process group
through a ``FileStore`` in ``tmp_path`` (no port, so concurrent test
workers cannot collide) with a collective timeout, runs ``fn(rank, world,
*args)`` and saves what it returns; the launcher kills every rank still
running at its deadline and fails, and fails for a rank that raised,
with that rank's traceback.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

DEADLINE_S = 120.0
COLLECTIVE_TIMEOUT_S = 60.0


def launch(fn, world: int, tmp_path: Path, *args,
           deadline_s: float = DEADLINE_S) -> list:
    """``fn(rank, world, *args)`` on ``world`` gloo ranks; the list of
    what each rank returned, in rank order."""
    ctx = mp.get_context("spawn")
    out = Path(tmp_path)
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, rank, world, str(out), args), daemon=True)
             for rank in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline_s
    try:
        for p in procs:
            p.join(max(end - time.monotonic(), 0.0))
        stalled = [r for r, p in enumerate(procs) if p.is_alive()]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    errors = {r: (out / f"rank{r}.err").read_text() for r in range(world)
              if (out / f"rank{r}.err").exists()}
    if stalled:
        raise AssertionError(f"ranks {stalled} of {world} passed the "
                             f"{deadline_s} s deadline; errors {errors}")
    codes = [p.exitcode for p in procs]
    if errors or any(codes):
        raise AssertionError(f"rank exit codes {codes}: {errors}")
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _rank_main(fn, rank: int, world: int, out: str, args: tuple) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(f"{out}/store", world)
    dist.init_process_group(
        "gloo", store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        torch.save(fn(rank, world, *args), f"{out}/rank{rank}.pt")
        dist.barrier()  # no rank leaves while another is in a collective
    except BaseException:
        Path(f"{out}/rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()
    # the result is written and the group is gone: end before the
    # interpreter's teardown, which once aborted a gloo rank under load
    # after its result was written ("terminate called without an active
    # exception")
    os._exit(0)


# ---------------------------------------------------------------------------
# the render path
# ---------------------------------------------------------------------------


def renderer(cfg_kw: dict, scene: str = None):
    """The port's CPU renderer of ``RenderConfig(**cfg_kw)``, baked from
    ``scene`` (default: the config's)."""
    from repro_torch import api
    from repro_torch.core.config import RenderConfig, ShardConfig
    from repro_torch.nerf import models, scenes

    kw = dict(cfg_kw)
    shard = kw.pop("shard", None)
    cfg = RenderConfig(**kw, shard=None if shard is None
                       else ShardConfig(num_devices=shard))
    model, _ = models.make_model(
        "dvgo", grid_res=cfg.grid_res, channels=cfg.channels,
        decoder=cfg.decoder, num_samples=cfg.num_samples,
        backend=cfg.backend)
    params = model.init_baked(scenes.make_scene(scene or cfg.scene),
                              device="cpu")
    return api.make_renderer(cfg, model=model, params=params, device="cpu")


def window_fields(res) -> dict:
    return {k: getattr(res, k).numpy() for k in (
        "frames", "holes", "hole_counts", "overflowed", "fine_counts")}


def render_windows_rank(rank: int, world: int, cfg_kw: dict, calls: list,
                        other_scene: str = None) -> dict:
    """``render_windows(ref, tgt)`` for each ``(ref, tgt)`` numpy pair of
    ``calls`` on a sharded engine (rank 1 bakes ``other_scene`` when
    given); per call its result's fields, or the ``ValueError`` it raised.
    Also counts this rank's dense fallback renders and lists its tick
    program keys."""
    eng = renderer(cfg_kw, other_scene if rank == 1 else None
                   ).pipeline.device_engine
    dense = [0]
    fill = eng._dense_fill_flat

    def counted(params, tgt):
        dense[0] += 1
        return fill(params, tgt)

    eng._dense_fill_flat = counted
    out = []
    for ref, tgt in calls:
        try:
            res = eng.render_windows(torch.as_tensor(ref),
                                     torch.as_tensor(tgt))
            out.append(window_fields(res))
        except ValueError as e:
            out.append(str(e))
    return {"calls": out, "dense_fills": dense[0],
            "mesh": None if eng.mesh is None else eng.mesh.size(),
            "keys": sorted(eng.tick_programs)}


# ops that read a tensor back to the host or size their output from its
# data (``tests/test_torch_graphs.py``'s guard; this module imports no test
# module, so the ranks keep their own copy)
SYNC_OPS = {"_local_scalar_dense", "item", "is_nonzero", "equal",
            "allclose", "nonzero", "nonzero_static", "argwhere", "bincount",
            "masked_select", "histc"}


def sync_guard():
    """A ``TorchDispatchMode`` that raises on any op of ``SYNC_OPS``,
    ``unique*`` or ``repeat_interleave.Tensor`` inside its block."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class SyncDetector(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name in SYNC_OPS or name.lstrip("_").startswith("unique") or (
                    name == "repeat_interleave"
                    and func._overloadname == "Tensor"):
                raise AssertionError(f"device read {func} inside a call "
                                     f"that must only dispatch")
            return func(*args, **(kwargs or {}))

    return SyncDetector()


def deferred_windows_rank(rank: int, world: int, jobs: list) -> list:
    """For each ``(cfg_kw, calls)`` of ``jobs``: a sharded engine's
    ``render_windows`` of each numpy ``(ref, tgt)`` pair under
    :func:`sync_guard`, whether the result came back unresolved (frames
    and dense fallback still deferred), its fields once read, this rank's
    dense fallback renders, and the fields as the owner-resolves-first
    rule gives them: an unsharded engine renders this rank's block of
    sessions, resolves it and the blocks are gathered."""
    from repro_torch.core import raybatch

    out = []
    for cfg_kw, calls in jobs:
        eng = renderer(dict(cfg_kw, shard=world)).pipeline.device_engine
        owner = renderer(cfg_kw).pipeline.device_engine
        dense = [0]
        fill = eng._dense_fill_flat

        def counted(params, tgt, fill=fill):
            dense[0] += 1
            return fill(params, tgt)

        eng._dense_fill_flat = counted
        block = raybatch.session_sharding(eng.mesh)
        rows = []
        for ref, tgt in calls:
            ref, tgt = torch.as_tensor(ref), torch.as_tensor(tgt)
            with sync_guard():
                res = eng.render_windows(ref, tgt)
            deferred = res._frames is None and res._dense_fill is not None
            got = window_fields(res)
            mine = owner.render_windows(block(ref), block(tgt))
            today = {k: raybatch.gather_sessions(
                eng.mesh, getattr(mine, k)).numpy() for k in got}
            rows.append({"deferred": deferred, "fields": got,
                         "owner_rule": today})
        out.append({"calls": rows, "dense_fills": dense[0]})
    return out


def guarded_serve_rank(rank: int, world: int, cfg_kw: dict, fleet: list,
                       scenes_of: dict, hole_caps: dict) -> dict:
    """:func:`serve_rank` with every tick that admits no session run under
    :func:`sync_guard`; ``hole_caps`` (sid -> cap) overrides sessions'
    hole capacities. Also the number of guarded ticks."""
    from repro_torch.core import pipeline
    from repro_torch.serve.render_engine import RenderServeEngine, \
        RenderSession

    ren = renderer(dict(cfg_kw, shard=world))
    eng = RenderServeEngine(
        ren.model, ren.params, config=ren.config,
        scene_loader=lambda name: torch.as_tensor(scenes_of[name]))
    sess = [RenderSession(sid=sid, poses=list(pipeline.orbit_trajectory(
        n, step_deg=4.0, phase_deg=ph)), scene=sc,
        hole_cap=hole_caps.get(sid)) for sid, n, ph, sc in fleet]
    real, guarded = eng.step, [0]

    def step():
        if eng.queue and any(s is None for s in eng.slots):
            return real()  # admission: paging, staging
        with sync_guard():
            ran = real()
        guarded[0] += ran
        return ran

    eng.step = step
    metrics = eng.run(sess)
    return {"sessions": [session_result(s) for s in sess],
            "metrics": metrics, "guarded_ticks": guarded[0]}


def session_result(sess) -> dict:
    return {"frames": torch.stack(sess.frames).numpy(),
            "stats": {k: getattr(sess.stats, k) for k in (
                "frames", "reference_renders", "warped_pixels",
                "sparse_pixels", "fallback_pixels", "total_pixels",
                "hole_fractions")}}


def serve_rank(rank: int, world: int, cfg_kw: dict, fleet: list,
               scenes_of: dict = None) -> dict:
    """Serve ``fleet`` ([(sid, frames, orbit phase, scene or None)]) on a
    sharded ``RenderServeEngine``, multi-scene when ``scenes_of`` maps
    scene names to numpy tables; each session's frames and stats and the
    run's metrics."""
    from repro_torch.core import pipeline
    from repro_torch.serve.render_engine import RenderServeEngine, \
        RenderSession

    ren = renderer(cfg_kw)
    loader = (None if scenes_of is None
              else lambda name: torch.as_tensor(scenes_of[name]))
    eng = RenderServeEngine(ren.model, ren.params, config=ren.config,
                            scene_loader=loader)
    sess = [RenderSession(sid=sid, poses=list(pipeline.orbit_trajectory(
        n, step_deg=4.0, phase_deg=ph)), scene=sc)
        for sid, n, ph, sc in fleet]
    metrics = eng.run(sess)
    return {"sessions": [session_result(s) for s in sess],
            "metrics": metrics}


# ---------------------------------------------------------------------------
# parallel/
# ---------------------------------------------------------------------------


def decode_attention_rank(rank: int, world: int, q, k, v, index: int,
                          sm_scale: float) -> np.ndarray:
    """``sharded_decode_attention`` on a (1, world) mesh's ``model``
    axis, this rank holding its slice of the numpy cache ``k``/``v``."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.parallel.decode_attention import \
        sharded_decode_attention

    mesh = DeviceMesh("cpu", torch.arange(world).reshape(1, world),
                      mesh_dim_names=("data", "model"))
    per = k.shape[2] // world
    sl = slice(rank * per, (rank + 1) * per)
    return sharded_decode_attention(
        torch.as_tensor(q), torch.as_tensor(k[:, :, sl]),
        torch.as_tensor(v[:, :, sl]), index, mesh=mesh, seq_axis="model",
        sm_scale=sm_scale).numpy()


def _tanh_layer(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def pipeline_rank(rank: int, world: int, params: dict, x,
                  num_microbatches) -> dict:
    """``pipelined_forward`` of ``tanh(h @ w + b)`` layers over the
    ``pod`` axis of a 1-D mesh of every rank, at each microbatch count of
    ``num_microbatches`` (an int or a list). This stage holds only its
    block of the stacked numpy ``params`` (its layers copied out):
    the outputs, and each leaf's shape and storage bytes as it holds
    them."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.parallel.pipeline import pipelined_forward

    mesh = DeviceMesh("cpu", list(range(world)), mesh_dim_names=("pod",))
    per = next(iter(params.values())).shape[0] // world
    stage = {k: torch.tensor(v[rank * per:(rank + 1) * per])
             for k, v in params.items()}
    counts = ([num_microbatches] if isinstance(num_microbatches, int)
              else num_microbatches)
    outs = {m: pipelined_forward(_tanh_layer, stage, torch.as_tensor(x),
                                 mesh=mesh, num_microbatches=m).numpy()
            for m in counts}
    return {"out": outs[counts[0]] if isinstance(num_microbatches, int)
            else outs,
            "held": {k: (tuple(t.shape), t.untyped_storage().nbytes())
                     for k, t in stage.items()}}


def compressed_psum_rank(rank: int, world: int, grads: list, mode: str,
                         steps: int) -> dict:
    """``steps`` error-feedback steps of ``compressed_psum`` over every
    rank, this rank's gradient trees ``grads[rank][step]``: each step's
    mean and residuals, and this rank's dequantized payloads."""
    from repro_torch.parallel import compression

    group = dist.group.WORLD
    ef = compression.make_ef_state(
        {k: torch.as_tensor(v) for k, v in grads[rank][0].items()})
    out = []
    for step in range(steps):
        g = {k: torch.as_tensor(v) for k, v in grads[rank][step].items()}
        qs, ss, _ = compression.compress_with_feedback(g, ef, mode)
        mean, ef = compression.compressed_psum(g, group, ef, mode)
        out.append({"mean": {k: t.numpy() for k, t in mean.items()},
                    "deq": {k: compression.dequantize(qs[k], ss[k]).numpy()
                            for k in qs}})
    return {"steps": out}


# ---------------------------------------------------------------------------
# the elastic re-lay and the mesh Trainer
# ---------------------------------------------------------------------------


def _empty_like_tree(tree, dtype=None):
    """Each meta leaf of ``tree`` as an empty CPU tensor of its dtype (or
    ``dtype``): a template for ``checkpoint.load``."""
    from repro_torch.optim.adamw import tree_flatten

    leaves, unflatten = tree_flatten(tree)
    return unflatten([torch.empty(0, dtype=dtype or t.dtype)
                      for t in leaves])


def relay_rank(rank: int, world: int, cfg, src: str, layouts: list) -> dict:
    """``checkpoint.load(shardings=...)`` of the Trainer checkpoint in
    ``src`` on each ``(label, mesh shape, strategy)`` of ``layouts`` (a
    (data, model) mesh of every rank; the config's params laid out by
    ``strategy``'s strict placements, each moment as its param): per leaf
    this rank's block's shape and offset, the placements asked for and
    got, and whether the block and ``full_tensor()`` equal the one-device
    load's."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.models import lm
    from repro_torch.parallel import sharding
    from repro_torch.parallel.sharding import NamedSharding
    from repro_torch.train import checkpoint as ckpt

    meta = lm.param_shapes(cfg)
    template = {"params": _empty_like_tree(meta),
                "opt": {k: _empty_like_tree(meta, torch.float32)
                        for k in ("m", "v")}}
    whole, _ = ckpt.load(src, template)
    out = {}
    for label, shape, strategy in layouts:
        mesh = DeviceMesh("cpu", torch.arange(world).reshape(shape),
                          mesh_dim_names=("data", "model"))
        specs = sharding.apply_strategy(lm.param_specs(cfg), meta, strategy)
        pshard = sharding.sharding_tree(specs, meta, mesh)
        lay = {"params": pshard, "opt": {"m": pshard, "v": pshard}}
        state, _ = ckpt.load(src, template, shardings=lay)
        rows = {}
        for (key, dt), (_, want), (_, ns) in zip(
                ckpt._flatten(state), ckpt._flatten(whole), ckpt._flatten(
                    lay, is_leaf=lambda x: isinstance(x, NamedSharding))):
            local = dt.to_local()
            _, offset = sharding.local_block(ns, want.shape)
            block = want[tuple(slice(o, o + n)
                               for o, n in zip(offset, local.shape))]
            rows[key] = {
                "local_shape": tuple(local.shape), "offset": offset,
                "requested": [repr(p) for p in ns.placements],
                "placements": [repr(p) for p in dt.placements],
                "local_equal": torch.equal(local, block),
                "full_equal": torch.equal(dt.full_tensor(), want)}
        out[label] = rows
    return out


def mesh_trainer_rank(rank: int, world: int, cfg, dcfg, tcfg_kw: dict,
                      out_dir: str, steps: int, fault_at: int,
                      resume_steps: int) -> dict:
    """A ``Trainer(mesh=...)`` on a (world, 1) (data, model) mesh: its
    placement trees against the strict placements of the config's
    strategy, ``steps`` steps with one fault injected at ``fault_at``,
    every ``checkpoint.save`` it makes, the checkpoint directory after it,
    then a fresh mesh Trainer resuming for ``resume_steps``."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.models import lm
    from repro_torch.parallel import sharding
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.trainer import Trainer, TrainerConfig

    mesh = DeviceMesh("cpu", torch.arange(world).reshape(world, 1),
                      mesh_dim_names=("data", "model"))
    saves, real_save = [], ckpt.save

    def counted(ckpt_dir, step, *args, **kw):
        saves.append(step)
        return real_save(ckpt_dir, step, *args, **kw)

    ckpt.save = counted
    armed = [True]

    def fault(step):
        if step == fault_at and armed[0]:
            armed[0] = False
            raise RuntimeError(f"injected fault at step {fault_at}")

    tcfg = TrainerConfig(ckpt_dir=f"{out_dir}/mesh", **tcfg_kw)
    t = Trainer(cfg, dcfg, tcfg, mesh=mesh, fault_hook=fault, device="cpu")
    meta = lm.param_shapes(cfg)
    want = sharding.sharding_tree(sharding.apply_strategy(
        lm.param_specs(cfg), meta, sharding.default_strategy(cfg)), meta,
        mesh, strict=True)
    run = t.run(steps, resume=False)
    listing = sorted(os.listdir(f"{out_dir}/mesh"))
    resumed = Trainer(cfg, dcfg, tcfg, mesh=mesh, device="cpu").run(
        resume_steps, resume=True)
    return {"pshard_is_strict": t._pshard == want,
            "oshard_is_strict": t._oshard == {"m": want, "v": want},
            "sharded_leaves": sum(
                any(repr(p).startswith("Shard") for p in ns.placements)
                for _, ns in ckpt._flatten(
                    t._pshard,
                    is_leaf=lambda x: isinstance(x, sharding.NamedSharding))),
            "losses": run["losses"], "restarts": run["restarts"],
            "final_step": run["final_step"],
            "events": [m for m in t.metrics if m.get("event") == "restart"],
            "saves": saves, "listing": listing,
            "resumed_losses": resumed["losses"],
            "resumed_final_step": resumed["final_step"]}


def relay_and_train_rank(rank: int, world: int, relay: tuple,
                         train: tuple) -> dict:
    """:func:`relay_rank` then :func:`mesh_trainer_rank`, in one launch."""
    return {"relay": relay_rank(rank, world, *relay),
            "train": mesh_trainer_rank(rank, world, *train)}


# ---------------------------------------------------------------------------
# MoE's expert-parallel branch
# ---------------------------------------------------------------------------


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.detach().numpy()


def moe_mesh_rank(rank: int, world: int, cfg, cases: dict) -> dict:
    """``moe`` under a (2, 2) (data, model) mesh for each case ``name ->
    (params, x, r, dispatch)`` (numpy; the params of ``cfg`` with the
    case's expert count): params and ``x`` laid out as DTensors by the
    spec trees (x's batch over ``data`` where it divides), the output, ``aux`` and the
    grads of ``sum(out * r) + aux`` gathered whole, with the number of
    expert-parallel bodies the call ran; then a plain ``x`` (every rank's
    same tensor) against DTensor experts, forward only. Also the
    placements ``shard`` gives a DTensor and that a plain tensor passes
    through."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models import common, moe
    from repro_torch.models.common import DP, TP, P
    from repro_torch.parallel.sharding import named_sharding

    mesh = DeviceMesh("cpu", torch.arange(world).reshape(2, world // 2),
                      mesh_dim_names=("data", "model"))
    bodies, real = [0], moe._expert_parallel

    def counted(*a, **kw):
        bodies[0] += 1
        return real(*a, **kw)

    moe._expert_parallel = counted
    placed, real_dt = [], moe._moe_dtensor

    def recorded(*a, **kw):  # the layout of the routed experts' sum
        y, aux = real_dt(*a, **kw)
        placed.append(tuple(repr(q) for q in y.placements))
        return y, aux

    moe._moe_dtensor = recorded

    def lay(spec, a):
        return distribute_tensor(torch.from_numpy(a), mesh, named_sharding(
            mesh, spec, a.shape).placements)

    out = {}
    for name, (params, x, r, dispatch) in cases.items():
        c = cfg.with_(moe_dispatch=dispatch,
                      moe_num_experts=params["wg"].shape[0])
        specs = moe.moe_specs(c)
        p = common.map_specs(lay, specs, params)
        leaves = [p["router"], p["wg"], p["wu"], p["wd"],
                  *(p["shared"][k] for k in sorted(p["shared"]))]
        for t in leaves:
            t.requires_grad_(True)
        # x laid out as the embedding's constraint lays it (a batch the
        # data axis does not divide stays whole)
        rows = named_sharding(mesh, P(DP, None, None), x.shape).placements
        xd = distribute_tensor(torch.from_numpy(x), mesh, rows)
        xd.requires_grad_(True)
        rd = distribute_tensor(torch.from_numpy(r), mesh, rows)
        bodies[0] = 0
        with common.use_mesh(mesh):
            y, aux = moe.moe(p, xd, c)
            grads = torch.autograd.grad((y * rd).sum() + aux, [xd, *leaves])
            taken = bodies[0]
            with torch.no_grad():
                y_plain, aux_plain = moe.moe(
                    dict(p, router=p["router"].full_tensor(),
                         shared={k: v.full_tensor()
                                 for k, v in p["shared"].items()}),
                    torch.from_numpy(x), c)
        out[name] = {"out": y.full_tensor().detach().numpy(),
                     "aux": float(aux.full_tensor()),
                     "grads": [g.full_tensor().numpy() for g in grads],
                     "bodies": taken, "out_placements": placed[-1],
                     "plain_out": y_plain.numpy(),
                     "plain_aux": float(aux_plain)}
    with common.use_mesh(mesh):
        xd = distribute_tensor(torch.ones(4, 6, 8), mesh,
                               [Replicate(), Replicate()])
        plain = torch.ones(4, 6, 8)
        out["shard"] = {
            "dtensor": tuple(repr(q) for q in common.shard(
                xd, P(DP, TP, None)).placements),
            "plain_passes": common.shard(plain, P(DP, TP, None)) is plain}
    out["shard"]["no_mesh"] = common.shard(xd, P(DP, TP, None)) is xd
    moe._expert_parallel, moe._moe_dtensor = real, real_dt
    return out


# ---------------------------------------------------------------------------
# the dry-run's cells run for real
# ---------------------------------------------------------------------------


def dryrun_train_rank(rank: int, world: int, cases: dict) -> dict:
    """For each case ``name -> (cfg, shape, params, batch)`` (numpy params
    and batch): the train step :func:`dryrun.build_lm_cell` lays out on a
    (2, 2) (data, model) mesh, its params, moments and batch DTensors of
    those values, run for real under the mesh context: the loss and every
    grad (``lm.loss_and_grads``), gathered whole; then one whole train step
    (AdamW in place, its metrics laid out as the cell's outputs) under the
    cost counter, its params after the step gathered whole and this rank's
    counts."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch import dryrun
    from repro_torch.models import common, lm
    from repro_torch.optim.adamw import tree_flatten
    from repro_torch.roofline import cost

    mesh = DeviceMesh("cpu", torch.arange(world).reshape(2, world // 2),
                      mesh_dim_names=("data", "model"))

    def lay(values, shardings):
        if isinstance(values, dict):
            return {k: lay(v, shardings[k]) for k, v in values.items()}
        if isinstance(values, list):
            return [lay(v, s) for v, s in zip(values, shardings)]
        return distribute_tensor(torch.tensor(np.asarray(values)), mesh,
                                 list(shardings.placements))

    def whole(tree):
        leaves, _ = tree_flatten(tree)
        return [t.full_tensor().detach().numpy() for t in leaves]

    out = {}
    for name, (cfg, shape, params, batch) in cases.items():
        cell = dryrun.build_lm_cell(cfg, shape, mesh)
        p = lay(params, cell.in_sh[0])
        zeros = lambda: lay(_zeros_like_tree(params), cell.in_sh[0])
        opt = {"m": zeros(), "v": zeros()}
        b = lay(batch, cell.in_sh[2])
        previous = common.get_strategy()
        common.set_strategy(cell.strategy)
        try:
            with common.use_mesh(mesh):
                loss, _, grads = lm.loss_and_grads(p, b, cell.cfg)
                res = {"loss": float(loss.full_tensor()),
                       "grads": whole(grads), "strategy": cell.strategy}
                with cost.CostCounter() as counter:
                    dryrun._relay(cell.fn(p, opt, b, 0), cell.out_sh)
        finally:
            common.set_strategy(previous)
        res.update(params_after=whole(p), counts=counter.result())
        res["serve"] = _laid_out_serve(mesh, cfg, shape, params,
                                       batch["tokens"])
        out[name] = res
    return out


def _laid_out_serve(mesh, cfg, shape, params, tokens) -> dict:
    """A prefill of ``tokens`` and one decode step, the params, tokens and
    caches laid out as the dry-run's prefill and decode cells lay them,
    run for real under the mesh context: the prefill and decode logits and
    the caches after the decode, gathered whole."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.models import common, lm

    b, s = tokens.shape
    cache_len = s + 8
    pre = dryrun.build_lm_cell(cfg, ShapeConfig("p", cache_len, b,
                                                "prefill"), mesh)
    dec = dryrun.build_lm_cell(cfg, ShapeConfig("d", cache_len, b,
                                                "decode"), mesh)

    def lay(values, shardings):
        if isinstance(values, dict):
            return {k: lay(v, shardings[k]) for k, v in values.items()}
        if isinstance(values, list):
            return [lay(v, s) for v, s in zip(values, shardings)]
        return distribute_tensor(torch.tensor(np.asarray(values)), mesh,
                                 list(shardings.placements))

    previous = common.get_strategy()
    common.set_strategy(pre.strategy)
    try:
        with torch.no_grad(), common.use_mesh(mesh):
            p = lay(params, pre.in_sh[0])
            logits, caches = lm.make_prefill_step(cfg, cache_len)(
                p, lay({"tokens": tokens}, pre.in_sh[1]))
            token = logits.full_tensor().argmax(-1)[:, None]

            def relay(c, shardings):  # a prefill cache in decode's layout
                if isinstance(c, tuple):
                    out = [relay(t, ns) for t, ns in zip(c, shardings)]
                    return type(c)(*out) if hasattr(c, "_fields") \
                        else tuple(out)
                return distribute_tensor(c.full_tensor(), mesh,
                                         list(shardings.placements))

            caches = [relay(c, cs) for c, cs in zip(caches, dec.in_sh[1])]
            d_logits, caches = lm.make_decode_step(cfg)(
                p, caches, distribute_tensor(token, mesh, list(
                    dec.in_sh[2].placements)), s)
    finally:
        common.set_strategy(previous)
    return {"prefill": logits.full_tensor().numpy(),
            "decode": d_logits.full_tensor().numpy(),
            "token": token.numpy(),
            "caches": [t.full_tensor().numpy() for t in _leaves(caches)],
            "cache_placements": [repr(tuple(t.placements))
                                 for t in _leaves(caches)]}


def _leaves(tree) -> list:
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _leaves(x)]
    return [tree]


def _zeros_like_tree(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_like_tree(v) for v in tree]
    return np.zeros(np.shape(tree), np.float32)
