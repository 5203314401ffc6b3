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
                  num_microbatches: int) -> np.ndarray:
    """``pipelined_forward`` of ``tanh(h @ w + b)`` layers over the
    ``pod`` axis of a 1-D mesh of every rank."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.parallel.pipeline import pipelined_forward

    mesh = DeviceMesh("cpu", list(range(world)), mesh_dim_names=("pod",))
    tree = {k: torch.as_tensor(v) for k, v in params.items()}
    return pipelined_forward(_tanh_layer, tree, torch.as_tensor(x),
                             mesh=mesh, num_microbatches=num_microbatches
                             ).numpy()


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
