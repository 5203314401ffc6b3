#!/usr/bin/env python3
"""Warm walls, device busy share, host launches, synchronizing calls and
peak device memory of the port's render arms on one CUDA card, for the
``repro_torch`` package under ``--src``.

    python3 scripts/steady_tick_bench.py                  # this checkout
    python3 scripts/steady_tick_bench.py --src OTHER/src --tag parent

Run from the repository root; two trees compared on one card are run in
turns in one call (parent, change, change, parent). The arms are
``chip_smoke.py``'s, built by its helpers: A (staged, 32 frames), B
(staged MLP, 16), C (fused, 32), D (fused serving, 6 sessions x 32 frames
on 4 slots), D_staged (the same fleet on the staged tick; not profiled,
its trace is too large to reduce quickly), E (multi-scene fused serving,
12 sessions x 32 frames over 6 scenes on 4 pages) and G (A with adaptive
sampling; profiled over its first window, as ``chip_smoke.py`` does).

Per arm: a cold run (it builds the kernels and, on a tree with tick
programs, runs each key eagerly and captures it), a second run to capture
the keys the cold run met once, then a warm run timed by a synchronized
wall clock, a run under ``torch.cuda.set_sync_debug_mode("warn")`` that
counts the synchronizing calls (readbacks included: each window's or
tick's statistics), and a profiled run: device busy time,
``cudaLaunchKernel`` and ``cudaGraphLaunch`` calls and the peak of
allocated device memory (``chip_smoke.profile_run``). Prints the card as
``nvidia-smi`` names it and one JSON line. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARMS = ("A", "B", "C", "D", "D_staged", "E", "G")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package")
    ap.add_argument("--tag", default="change")
    ap.add_argument("--arms", default=",".join(ARMS))
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs  # its helpers; it puts ROOT/src on sys.path

    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("steady_tick_bench: no CUDA device visible", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch import api
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.config import RenderConfig, RenderRequest
    from repro_torch.core.pipeline import orbit_trajectory
    from repro_torch.kernels import gather_trilerp as gt_k
    from repro_torch.kernels import fused_nerf_mlp as mlp_k
    from repro_torch.kernels import streaming_pipeline as sp_k
    from repro_torch.nerf import models, scenes
    from repro_torch.serve.render_engine import RenderServeEngine

    src = Path(repro_torch.__file__).resolve()
    if Path(args.src).resolve() not in src.parents:
        raise SystemExit(f"repro_torch imported from {src}, not {args.src}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}")
    kernels = [gt_k.KERNEL, mlp_k.KERNEL, sp_k.KERNEL, gt_k.KERNEL_PER_SEG,
               sp_k.KERNEL_PER_SEG]

    cfg_a = RenderConfig(backend="streaming")
    model_b, _ = models.make_model("dvgo", backend="streaming",
                                   decoder="mlp")
    np_params_b = cs.arm_b_params(0)
    cfg_b = RenderConfig(backend="streaming", decoder="mlp", grid_res=64,
                         channels=8, num_samples=64)
    cfg_d = cfg_b.replace(fused_tick=True, num_slots=4)
    cfg_e = cfg_a.replace(fused_tick=True, num_slots=4)
    fleet = [RenderRequest(poses=tuple(orbit_trajectory(
        32, phase_deg=25.0 * i))) for i in range(6)]

    def trajectory(cfg, n_frames, model=None, profile_frames=None):
        extra = ({} if model is None else dict(
            model=model, params=params_from_numpy(np_params_b, dev)))
        ren = api.make_renderer(cfg, **extra)
        poses = tuple(orbit_trajectory(n_frames))
        req = RenderRequest(poses=poses)
        prof = RenderRequest(poses=poses[:profile_frames or n_frames])
        return ((lambda: ren.render(req)), (lambda: ren.render(prof)),
                -(-n_frames // cfg.window),
                lambda: ren.pipeline.device_engine)

    def serving(cfg):
        ren = api.make_renderer(cfg, model=model_b,
                                params=params_from_numpy(np_params_b, dev))
        runs = []
        fn = lambda: runs.append(ren.serve(fleet)[1]["ticks"])
        return fn, fn, runs, \
            lambda: ren.pipeline.serve_engine_for(ren.config).engine

    def scenes_arm():
        ren = api.make_renderer(cfg_e)
        eng = RenderServeEngine(
            ren.model, ren.params, config=cfg_e,
            scene_loader=lambda name: scenes.bake_dense_table(
                scenes.make_scene(name), cfg_e.grid_res, cfg_e.channels,
                device=dev))
        runs = []
        fn = lambda: runs.append(eng.run(cs.arm_e_sessions(12, 32))["ticks"])
        return fn, fn, runs, lambda: eng.engine

    makers = {"A": lambda: trajectory(cfg_a, 32),
              "B": lambda: trajectory(cfg_b, 16, model_b),
              "C": lambda: trajectory(cfg_a.replace(fused_tick=True), 32),
              "D": lambda: serving(cfg_d),
              "D_staged": lambda: serving(cfg_d.replace(fused_tick=False)),
              "E": scenes_arm,
              "G": lambda: trajectory(cfg_a.replace(
                  adaptive_sampling=True, coarse_factor=4), 32,
                  profile_frames=16)}
    out = {}
    for name in args.arms.split(","):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run, prof_run, ticks, engine_of = makers[name]()
        for k in kernels:
            k.reset()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels}
        run()  # every key met once in the cold run is captured here
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                run()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        n_ticks = ticks[-1] if isinstance(ticks, list) else ticks
        row = {"ticks": n_ticks, "cold_wall_s": cold_s, "warm_wall_s": warm_s,
               "sync_calls_per_run": syncs,
               "sync_calls_per_tick": syncs / n_ticks, "launches": launches,
               "peak_allocated_bytes_arm": torch.cuda.max_memory_allocated()}
        eng = engine_of()
        if hasattr(eng, "tick_programs"):
            row["tick_programs"] = len(eng.tick_programs)
            row["captures"] = eng.num_captures
        if name != "D_staged":
            p = cs.profile_run(prof_run)
            row["profile"] = {k: p[k] for k in (
                "profiled_wall_us", "device_busy_us", "device_busy_share",
                "host_cuda_launch_kernel", "host_cuda_graph_launch",
                "peak_allocated_bytes", "reserved_bytes", "device_events",
                "top_host_ops", "top_device")}
        out[name] = row
        print(f"{args.tag} arm {name}: {json.dumps(row)}", flush=True)
        del run, prof_run, engine_of, eng
        torch.cuda.empty_cache()
    print(json.dumps({"tree": args.tag, "src": args.src, "card": smi,
                      "arms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
