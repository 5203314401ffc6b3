#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card and
check it end to end.

    python3 chip_smoke.py        # from the repository root; one CUDA card

Phases, in order; any failure exits non-zero and nothing is swallowed:

1. print the card (``torch.cuda.get_device_name`` and ``nvidia-smi``'s
   name and power limit);
2. build every CUDA kernel of the path from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, started together) and print the build seconds;
3. hold each kernel against its plain PyTorch version on the card, on
   inputs the main path builds, TF32 off: the Gathering Unit (B1) with
   float32 and bfloat16 tables, both MVoxel layouts, 1 and 4 segments; the
   fused MLP (B2) at C=8, H=64. Tolerances are the reference's kernel
   tolerances: atol 2e-5 / rtol 1e-5 (float32), 3e-2 (bfloat16);
4. render two arms end to end through ``repro_torch.api`` with every launch
   count set to 0 just before and read just after; each arm's frames are
   held against the same port run on the CPU (which runs the plain
   versions): every frame >= 40 dB PSNR, equal reference renders, sparse
   pixels within 1%, and every kernel of the arm launched at least once.
   Arm A: ``RenderConfig(backend="streaming")`` at its defaults (res 64,
   window 16, grid 48, 4 channels, 32 samples, baked "lego"), 32 frames.
   Arm B: ``make_model("dvgo", backend="streaming", decoder="mlp")`` at
   ``NerfConfig``'s defaults (grid 64, 8 channels, hidden 64, 64 samples)
   with random parameters from numpy seed 0, 16 frames at res 64;
   A third, profiled render of each arm (``torch.profiler``) reports the
   device's busy share of the wall time and the busiest kernels and ops;
5. time each kernel and its plain version at the arms' shapes (device
   time from CUDA events, see ``time_ms``) beside the least time the card
   could take, and print them as one JSON line, then the arms' wall times;
6. print ``{"ok": true, "device": {...}}`` as the last line.

Imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOP_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
F32_TOL = dict(atol=2e-5, rtol=1e-5)
BF16_TOL = dict(atol=3e-2, rtol=3e-2)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, repeats: int = 20, launches: int = 10,
            warmup: int = 3) -> float:
    """Device time of one ``fn()`` call, in ms: the median over
    ``repeats`` of CUDA-event time around ``launches`` back-to-back calls
    divided by ``launches``. A device-side sleep queued first lets the host
    enqueue every call before the first starts, so the host's launch cost
    is not counted; inputs stay in L2 between calls, as they are when the
    path hands one stage's output to the next."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)  # ~25 ms at H100 clocks
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def check_close(name: str, got, want, tol) -> float:
    import torch

    got, want = got.float(), want.float()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not torch.allclose(got, want, **tol):
        fail(f"{name}: kernel disagrees with its plain version "
             f"(max abs err {err:.3g}, tolerance {tol})")
    print(f"check {name}: max abs err {err:.3g}")
    return err


def profile_render(renderer, request) -> dict:
    """Where one warm render's time goes: wall time under the profiler,
    the device's busy time (the sum of its kernels and copies — one
    stream, so they do not overlap) and the busiest kernels and host ops."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        renderer.render(request)
        wall_us = (time.perf_counter() - t0) * 1e6
    stats = prof.key_averages()
    dev = [e for e in stats if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in dev)
    top = lambda evs, key: [
        {"name": e.key[:70], "count": e.count, "us": getattr(e, key)}
        for e in sorted(evs, key=lambda e: -getattr(e, key))[:8]]
    return {"profiled_wall_us": wall_us,
            "device_busy_us": busy_us if dev else "not measured",
            "device_busy_share": busy_us / wall_us if dev else None,
            "device_events": sum(e.count for e in dev),
            "top_device": top(dev, "self_device_time_total"),
            "top_host_ops": top([e for e in stats
                                 if e.device_type == DeviceType.CPU],
                                "self_cpu_time_total")}


def arm_b_params(seed: int = 0) -> dict:
    """Random (untrained) parameters at NerfConfig's defaults, with the
    reference initializer's scales, drawn from numpy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    c, h, res = 8, 64, 64
    f32 = lambda a: np.asarray(a, np.float32)
    normal = lambda rows, cols: f32(rng.standard_normal((rows, cols))
                                    / np.sqrt(rows))
    return {"table": f32(0.01 * rng.standard_normal((res**3, c))),
            "decoder": {"w1": normal(c, h), "b1": f32(np.zeros(h)),
                        "w2": normal(h, h), "b2": f32(np.zeros(h)),
                        "w_sigma": normal(h, 1),
                        "w_rgb": normal(h + 9, 3), "b_rgb": f32(np.zeros(3))}}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch import api
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.config import RenderConfig, RenderRequest
    from repro_torch.core.pipeline import orbit_trajectory
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import fused_nerf_mlp as mlp_k
    from repro_torch.kernels import gather_trilerp as gt_k
    from repro_torch.nerf import mlp, models, rays
    from repro_torch.utils import psnr

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kernels = [gt_k.KERNEL, mlp_k.KERNEL]

    # 1. the card ----------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {kind} (count {torch.cuda.device_count()})")
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all(kernels)
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{', '.join(k.name for k in kernels)}")
    for k in kernels:
        for line in k.log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {k.name}: {line.strip()}")

    # main-path inputs: the first reference chunk of each arm (the staged
    # engine renders a res-64 reference in chunks of ceil(4096 / 2) rays)
    cam = rays.Camera.square(64)
    poses = orbit_trajectory(32)
    chunk = 2048

    def chunk_points(pose_list, num_samples):
        o, d = rays.generate_rays_batch(cam, torch.stack(pose_list).to(dev))
        o, d = o[:, :chunk].reshape(-1, 3), d[:, :chunk].reshape(-1, 3)
        pts, _ = rays.sample_along_rays(o, d, 0.5, 6.0, num_samples)
        return pts.reshape(-1, 3), d.repeat_interleave(num_samples, dim=0)

    cfg_a = RenderConfig(backend="streaming")
    model_b, cfg_b_model = models.make_model("dvgo", backend="streaming",
                                             decoder="mlp")
    np_params_b = arm_b_params(0)
    params_b = params_from_numpy(np_params_b, dev)

    # 3. kernels against their plain versions -----------------------------
    errs = {"B1": 0.0, "B1_bf16": 0.0, "B2": 0.0}
    shapes = {}
    for layout in ("identity", "bank_interleaved"):
        ren = api.make_renderer(cfg_a.replace(mvoxel_layout=layout))
        scfg = ren.model.streaming_cfg
        mv_f32 = ren.params["mv_table"]
        for num_seg in (1, 4):
            pts, _ = chunk_points(poses[:num_seg], cfg_a.num_samples)
            seg = (torch.arange(num_seg, device=dev)
                   .repeat_interleave(chunk * cfg_a.num_samples))
            blocks = ops.rit_blocks(pts, scfg, seg=seg, num_seg=num_seg)
            for tag, tbl in (("f32", mv_f32),
                             ("bf16", mv_f32.to(torch.bfloat16))):
                args = (tbl, blocks.ids, blocks.weights)
                got = gt_k.gather_trilerp_mvoxels_segmented(
                    *args, num_seg=blocks.num_seg)
                want = gt_k.gather_trilerp_plain(*args, blocks.num_seg)
                key = "B1_bf16" if tag == "bf16" else "B1"
                errs[key] = max(errs[key], check_close(
                    f"B1 {layout} {tag} num_seg={num_seg} "
                    f"table {tuple(tbl.shape)} ids {tuple(blocks.ids.shape)}",
                    got, want, BF16_TOL if tag == "bf16" else F32_TOL))
                if layout == "identity" and num_seg == 1 and tag == "f32":
                    shapes["B1_A"] = args
    pts_b, dirs_b = chunk_points(poses[:1], cfg_b_model.num_samples)
    scfg_b = model_b.streaming_cfg
    prepared_b = model_b.prepare_streaming(params_b)
    blocks_b = ops.rit_blocks(pts_b, scfg_b)
    shapes["B1_B"] = (prepared_b["mv_table"], blocks_b.ids, blocks_b.weights)
    got = gt_k.gather_trilerp_mvoxels(*shapes["B1_B"])
    errs["B1"] = max(errs["B1"], check_close(
        f"B1 arm-B identity f32 table {tuple(prepared_b['mv_table'].shape)}",
        got, gt_k.gather_trilerp_plain(*shapes["B1_B"], 1), F32_TOL))
    feats_b = ops.gather_features_streaming(
        params_b["table"], pts_b, scfg_b, mv_table=prepared_b["mv_table"])
    dec = params_b["decoder"]
    mlp_args = (feats_b, mlp._dir_enc(dirs_b), dec["w1"], dec["b1"],
                dec["w2"], dec["b2"], dec["w_sigma"], dec["w_rgb"],
                dec["b_rgb"])
    shapes["B2"] = mlp_args
    errs["B2"] = check_close(
        f"B2 C=8 H=64 S={feats_b.shape[0]}", mlp_k.fused_nerf_mlp(*mlp_args),
        mlp_k.fused_nerf_mlp_plain(*mlp_args), F32_TOL)
    torch.cuda.synchronize()

    # 4. the arms, end to end ---------------------------------------------
    def run_arm(name, cfg, n_frames, model=None, np_params=None):
        arm_poses = orbit_trajectory(n_frames)
        req = RenderRequest(poses=tuple(arm_poses))
        extra = ({} if model is None else
                 dict(model=model, params=params_from_numpy(np_params, dev)))
        gpu = api.make_renderer(cfg, **extra)
        for k in kernels:
            k.launches = 0
        cold = gpu.render(req)
        launches = {k.name: k.launches for k in kernels}
        warm = gpu.render(req)
        extra_cpu = ({} if model is None else
                     dict(model=model,
                          params=params_from_numpy(np_params, "cpu")))
        cpu = api.make_renderer(cfg, device="cpu", **extra_cpu).render(req)
        frames = [f.cpu() for f in cold.frames]
        for f in frames:
            if f.shape != (cfg.res, cfg.res, 3) or not torch.isfinite(f).all():
                fail(f"arm {name}: a frame is not finite [{cfg.res}]^2 x 3")
        worst = min(float(psnr(f, c)) for f, c in zip(frames, cpu.frames))
        if worst < 40.0:
            fail(f"arm {name}: a frame is {worst:.2f} dB from the CPU run")
        sg, sc = cold.stats, cpu.stats
        if sg.reference_renders != sc.reference_renders \
                or sg.frames != sc.frames or sc.frames != n_frames:
            fail(f"arm {name}: stats differ from the CPU run ({sg} vs {sc})")
        if abs(sg.sparse_pixels - sc.sparse_pixels) > \
                0.01 * max(sc.sparse_pixels, 1):
            fail(f"arm {name}: sparse pixels {sg.sparse_pixels} vs CPU "
                 f"{sc.sparse_pixels}")
        return {"frames": n_frames, "launches": launches,
                "profile": profile_render(gpu, req),
                "min_psnr_vs_cpu_db": worst,
                "reference_renders": sg.reference_renders,
                "sparse_pixels": sg.sparse_pixels,
                "sparse_pixels_cpu": sc.sparse_pixels,
                "fallback_pixels": sg.fallback_pixels,
                "mean_hole_fraction": sg.mean_hole_fraction,
                "cold_wall_s": cold.wall_s, "warm_wall_s": warm.wall_s,
                "warm_fps": warm.fps, "cpu_wall_s": cpu.wall_s}

    arms = {"A": run_arm("A", cfg_a, 32)}
    cfg_b = RenderConfig(backend="streaming", decoder="mlp", grid_res=64,
                         channels=8, num_samples=64)
    arms["B"] = run_arm("B", cfg_b, 16, model_b, np_params_b)
    if arms["A"]["launches"]["gather_trilerp"] == 0:
        fail("arm A never launched the Gathering Unit kernel")
    if min(arms["B"]["launches"].values()) == 0:
        fail(f"arm B left a kernel unlaunched: {arms['B']['launches']}")
    for name, arm in arms.items():
        print(f"arm {name}: {json.dumps(arm)}")

    # 5. timings beside the bounds ----------------------------------------
    def b1_cost(tbl, ids, w):
        out_bytes = ids.shape[0] * ids.shape[1] * tbl.shape[2] \
            * tbl.element_size()
        nbytes = (tbl.numel() * tbl.element_size() + ids.numel() * 4
                  + w.numel() * 4 + out_bytes)
        flops = 2 * 8 * ids.shape[0] * ids.shape[1] * tbl.shape[2]
        return nbytes, flops

    def b2_cost(args):
        feats, enc = args[0], args[1]
        s, c = feats.shape
        h = args[2].shape[1]
        dcfg = mlp.DecoderCfg(in_channels=c, hidden=h)
        nbytes = 4 * (sum(t.numel() for t in args) + 4 * s)
        return nbytes, s * mlp.decoder_flops(dcfg)

    def timed(kernel_fn, plain_fn, nbytes, flops, shape):
        bound_s = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S)
        return {"shape": shape, "ms": time_ms(kernel_fn),
                "plain_ms": time_ms(plain_fn), "bound_ms": bound_s * 1e3,
                "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                             >= flops / FP32_FLOP_PER_S else "operations"),
                "bytes": nbytes, "flops": flops}

    t_b1 = [timed(lambda a=a: gt_k.gather_trilerp_mvoxels(*a),
                  lambda a=a: gt_k.gather_trilerp_plain(*a, 1),
                  *b1_cost(*a),
                  f"table {list(a[0].shape)} ids {list(a[1].shape)}")
            for a in (shapes["B1_A"], shapes["B1_B"])]
    fill = 64 * cfg_b_model.num_samples  # one pooled-fill chunk: 64 rays
    fill_args = (mlp_args[0][:fill], mlp_args[1][:fill]) + mlp_args[2:]
    t_b2 = [timed(lambda a=a: mlp_k.fused_nerf_mlp(*a),
                  lambda a=a: mlp_k.fused_nerf_mlp_plain(*a), *b2_cost(a),
                  f"S={a[0].shape[0]} C=8 H=64")
            for a in (mlp_args, fill_args)]
    card = f"{smi} (torch.cuda: {kind})"
    line = {"kernels": [
        dict(name="gather_trilerp_mvoxels_segmented (B1, Gathering Unit)",
             route="cuda", source="src/repro_torch/csrc/gather_trilerp.cu",
             replaces="src/repro/kernels/gather_trilerp.py:95",
             launches=sum(a["launches"]["gather_trilerp"]
                          for a in arms.values()),
             launches_per_arm={n: a["launches"]["gather_trilerp"]
                               for n, a in arms.items()},
             max_abs_err=errs["B1"], max_abs_err_bf16=errs["B1_bf16"],
             **{k: t_b1[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "shape")},
             library_ms=None, other_shapes=t_b1[1:], card=card),
        dict(name="fused_nerf_mlp (B2, fused radiance MLP)",
             route="cuda", source="src/repro_torch/csrc/fused_nerf_mlp.cu",
             replaces="src/repro/kernels/fused_nerf_mlp.py:54",
             launches=sum(a["launches"]["fused_nerf_mlp"]
                          for a in arms.values()),
             launches_per_arm={n: a["launches"]["fused_nerf_mlp"]
                               for n, a in arms.items()},
             max_abs_err=errs["B2"],
             **{k: t_b2[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "shape")},
             library_ms=None, other_shapes=t_b2[1:], card=card),
    ]}
    print(json.dumps(line))
    print(json.dumps({"arms_wall": {
        n: {"frames": a["frames"], "warm_wall_s": a["warm_wall_s"],
            "warm_fps": a["warm_fps"], "cold_wall_s": a["cold_wall_s"]}
        for n, a in arms.items()}, "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
