"""Multi-pod dry-run: one step of every (arch x shape x mesh) cell, traced
without memory (port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell over 512 forced host devices
on ``ShapeDtypeStruct``s and reads FLOPs, bytes and collectives from the
compiled SPMD module. The port's twin runs the cell's step once as rank 0
of torch's fake process group (256 or 512 ranks, no communication) on the
production mesh (:func:`repro_torch.launch.mesh.make_production_mesh`),
its params, AdamW moments, caches and batch DTensors laid out by the spec
trees (the strict guard) over meta tensors: every block has its shape and
dtype and no memory, so a 400B model "fits", nothing is compiled and no
device memory is allocated. The step runs under the mesh context
(:func:`~repro_torch.models.common.use_mesh`: the activation constraints
and MoE's expert-parallel branch bind) and under
:class:`repro_torch.roofline.cost.CostCounter`, which counts what rank 0
executes: its local ops, its collectives. Kernel B6 runs through its
operator's DTensor rule and fake implementation.

Memory is rank 0's blocks: ``arg_bytes`` the args' (params, moments,
batch, caches), ``output_bytes`` the outputs' in their layouts,
``alias_bytes`` the donated args' (a train step's params and moments, a
decode step's caches, which the step writes in place); ``temp_bytes``
stays 0 (the peak of live temporaries is not counted).

Per cell this writes ``runs/dryrun_torch/<mesh>/<arch>__<shape>.json`` (the
roofline report, :mod:`repro_torch.roofline.analysis`) and prints the
reference's one-line summary.

Usage (the mesh's device type is the card's unless ``--device cpu``):
  python -m repro_torch.launch.dryrun --arch qwen2.5-32b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both]
  python -m repro_torch.launch.dryrun --arch cicero-dvgo --mesh single --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, Iterator, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import registry
from repro_torch.configs.base import NERF_SHAPES, SHAPES, ModelConfig, \
    ShapeConfig
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import common, lm
from repro_torch.models.common import P, dtype_of
from repro_torch.optim.adamw import tree_flatten
from repro_torch.parallel.sharding import apply_strategy, default_strategy, \
    local_block, named_sharding, sharding_tree
from repro_torch.roofline import analysis, cost
from repro_torch.utils import DeviceLike, human_bytes, resolve_device

RUNS = Path(__file__).resolve().parents[3] / "runs" / "dryrun_torch"
DP = ("pod", "data")
NERF_ARCHS = ("cicero-dvgo", "cicero-ngp", "cicero-tensorf")


def meta(shape, dtype) -> torch.Tensor:
    """The twin of ``jax.ShapeDtypeStruct``: a tensor with no memory."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, *, train: bool
                ) -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len
    dt = dtype_of(cfg.dtype)
    batch = {"tokens": meta((b, s), torch.int32)}
    if train:
        batch["targets"] = meta((b, s), torch.int32)
    if cfg.encoder_layers > 0:
        batch["frame_embeds"] = meta((b, cfg.enc_seq_len, cfg.d_model), dt)
    if cfg.num_image_tokens > 0:
        batch["image_embeds"] = meta((b, cfg.num_image_tokens, cfg.d_model),
                                     dt)
    return batch


def _batch_pspec(cfg: ModelConfig, batch: dict, mesh) -> dict:
    """The batch's placements: its leading dim over (pod, data), strict."""
    spec = {k: P(DP, *([None] * (v.dim() - 1))) for k, v in batch.items()}
    return sharding_tree(spec, batch, mesh, strict=True)


@dataclasses.dataclass
class Cell:
    """A cell's step and its layout: ``fn(*args)``; ``args`` trees of meta
    tensors with their global shapes and ``in_sh`` their shardings; the
    outputs laid out as ``out_sh`` (None: as the step leaves them);
    ``donate`` the indices of the args the step writes in place."""

    fn: Any
    args: tuple
    in_sh: tuple
    out_sh: Any
    donate: tuple = ()
    strategy: str = "tp"
    cfg: Optional[ModelConfig] = None


def _strategy(cfg: ModelConfig, shape: ShapeConfig,
              overrides: Optional[dict]) -> str:
    """The reference's rule: the config's strategy where it names one (or
    an override sets it), else ``default_strategy``; serving keeps the TP
    and sequence-split cache layouts, so ``fsdp`` becomes ``tp`` there."""
    strategy = (cfg.sharding_strategy if cfg.sharding_strategy != "tp"
                or (overrides and "sharding_strategy" in overrides)
                else default_strategy(cfg))
    if strategy == "fsdp" and shape.kind != "train":
        strategy = "tp"
    return strategy


def build_lm_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
                  moe_dispatch: Optional[str] = None,
                  overrides: Optional[dict] = None) -> Cell:
    if moe_dispatch:
        cfg = cfg.with_(moe_dispatch=moe_dispatch)
    if overrides:
        cfg = cfg.with_(**overrides)
    params = lm.param_shapes(cfg)
    strategy = _strategy(cfg, shape, overrides)
    pspecs = sharding_tree(apply_strategy(lm.param_specs(cfg), params,
                                          strategy), params, mesh,
                           strict=True)
    repl = named_sharding(mesh, P(), ())

    if shape.kind == "train":
        leaves, unflatten = tree_flatten(params)
        moment = lambda: unflatten([meta(t.shape, torch.float32)
                                    for t in leaves])
        opt = {"m": moment(), "v": moment()}
        batch = batch_specs(cfg, shape, train=True)
        fn = lm.make_train_step(cfg)
        return Cell(fn, (params, opt, batch, 0),
                    (pspecs, {"m": pspecs, "v": pspecs},
                     _batch_pspec(cfg, batch, mesh), None),
                    (pspecs, {"m": pspecs, "v": pspecs},
                     {k: repl for k in ("ce", "aux", "loss", "lr")}),
                    (0, 1), strategy, cfg)

    lspec = named_sharding(mesh, P(DP, "model"),
                           (shape.global_batch, cfg.vocab_size))
    if shape.kind == "prefill":
        batch = batch_specs(cfg, shape, train=False)
        caches = lm.cache_init(cfg, shape.global_batch, shape.seq_len,
                               device="meta")
        cspecs = sharding_tree(lm.cache_specs(cfg), caches, mesh)
        fn = lm.make_prefill_step(cfg, cache_len=shape.seq_len)
        return Cell(fn, (params, batch), (pspecs, _batch_pspec(cfg, batch,
                                                                mesh)),
                    (lspec, cspecs), (), strategy, cfg)

    # decode: one new token against a seq_len KV cache (full: the token at
    # the cache's last position attends over every key)
    shard_seq = shape.seq_len >= (1 << 19)  # long-context cells only
    caches = lm.cache_init(cfg, shape.global_batch, shape.seq_len,
                           device="meta")
    cspecs = sharding_tree(lm.cache_specs(cfg, shard_seq=shard_seq), caches,
                           mesh)
    token = meta((shape.global_batch, 1), torch.int32)
    tok_spec = named_sharding(mesh, P(DP, None), token.shape)
    fn = lm.make_decode_step(cfg)
    return Cell(fn, (params, caches, token, shape.seq_len - 1),
                (pspecs, cspecs, tok_spec, None), (lspec, cspecs), (1,),
                strategy, cfg)


def _nerf_shapes(model) -> dict:
    """The NeRF model's params as meta tensors: its init run under a fake
    tensor mode (no memory), each leaf's shape and dtype kept."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        fake = model.init(torch.Generator(), device="cpu")
    leaves, unflatten = tree_flatten(fake)
    return unflatten([meta(t.shape, t.dtype) for t in leaves])


def build_nerf_cell(arch: str, mesh, table_sharding: str = "model",
                    table_dtype=None) -> Cell:
    """``render_rays`` of the paper's own models on the reference backend:
    an 800 x 800 frame's rays over every mesh axis, each table of at least
    4,096 rows split over ``model`` (or replicated), the decoder
    replicated; ``table_dtype`` stores those tables compactly."""
    from repro_torch.configs.cicero_nerf import NERF_CONFIGS
    from repro_torch.nerf.models import NerfModel

    model = NerfModel(dataclasses.replace(NERF_CONFIGS[arch],
                                          backend="reference"))
    params = _nerf_shapes(model)
    leaves, unflatten = tree_flatten(params)
    big = lambda t: t.dim() >= 2 and t.shape[0] >= 4096
    if table_dtype is not None:
        params = unflatten([meta(t.shape, table_dtype) if big(t) else t
                            for t in leaves])
        leaves, unflatten = tree_flatten(params)
    specs = unflatten([
        P("model", *([None] * (t.dim() - 1)))
        if table_sharding.startswith("model") and big(t)
        else P(*([None] * t.dim())) for t in leaves])
    pspecs = sharding_tree(specs, params, mesh, strict=True)
    n_rays = NERF_SHAPES["render_800"].seq_len  # 800 x 800
    every = ("pod", "data", "model")
    origins, dirs = meta((n_rays, 3), torch.float32), meta((n_rays, 3),
                                                          torch.float32)
    rspec = named_sharding(mesh, P(every), (n_rays,))
    rspec3 = named_sharding(mesh, P(every, None), (n_rays, 3))

    def render_step(params, o, d):
        """Each rank renders its own rays with every table gathered whole
        over ``model``: the rays are independent, so this is the program
        the reference's GSPMD partitions ``render_rays`` into (an
        all-gather of each split table, then rank-local work)."""
        from torch.distributed.tensor import DTensor, Replicate

        mesh = o.device_mesh
        whole = [t.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()
                 for t in tree_flatten(params)[0]]
        color, depth = model.render_rays(unflatten(whole), o.to_local(),
                                         d.to_local())
        return (DTensor.from_local(color.contiguous(), mesh, o.placements,
                                   run_check=False, shape=o.shape,
                                   stride=(3, 1)),
                DTensor.from_local(depth.contiguous(), mesh,
                                   rspec.placements,
                                   run_check=False, shape=(n_rays,),
                                   stride=(1,)))

    return Cell(render_step, (params, origins, dirs), (pspecs, rspec3,
                                                        rspec3),
                (rspec3, rspec), ())


# ---------------------------------------------------------------------------
# lay out, run, count, report
# ---------------------------------------------------------------------------


def _lay(tree, shardings):
    """Each meta leaf of ``tree`` as a DTensor laid out by its sharding
    (rank 0's block, on the meta device); a leaf without one (a host
    scalar) as it is."""
    from torch.distributed.tensor import DTensor

    if shardings is None or not isinstance(tree, (torch.Tensor, dict, list,
                                                  tuple)):
        return tree
    if isinstance(tree, torch.Tensor):
        local, _ = local_block(shardings, tuple(tree.shape))
        return DTensor.from_local(
            meta(local, tree.dtype), shardings.mesh,
            list(shardings.placements), run_check=False, shape=tree.shape,
            stride=tree.stride())
    if isinstance(tree, dict):
        return {k: _lay(v, shardings[k]) for k, v in tree.items()}
    out = [_lay(v, s) for v, s in zip(tree, shardings)]
    return (type(tree)(*out) if hasattr(tree, "_fields")
            else type(tree)(out))


def _relay(tree, shardings):
    """The step's outputs redistributed to their out-shardings."""
    if shardings is None or not isinstance(tree, (torch.Tensor, dict, list,
                                                  tuple)):
        return tree
    if isinstance(tree, torch.Tensor):
        if not common.is_dtensor(tree):
            return tree
        return tree.redistribute(shardings.mesh, list(shardings.placements))
    if isinstance(tree, dict):
        return {k: _relay(v, shardings.get(k) if isinstance(shardings, dict)
                          else None) for k, v in tree.items()}
    out = [_relay(v, s) for v, s in zip(tree, shardings)]
    return (type(tree)(*out) if hasattr(tree, "_fields")
            else type(tree)(out))


def local_bytes(tree) -> int:
    """The bytes of rank 0's blocks of every tensor of ``tree``."""
    total = 0
    for t in tree_flatten(tree)[0] if not isinstance(tree, torch.Tensor) \
            else [tree]:
        if isinstance(t, torch.Tensor):
            loc = t.to_local() if common.is_dtensor(t) else t
            total += loc.numel() * loc.element_size()
    return total


@contextlib.contextmanager
def fake_world(size: int) -> Iterator[None]:
    """Rank 0 of a fake process group of ``size`` ranks (no communication)
    for the body, unless a process group exists already."""
    if dist.is_initialized():
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def trace_cell(cell: Cell, mesh) -> dict:
    """Run ``cell`` once on its laid-out args under the mesh context and
    the cost counter; its counts, rank 0's memory and the trace's
    seconds."""
    previous = common.get_strategy()
    common.set_strategy(cell.strategy)
    t0 = time.perf_counter()
    try:
        args = tuple(_lay(a, s) for a, s in zip(cell.args, cell.in_sh))
        with common.use_mesh(mesh), cost.CostCounter() as counter:
            out = _relay(cell.fn(*args), cell.out_sh)
    finally:
        common.set_strategy(previous)
    memory = {"arg_bytes": local_bytes(args),
              "output_bytes": local_bytes(out),
              "alias_bytes": sum(local_bytes(args[i]) for i in cell.donate),
              "temp_bytes": 0}
    return {"counts": counter.result(), "memory": memory, "args": args,
            "out": out, "trace_s": time.perf_counter() - t0}


def run_cell(arch: str, shape_name: str, mesh_name: str,
             moe_dispatch: Optional[str] = None,
             out_path: Optional[Path] = None,
             overrides: Optional[dict] = None,
             nerf_table_sharding: str = "model",
             device: DeviceLike = None) -> dict:
    """One cell on the (16, 16) (``single``) or (2, 16, 16) (``multi``)
    production mesh of ``device``'s type (default: the card's): its report
    as a dict, written to ``out_path`` when given."""
    multi = mesh_name == "multi"
    kind = resolve_device(device).type
    with fake_world(512 if multi else 256):
        mesh = make_production_mesh(multi_pod=multi, device=kind)
        is_nerf = arch.startswith("cicero-")
        if is_nerf:
            cell = build_nerf_cell(
                arch, mesh, table_sharding=nerf_table_sharding,
                table_dtype=torch.bfloat16
                if nerf_table_sharding.endswith("bf16") else None)
            mflops, cfg, shape_name = 0.0, None, "render_800"
        else:
            cfg = registry.get(arch)
            shape = SHAPES[shape_name]
            if shape_name in cfg.skip_shapes:
                raise SystemExit(f"SKIP {arch}/{shape_name}: needs "
                                 "sub-quadratic attention")
            cell = build_lm_cell(cfg, shape, mesh, moe_dispatch, overrides)
            cfg = cell.cfg
            mflops = analysis.model_flops(cfg, shape)
        res = trace_cell(cell, mesh)
        axis_sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
        param_bytes = local_bytes(res["args"][0])
    report = analysis.from_counts(
        arch, shape_name, mesh_name, math.prod(mesh.shape), res["counts"],
        res["memory"], model_flops_global=mflops,
        notes=f"moe_dispatch={moe_dispatch or (cfg.moe_dispatch if cfg else '-')}"
              f" strategy={cell.strategy} device={kind}")
    if cfg is not None:
        report.hbm_bytes = analysis.analytic_hbm_bytes(
            cfg, SHAPES[shape_name], axis_sizes, report.arg_bytes,
            report.output_bytes, report.alias_bytes)
    d = report.to_dict()
    d.update(trace_s=round(res["trace_s"], 2), param_bytes=param_bytes)
    print(f"[{arch} × {d['shape']} × {mesh_name}] "
          f"trace={res['trace_s']:.1f}s  "
          f"args/dev={human_bytes(d['arg_bytes'])}  "
          f"temp/dev={human_bytes(d['temp_bytes'])}  "
          f"flops/dev={d['flops']:.3e}  bytes/dev={d['bytes_accessed']:.3e}  "
          f"coll/dev={human_bytes(d['coll_weighted_bytes'])}  "
          f"dominant={d['dominant']}  step={d['step_time_s']*1e3:.2f}ms  "
          f"MFU={d['mfu']*100:.1f}%")
    print("  memory:", res["memory"])
    print("  collectives:", d["coll_counts"])
    if out_path:
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(d, indent=1))
    return d


def default_out(arch, shape_name, mesh_name, tag="") -> Path:
    return RUNS / mesh_name / f"{arch}__{shape_name}{tag}.json"


def run_all(mesh_names, include_nerf: bool = True,
            skip_existing: bool = True, device: Optional[str] = None
            ) -> None:
    """Every cell, each in a subprocess of its own (one bad cell does not
    end the run)."""
    cells = []
    for mesh_name in mesh_names:
        for arch, shape_name in registry.runnable_cells():
            cells.append((arch, shape_name, mesh_name))
        if include_nerf:
            for arch in NERF_ARCHS:
                cells.append((arch, "render_800", mesh_name))
    todo = [(a, s, m, default_out(a, s, m)) for a, s, m in cells]
    todo = [c for c in todo if not (skip_existing and c[3].exists())]
    print(f"dry-run --all: {len(todo)} cells to go "
          f"({len(cells) - len(todo)} cached)")
    fails = []
    for i, (arch, shape_name, mesh_name, out) in enumerate(todo):
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape_name, "--mesh", mesh_name, "--out",
               str(out)] + (["--device", device] if device else [])
        print(f"--- [{i+1}/{len(todo)}] {arch} × {shape_name} × {mesh_name}")
        r = subprocess.run(cmd, capture_output=True, text=True)
        sys.stdout.write(r.stdout)
        if r.returncode != 0:
            sys.stdout.write(r.stderr[-2000:])
            fails.append((arch, shape_name, mesh_name))
    print(f"dry-run --all done; {len(fails)} failures: {fails}")


def _overrides(pairs) -> dict:
    out = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        out[k] = v
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--moe-dispatch", default=None,
                    choices=[None, "einsum", "streaming"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-skip-existing", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value")
    ap.add_argument("--nerf-table", default="model",
                    choices=["model", "replicated", "replicated_bf16"])
    ap.add_argument("--device", default=None,
                    help="the mesh's device type (default: the card; "
                         "'cpu' without one)")
    args = ap.parse_args(argv)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        run_all(meshes, skip_existing=not args.no_skip_existing,
                device=args.device)
        return
    for mesh_name in meshes:
        shape = "render_800" if args.arch.startswith("cicero-") \
            else args.shape
        out = Path(args.out) if args.out else default_out(
            args.arch, shape, mesh_name)
        run_cell(args.arch, args.shape, mesh_name,
                 moe_dispatch=args.moe_dispatch, out_path=out,
                 overrides=_overrides(args.set) or None,
                 nerf_table_sharding=args.nerf_table, device=args.device)


if __name__ == "__main__":
    main()
