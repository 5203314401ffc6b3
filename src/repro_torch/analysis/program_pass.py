"""Tick-program pass: run the REAL tick program bodies of a tiny engine
under an op recorder and check their transfer and shape contracts (the
twin of ``repro.analysis.jaxpr_pass``).

A tiny (grid_res=16, res=16) streaming engine, a fused one and a fused
multi-scene one (2 pages and a ``scene_of_seg`` map) each make their
program once through the entry point; then the body itself,
``engine.tick_programs[key].fn()``, and admission priming,
``engine._prime_select`` (on one scene and on the paged scenes), run
again under a ``TorchDispatchMode`` that
records every op the dispatcher sees: its name, its inputs' and outputs'
shapes, dtypes and devices. The host staging outside the body (``stage``,
the pinned uploads) is not part of the program and is not recorded. The
kernels' launches go through ``ctypes``, not the dispatcher, so the pass
also counts each kernel's launches during the body (``kernels._build``).
On the CPU the bodies run the kernels' plain versions; on the card they
launch the kernels, and a copy between the host and the card shows as the
copy it is.

Rules:

- ``program-host-transfer``   ``aten._local_scalar_dense`` (a host read of
                              a tensor's value) or a copy from the card to
                              the host inside a tick program: the steady
                              tick must be pure dispatch (twin of
                              ``jaxpr-host-transfer``).
- ``program-host-upload``     a copy from the host to the card, a tensor
                              made from host data (``lift_fresh``: on the
                              card an upload, which a CUDA-graph capture
                              refuses) or any float64 tensor the body
                              makes (twin of ``jaxpr-device-put``).
- ``program-dynamic-shape``   an op whose output size depends on the data
                              (``nonzero``, ``masked_select``,
                              ``unique*``, ``bincount``, boolean-mask
                              indexing, ``repeat_interleave`` without
                              ``output_size``): a program is one fixed set
                              of shapes per key (twin of
                              ``jaxpr-dynamic-shape``).
- ``fingerprint-recompile-surface``  across a config sweep, two configs
                              whose recorded ``_prime_select`` programs
                              differ must have different ``fingerprint()``s.
- ``fingerprint-field-coverage``  every ``RenderConfig`` field reaches the
                              fingerprint or is allowlisted
                              (``core.config.verify_fingerprint_coverage``,
                              rerun here so the CLI reports it).
"""
from __future__ import annotations

import hashlib
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.findings import Finding, source_anchor
from repro_torch.utils import _tensors

ALL_RULES = ("program-host-transfer", "program-host-upload",
             "program-dynamic-shape", "fingerprint-recompile-surface",
             "fingerprint-field-coverage")

# the tiny-but-real engine every program runs on (the reference's TINY)
TINY = dict(scene="lego", res=16, window=2, grid_res=16, channels=4,
            decoder="direct", num_samples=4, backend="streaming",
            pool_holes=True)
MULTI_SCENE = ("lego", "chair")  # the two pages of the multi-scene engine

_COPIES = {"_to_copy", "copy_", "_copy_from", "_copy_from_and_resize",
           "copy"}
_UPLOADS = {"lift_fresh", "lift_fresh_copy"}
_DYNAMIC = {"nonzero", "masked_select", "unique", "unique_dim", "_unique",
            "_unique2", "unique_consecutive", "bincount", "argwhere",
            "masked_scatter"}


def _meta(ts: List[torch.Tensor]) -> Tuple:
    return tuple((tuple(t.shape), str(t.dtype).replace("torch.", ""),
                  t.device.type) for t in ts)


class OpRecorder(TorchDispatchMode):
    """Records each op the dispatcher runs inside the mode: ``ops`` holds
    ``(name, inputs, outputs, flags)``, inputs and outputs as ``(shape,
    dtype, device)``; ``flags`` names what the rules read (the source and
    destination devices of a copy, a boolean index, a
    ``repeat_interleave`` without ``output_size``)."""

    def __init__(self):
        super().__init__()
        self.ops: List[Tuple[str, Tuple, Tuple, Tuple[str, ...]]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        ins = [*_tensors(args), *_tensors(kwargs)]
        outs = list(_tensors(out))
        flags = []
        if name in _COPIES:
            src = args[1] if name in ("copy_", "_copy_from") \
                and len(args) > 1 else (args[0] if args else None)
            dst = args[0] if name == "copy_" else (outs[0] if outs else None)
            if isinstance(src, torch.Tensor) \
                    and isinstance(dst, torch.Tensor):
                flags.append(f"copy:{src.device.type}->{dst.device.type}")
        if name in ("index", "index_put", "index_put_", "_index_put_impl_"):
            idx = args[1] if len(args) > 1 else ()
            if any(isinstance(t, torch.Tensor) and t.dtype == torch.bool
                   for t in (idx or ())):
                flags.append("bool-index")
        if name == "repeat_interleave" \
                and kwargs.get("output_size") is None \
                and any(isinstance(a, torch.Tensor) for a in args[:2]) \
                and func._overloadname in ("Tensor", "self_Tensor"):
            flags.append("data-sized")
        self.ops.append((name, _meta(ins), _meta(outs), tuple(flags)))
        return out


def record(fn: Callable[[], Any]) -> Tuple[OpRecorder, Dict[str, int]]:
    """Run ``fn()`` under an :class:`OpRecorder` (no autograd); returns
    the recorder and the launches of each CUDA kernel during the call."""
    from repro_torch.kernels import _build

    before = _build.launch_snapshot()
    rec = OpRecorder()
    with torch.no_grad(), rec:
        fn()
    launches = {k.name: n for k, n, _ in _build.launches_since(before)}
    return rec, launches


def program_hash(rec: OpRecorder) -> str:
    """Structural hash of a recorded program: its op sequence with every
    input's and output's shape and dtype."""
    text = "\n".join(
        f"{name} {[m[:2] for m in ins]} -> {[m[:2] for m in outs]}"
        for name, ins, outs, _ in rec.ops)
    return hashlib.sha1(text.encode()).hexdigest()[:16]


def check_program(rec: OpRecorder, name: str, path: str,
                  line: int) -> List[Finding]:
    """Every per-program rule on one recorded program; one finding per
    (rule, op, reason) with its count."""
    hits: Dict[Tuple[str, str], int] = {}

    def hit(rule: str, what: str) -> None:
        hits[(rule, what)] = hits.get((rule, what), 0) + 1

    for op, _, outs, flags in rec.ops:
        if op == "_local_scalar_dense":
            hit("program-host-transfer",
                "aten._local_scalar_dense reads a tensor's value on the "
                "host")
        for flag in flags:
            if flag == "copy:cuda->cpu":
                hit("program-host-transfer",
                    f"aten.{op} copies from the card to the host")
            elif flag.startswith("copy:cpu->") and flag != "copy:cpu->cpu":
                hit("program-host-upload",
                    f"aten.{op} copies from the host to the card")
            elif flag == "bool-index":
                hit("program-dynamic-shape",
                    f"aten.{op} with a boolean mask index: the rows it "
                    "touches are the mask's count, a data-dependent size")
            elif flag == "data-sized":
                hit("program-dynamic-shape",
                    f"aten.{op} without output_size: the output size is "
                    "the repeats' sum")
        if op in _UPLOADS:
            hit("program-host-upload",
                f"aten.{op} makes a tensor from host data (an upload on "
                "the card, which a CUDA-graph capture refuses)")
        if op in _DYNAMIC:
            hit("program-dynamic-shape",
                f"aten.{op}: the output size depends on the data")
        if any(dtype == "float64" for _, dtype, _ in outs):
            hit("program-host-upload",
                f"aten.{op} makes a float64 tensor (a precision leak "
                "doubling the program's bytes)")
    return [Finding(rule, path, line, 0, f"{name}: {what} ({n}x)")
            for (rule, what), n in sorted(hits.items())]


# ---------------------------------------------------------------------------
# tiny-engine construction + the four serving-path programs
# ---------------------------------------------------------------------------


def build_engine(cfg, device, model=None, params=None):
    """A ``DeviceSparwEngine`` for ``cfg`` on ``device`` (the scene baked
    by ``api.make_renderer`` unless model and params are given)."""
    from repro_torch import api
    from repro_torch.core.engine import DeviceSparwEngine

    r = api.make_renderer(cfg, model=model, params=params, device=device)
    return DeviceSparwEngine(r.model, r.params, config=r.config)


def _poses(s: int, n: int, device) -> Tuple[torch.Tensor, ...]:
    """``[s, 4, 4]`` references, ``[s, n, 4, 4]`` targets and ``[s, 4, 4]``
    next references from ``s`` orbits 25 degrees apart."""
    from repro_torch.core.pipeline import orbit_trajectory

    trajs = [orbit_trajectory(n + 1, phase_deg=25.0 * i) for i in range(s)]
    ref = torch.stack([t[0] for t in trajs]).to(device)
    tgt = torch.stack([torch.stack(t[:n]) for t in trajs]).to(device)
    nxt = torch.stack([t[n] for t in trajs]).to(device)
    return ref, tgt, nxt


def _multi_scene_params(cfg, device, base_params) -> dict:
    """The stacked pages of :data:`MULTI_SCENE` (``table [2, ...]``,
    ``mv_table [2, ...]``) and a ``scene_of_seg`` map for 2 sessions,
    one on each page, as the serving engine's scene pager lays them."""
    pages = [build_engine(cfg.replace(scene=name), device).params
             for name in MULTI_SCENE]
    return dict(base_params,
                table=torch.stack([p["table"] for p in pages]),
                mv_table=torch.stack([p["mv_table"] for p in pages]),
                scene_of_seg=torch.tensor([1, 0], dtype=torch.int32,
                                          device=device))


def _prime_args(eng, s: int, device) -> Tuple:
    h, w = eng.cam.height, eng.cam.width
    ref, _, _ = _poses(s, 1, device)
    mask = torch.ones((s,), dtype=torch.bool, device=device)
    return (eng.params, ref, mask, torch.zeros((s, h, w, 3), device=device),
            torch.zeros((s, h, w), device=device))


def serving_programs(device) -> Dict[str, Tuple[Callable, Any]]:
    """The reference's four programs, and admission priming over the paged
    scenes (on the card, kernel B4's path), each made once through its
    entry point: name -> (the body to run, the engine method to anchor
    findings at)."""
    from repro_torch.core.config import RenderConfig
    from repro_torch.core.engine import DeviceSparwEngine

    cfg = RenderConfig(**TINY, device=str(device)).resolved()
    eng = build_engine(cfg, device)
    n = cfg.window
    programs = {}
    ref, tgt, nxt = _poses(1, n, device)
    eng.render_windows(ref, tgt)
    programs["render_windows"] = (
        next(iter(eng.tick_programs.values())).fn,
        DeviceSparwEngine._render_windows)
    cfg_f = cfg.replace(fused_tick=True)
    eng_f = DeviceSparwEngine(eng.model, eng.params, config=cfg_f)
    rgb, dep = eng_f.prime_reference(ref)
    eng_f.render_windows_streaming(rgb, dep, ref, tgt, nxt)
    programs["render_windows_streaming"] = (
        next(iter(eng_f.tick_programs.values())).fn,
        DeviceSparwEngine._tick_streaming)
    # the serving engine's stacked scene pages, steered per segment by the
    # scene_of_seg map: the same fused tick must stay transfer-free
    eng_m = DeviceSparwEngine(
        eng.model, _multi_scene_params(cfg, device, eng.params),
        config=cfg_f)
    ref2, tgt2, nxt2 = _poses(2, n, device)
    rgb2, dep2 = eng_m.prime_reference(ref2)
    eng_m.render_windows_streaming(rgb2, dep2, ref2, tgt2, nxt2)
    programs["render_windows_streaming_multi_scene"] = (
        next(iter(eng_m.tick_programs.values())).fn,
        DeviceSparwEngine._tick_streaming)
    # admission priming, on one scene and on the paged scenes
    for name, e, s in (("prime_reference_select", eng, 1),
                       ("prime_reference_select_multi_scene", eng_m, 2)):
        args = _prime_args(e, s, device)
        with torch.no_grad():
            e._prime_select(*args)  # warm its caches as a served engine has
        programs[name] = (lambda e=e, args=args: e._prime_select(*args),
                          DeviceSparwEngine._prime_select)
    return programs


def trace_serving_programs(root, device) -> Tuple[List[Finding],
                                                   Dict[str, Any]]:
    """Record the staged tick, the fused tick (one scene and paged) and
    admission priming of a tiny real engine; run every per-program rule
    on each."""
    findings: List[Finding] = []
    stats: Dict[str, Any] = {"device": str(device), "programs": {}}
    for name, (body, method) in serving_programs(device).items():
        rec, launches = record(body)
        path, line = source_anchor(method, root)
        fs = check_program(rec, name, path, line)
        findings.extend(fs)
        stats["programs"][name] = {
            "ops": len(rec.ops),
            "program_hash": program_hash(rec),
            "launches": launches,
            "transfer_free": not any(
                f.rule in ("program-host-transfer", "program-host-upload")
                for f in fs),
        }
    progs = stats["programs"]
    stats["steady_tick_transfer_free"] = (
        progs["render_windows_streaming"]["transfer_free"]
        and progs["render_windows_streaming_multi_scene"]["transfer_free"])
    return findings, stats


# ---------------------------------------------------------------------------
# fingerprint sweep: program drift must imply fingerprint drift
# ---------------------------------------------------------------------------

# fields swept because each reshapes the admission-priming program (sample
# count, frame size, chunking, grid resolution)
SWEEP = (dict(), dict(num_samples=8), dict(res=24), dict(ray_chunk=2048),
         dict(grid_res=24))


def check_recompile_surface(variants, fingerprint_of, trace_of,
                            path: str = "src/repro_torch/core/config.py",
                            line: int = 1) -> List[Finding]:
    """Generic collision check: any two variants with EQUAL fingerprints
    but DIFFERENT programs is a recompile-surface escape.
    ``fingerprint_of``/``trace_of`` map a variant to its fingerprint and
    program hash (injected so fixture tests can fake them)."""
    by_fp: Dict[str, str] = {}
    out: List[Finding] = []
    for v in variants:
        fp, th = fingerprint_of(v), trace_of(v)
        prev = by_fp.setdefault(fp, th)
        if prev != th:
            out.append(Finding(
                "fingerprint-recompile-surface", path, line, 0,
                f"config variant {v!r} changes the recorded program "
                f"(hash {th}) but not the fingerprint ({fp}) — a "
                "program-shaping field escaped fingerprint()"))
    return out


def sweep_fingerprints(root, device) -> Tuple[List[Finding],
                                               Dict[str, Any]]:
    from repro_torch.core.config import RenderConfig

    def fingerprint_of(overrides):
        return RenderConfig(**{**TINY, **overrides}).fingerprint()

    def trace_of(overrides):
        cfg = RenderConfig(**{**TINY, **overrides}, device=str(device))
        eng = build_engine(cfg, device)
        args = _prime_args(eng, 1, device)
        with torch.no_grad():
            eng._prime_select(*args)  # warm the caches
        return program_hash(record(lambda: eng._prime_select(*args))[0])

    path, line = source_anchor(RenderConfig.fingerprint, root)
    findings = check_recompile_surface(SWEEP, fingerprint_of, trace_of,
                                       path=path, line=line)
    return findings, {"fingerprint_sweep_variants": len(SWEEP)}


def check_fingerprint_coverage(root=".") -> List[Finding]:
    from repro_torch.core import config as cfg_mod

    path, line = source_anchor(cfg_mod.verify_fingerprint_coverage, root)
    try:
        cfg_mod.verify_fingerprint_coverage()
    except RuntimeError as e:
        return [Finding("fingerprint-field-coverage", path, line, 0,
                        str(e))]
    return []


def run(root, device) -> Tuple[List[Finding], Dict[str, Any]]:
    findings, stats = trace_serving_programs(root, device)
    f2, s2 = sweep_fingerprints(root, device)
    findings.extend(f2)
    stats.update(s2)
    findings.extend(check_fingerprint_coverage(root))
    return findings, stats
