"""repro_torch.analysis: one deliberately violating fixture per rule (each
must FIRE with the right span), the suppression machinery, parity with the
reference checker's portable rules, the launch plans of B1-B6, the CLI's
clean baseline on the CPU, and the tick-program steady-state probe."""
import dataclasses
import json
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis import astlint, cli, launch_pass, program_pass
from repro_torch.analysis.findings import Finding, Report, apply_suppressions
from repro_torch.analysis.graphprobe import GraphProbe

ROOT = Path(__file__).resolve().parents[1]


def _lint(snippet):
    return astlint.lint_source(textwrap.dedent(snippet), "fixture.py")


def _only(findings, rule):
    return [f for f in findings if f.rule == rule]


def _line_of(snippet, needle):
    for i, ln in enumerate(textwrap.dedent(snippet).splitlines(), 1):
        if needle in ln:
            return i
    raise AssertionError(f"{needle!r} not in fixture")


# ---------------------------------------------------------------------------
# AST rules — every rule fires on its violating snippet, right span
# ---------------------------------------------------------------------------

_ENGINE = """
import torch

class Engine:
    def _body(self, x: torch.Tensor, bucket: int):
        BODY
        return x

    def call(self, x, s, n, bucket):
        return self._program(("staged", s, n, bucket),
                             lambda: self._body(x, bucket))
"""


def _engine(body):
    return _ENGINE.replace("BODY", body)


def test_rule_graph_tensor_bool_if_fires():
    src = _engine("if torch.any(x > 0):\n            x = -x")
    fs = _only(_lint(src), "graph-tensor-bool-if")
    assert len(fs) == 1 and fs[0].line == _line_of(src, "if torch.any")
    # a tensor method in a conditional expression fires too
    src2 = _engine("x = x if x.sum() > 0 else -x")
    fs2 = _only(_lint(src2), "graph-tensor-bool-if")
    assert len(fs2) == 1 and fs2[0].line == _line_of(src2, "x.sum() > 0")


def test_rule_graph_tensor_bool_if_ignores_static_branches():
    src = _engine("if bucket == 0 and x.shape[0] > 1:\n"
                  "            x = x + 1\n"
                  "        assert x.dim() == 2")
    assert not _only(_lint(src), "graph-tensor-bool-if")


def test_rule_graph_host_sync_fires_on_reads():
    src = _engine("y = x.sum().item()\n"
                  "        z = np.asarray(x)\n"
                  "        torch.cuda.synchronize()\n"
                  "        w = x.tolist()")
    fs = _only(_lint("import numpy as np\n" + textwrap.dedent(src)),
               "graph-host-sync")
    shifted = {_line_of(src, needle) + 1 for needle in
               (".item()", "np.asarray", "synchronize", ".tolist()")}
    assert {f.line for f in fs} == shifted


def test_rule_graph_host_sync_fires_on_scalarized_tensor_name():
    src = _engine("total = torch.sum(x)\n"
                  "        k = int(total)\n"
                  "        m = int(bucket)")
    fs = _only(_lint(src), "graph-host-sync")
    assert len(fs) == 1 and fs[0].line == _line_of(src, "int(total)")
    # the annotated tensor param is one too
    fs2 = _only(_lint(_engine("k = float(x)")), "graph-host-sync")
    assert len(fs2) == 1 and "float(x)" in fs2[0].message


def test_rule_graph_host_sync_scans_cuda_graph_blocks():
    src = """
    import torch

    def capture(graph, fn):
        with torch.cuda.graph(graph):
            out = fn()
            n = out.item()
        return out
    """
    fs = _only(_lint(src), "graph-host-sync")
    assert len(fs) == 1 and fs[0].line == _line_of(src, "out.item()")
    # outside a captured body the same read is fine
    assert not _only(_lint(src.replace("with torch.cuda.graph(graph):",
                                       "if True:")), "graph-host-sync")


def test_rule_graph_key_missing_fires():
    src = """
    class Engine:
        def call(self, b, s, n, bucket, bucket_coarse):
            return self._program(("staged", s, n, bucket),
                                 lambda: self._run(b, bucket, bucket_coarse))
    """
    fs = _only(_lint(src), "graph-key-missing")
    assert len(fs) == 1 and fs[0].line == _line_of(src, "self._program(")
    assert "bucket_coarse" in fs[0].message
    ok = src.replace('("staged", s, n, bucket)',
                     '("staged", s, n, bucket, bucket_coarse)')
    assert not _only(_lint(ok), "graph-key-missing")
    # a key bound to a name first is resolved through its assignment
    named = src.replace(
        'return self._program(("staged", s, n, bucket),',
        'key = ("staged", s, n, bucket)\n'
        '            return self._program(key,')
    assert len(_only(_lint(named), "graph-key-missing")) == 1


def test_rule_raw_hash_fires_outside_dunder_hash():
    src = """
    def seed_for(scene):
        return hash(scene) % 1000

    class C:
        def __hash__(self):
            return hash(self.name)
    """
    fs = _only(_lint(src), "raw-hash")
    assert len(fs) == 1 and fs[0].line == _line_of(src, "hash(scene)")
    assert "utils.fold_seed" in fs[0].message


def test_rule_mutable_default_frozen_fires():
    src = """
    import dataclasses
    import numpy as np

    @dataclasses.dataclass(frozen=True)
    class Cfg:
        xs: list = dataclasses.field(default=[1, 2])
        arr: object = np.array([1.0])

    @dataclasses.dataclass
    class NotFrozen:
        ys: list = dataclasses.field(default=[3])
    """
    fs = _only(_lint(src), "mutable-default-frozen")
    assert {f.line for f in fs} == {_line_of(src, "xs: list"),
                                    _line_of(src, "arr: object")}


_ROUTED = """
def plain(x):
    return x

def wrapper(x):
    if x.device.type == "cpu":
        return plain(x)
    if x.device.type != "cuda":
        raise ValueError(x.device)
    return _launch(x)

def _launch(x):
    KERNEL.call("entry", x.data_ptr())
    return x
"""


def test_rule_kernel_no_plain_route_fires():
    unrouted = """
    def launch(x):
        KERNEL.call("entry", x.data_ptr())
    """
    fs = _only(_lint(unrouted), "kernel-no-plain-route")
    assert len(fs) == 1 and fs[0].line == _line_of(unrouted, "KERNEL.call")
    # routed in the function, or only called from a routed function: clean
    assert not _only(_lint(_ROUTED), "kernel-no-plain-route")
    # a second, unrouted caller of the helper breaks the proof
    assert len(_only(_lint(_ROUTED + "\ndef other(x):\n    return _launch(x)"
                           "\n"), "kernel-no-plain-route")) == 1
    # a routed launch inside a try that falls back quietly
    fallback = _ROUTED.replace(
        '    KERNEL.call("entry", x.data_ptr())',
        '    try:\n        mod.KERNEL_PER_SEG.call("entry", x.data_ptr())\n'
        '    except RuntimeError:\n        return plain(x)')
    fs = _only(_lint(fallback), "kernel-no-plain-route")
    assert len(fs) == 1 and "try" in fs[0].message
    assert fs[0].line == _line_of(fallback, "KERNEL_PER_SEG.call")
    reraise = fallback.replace("except RuntimeError:\n        return plain(x)",
                               "except RuntimeError:\n        raise")
    assert not _only(_lint(reraise), "kernel-no-plain-route")


# ---------------------------------------------------------------------------
# suppression machinery
# ---------------------------------------------------------------------------


def test_justified_suppression_suppresses(tmp_path):
    p = tmp_path / "mod.py"
    p.write_text("x = 1\n"
                 "# lint: disable=raw-hash -- fixture justification\n"
                 "y = hash('k')\n")
    fs = apply_suppressions(
        [Finding("raw-hash", "mod.py", 3, 4, "m")], tmp_path)
    assert fs[0].suppressed and fs[0].justification == "fixture justification"
    rep = Report(findings=fs, rules_run=["raw-hash"])
    assert not rep.active and rep.summary()["suppressed"] == 1
    assert "repro_torch.analysis: 1 rules, 0 findings, 1 suppressed" \
        in rep.format()


def test_unjustified_suppression_does_not_suppress(tmp_path):
    p = tmp_path / "mod.py"
    p.write_text("y = hash('k')  # lint: disable=raw-hash\n"
                 "z = hash('k')  # lint: disable=mutable-default-frozen -- x\n")
    fs = apply_suppressions(
        [Finding("raw-hash", "mod.py", 1, 4, "m"),
         Finding("raw-hash", "mod.py", 2, 4, "m")], tmp_path)
    assert not fs[0].suppressed and not fs[1].suppressed  # other rule id


# ---------------------------------------------------------------------------
# program rules
# ---------------------------------------------------------------------------


def _recorded(fn):
    rec, _ = program_pass.record(fn)
    return rec


def test_rule_program_host_transfer_fires():
    x = torch.arange(4.0)
    fs = program_pass.check_program(_recorded(lambda: x.sum().item()),
                                    "leaky", "p.py", 7)
    hits = _only(fs, "program-host-transfer")
    assert len(hits) == 1 and hits[0].line == 7
    assert "leaky" in hits[0].message and "_local_scalar_dense" \
        in hits[0].message
    # a copy from the card to the host, as the recorder flags it there
    rec = program_pass.OpRecorder()
    rec.ops.append(("_to_copy", ((((4,), "float32", "cuda")),),
                    ((((4,), "float32", "cpu")),), ("copy:cuda->cpu",)))
    assert _only(program_pass.check_program(rec, "d2h", "p.py", 1),
                 "program-host-transfer")


def test_rule_program_host_upload_fires():
    x = torch.arange(4.0)
    fs = program_pass.check_program(
        _recorded(lambda: (x + torch.tensor([1.0]), x.double())), "puts",
        "p.py", 1)
    msgs = [f.message for f in _only(fs, "program-host-upload")]
    assert any("lift_fresh" in m for m in msgs)
    assert any("float64" in m for m in msgs)
    rec = program_pass.OpRecorder()
    rec.ops.append(("copy_", (), (), ("copy:cpu->cuda",)))
    assert _only(program_pass.check_program(rec, "h2d", "p.py", 1),
                 "program-host-upload")
    # a host-to-host copy is no upload
    assert not program_pass.check_program(
        _recorded(lambda: x.to(torch.float32, copy=True)), "ok", "p.py", 1)


def test_rule_program_dynamic_shape_fires():
    x = torch.arange(6.0)
    reps = torch.tensor([1, 2, 3])

    def body():
        x[x > 2]
        torch.nonzero(x)
        torch.repeat_interleave(torch.arange(3), reps)

    fs = _only(program_pass.check_program(_recorded(body), "dyn", "p.py", 1),
               "program-dynamic-shape")
    msgs = " ".join(f.message for f in fs)
    assert "boolean mask" in msgs and "nonzero" in msgs \
        and "repeat_interleave" in msgs
    # repeat_interleave with output_size, a static gather: clean
    ok = _recorded(lambda: (torch.repeat_interleave(torch.arange(3), reps,
                                                    output_size=6),
                            x[torch.arange(2)]))
    assert not _only(program_pass.check_program(ok, "ok", "p.py", 1),
                     "program-dynamic-shape")


def test_rule_recompile_surface_fires_on_fingerprint_collision():
    variants = [{"a": 1}, {"a": 2}]
    fs = program_pass.check_recompile_surface(
        variants, fingerprint_of=lambda v: "constant",
        trace_of=lambda v: f"program-{v['a']}")
    assert len(_only(fs, "fingerprint-recompile-surface")) == 1
    assert not program_pass.check_recompile_surface(
        variants, fingerprint_of=lambda v: f"fp-{v['a']}",
        trace_of=lambda v: f"program-{v['a']}")


def test_rule_fingerprint_field_coverage_fires(monkeypatch):
    from types import SimpleNamespace

    from repro_torch.core import config as cfg_mod

    assert program_pass.check_fingerprint_coverage(ROOT) == []
    ghost = SimpleNamespace(name="ghost", repr=False)
    monkeypatch.setattr(cfg_mod.dataclasses, "fields", lambda cls: [ghost])
    fs = program_pass.check_fingerprint_coverage(ROOT)
    assert len(_only(fs, "fingerprint-field-coverage")) == 1
    assert fs[0].path == "src/repro_torch/core/config.py"


def test_program_hash_sees_shapes_not_values():
    a, b, c = torch.ones(3), torch.zeros(3), torch.ones(4)
    h = lambda t: program_pass.program_hash(_recorded(lambda: t * 2))
    assert h(a) == h(b) != h(c)


# ---------------------------------------------------------------------------
# launch rules
# ---------------------------------------------------------------------------


def _launch_rec(**kw):
    base = dict(kernel="k", entry="e", case="c", grid=(2, 8, 1),
                block=(256, 1, 1), dynamic_smem=1024,
                cover=(("rows", 512, ("block", 0), ("grid", 0), False),),
                exact=(("MVoxels", ("grid", 1), 8),), path="kern.py", line=5)
    base.update(kw)
    return launch_pass.LaunchRecord(**base)


def test_rule_kernel_launch_coverage_fires():
    assert not launch_pass.check_launch(_launch_rec())
    for bad in (dict(grid=(1, 8, 1)),  # 256 of 512 rows
                dict(grid=(3, 8, 1)),  # a CTA column past the rows
                dict(grid=(2, 7, 1))):  # one MVoxel without a CTA row
        fs = _only(launch_pass.check_launch(_launch_rec(**bad)),
                   "kernel-launch-coverage")
        assert len(fs) == 1 and fs[0].line == 5
    stride = _launch_rec(cover=(("tiles", 100, ("const", 8), ("grid", 0),
                                 True),), exact=())
    assert not launch_pass.check_launch(stride)  # 2 CTAs stride 100 tiles
    assert _only(launch_pass.check_launch(dataclasses.replace(
        stride, grid=(14, 1, 1))), "kernel-launch-coverage")  # 13 suffice
    # a card launch that differs from its plan
    fs = launch_pass.compare_launches(
        [_launch_rec(dynamic_smem=2048)], [_launch_rec()])
    assert len(fs) == 1 and "dynamic_smem" in fs[0].message


def test_rule_kernel_smem_budget_fires():
    limit = launch_pass.SMEM_OPTIN_BYTES
    assert not launch_pass.check_launch(_launch_rec(dynamic_smem=limit - 96,
                                                    static_smem=96))
    for bad in (dict(dynamic_smem=limit, static_smem=96),
                dict(block=(1056, 1, 1)),
                dict(grid=(2, 8, 65536))):
        assert len(_only(launch_pass.check_launch(_launch_rec(**bad)),
                         "kernel-smem-budget")) == 1


def test_rule_mvoxel_bank_conflict_fires_on_broken_permutation(monkeypatch):
    from repro_torch.core import streaming

    p3 = (streaming.StreamingCfg().mvoxel_edge + 1) ** 3
    monkeypatch.setattr(streaming, "layout_row_map",
                        lambda cfg: (np.arange(p3, dtype=np.int64), p3))
    fs, _ = launch_pass.check_layouts(ROOT)
    assert _only(fs, "mvoxel-bank-conflict")
    monkeypatch.setattr(streaming, "layout_row_map",
                        lambda cfg: (np.zeros(p3, dtype=np.int64), 832))
    fs, _ = launch_pass.check_layouts(ROOT)
    assert any("not a permutation" in f.message for f in fs)


def test_plan_launches_cover_every_kernel_and_plan_branch():
    from repro_torch.kernels import fused_nerf_mlp as fm

    recs = launch_pass.plan_launches(root=ROOT)
    fs = [f for r in recs for f in launch_pass.check_launch(r)]
    assert fs == [], "\n".join(f.format() for f in fs)
    assert {r.kernel for r in recs} == set(launch_pass.KERNEL_NAMES)
    by = lambda name: [r for r in recs if r.kernel == name]
    for name in ("gather_trilerp_kernel", "fused_gather_dual_kernel"):
        assert {r.block[0] for r in by(name)} == {64, 256}  # CTA rows
        smem = {r.dynamic_smem for r in by(name)}
        assert 0 in smem and len(smem) > 1  # staged and read in place
    for name in ("gather_trilerp_per_seg_kernel",
                 "fused_gather_dual_per_seg_kernel"):
        smem = {r.dynamic_smem for r in by(name)}
        assert 0 in smem and len(smem) > 1
    b2 = [c for c in launch_pass.CASES if c["kind"] == "B2"]
    plans = {(c["h"], fm.mlp_plan(c["c"], c["h"], 9)) for c in b2}
    assert {(p.mode, p.width, p.scratch > 0) for _, p in plans} == {
        ("tensor", 64, False), ("tensor", 128, False),
        ("runtime", 160, False), ("runtime", 1024, True)}
    assert any(h != p.width for h, p in plans if p.mode == "tensor")
    assert by("fused_nerf_mlp_kernel")[0].grid == (264, 1, 1)
    b6 = {r.entry for r in recs if r.kernel.startswith("flash_")}
    assert b6 == {"flash_prefill_bf16", "flash_prefill_f32",
                  "flash_decode_split_bf16", "flash_decode_split_f32",
                  "flash_decode_combine_bf16", "flash_decode_combine_f32"}
    split = by("flash_decode_split_kernel")[0]
    assert split.grid == (11, 8, 4) and split.dynamic_smem == 67584


def test_plan_launches_name_their_launch_counts():
    """Each launch names the count its wrapper adds to (the kernel
    source's, B6's by route), and the run-time-H grid is the wrapper's."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_nerf_mlp as fm

    recs = launch_pass.plan_launches(root=ROOT)
    keys = {k.name for k in _build._KERNELS if k is not fa.KERNEL} | {
        f"{fa.KERNEL.name}.{route}" for route in fa.KERNELS}
    assert {r.counter for r in recs} == keys
    for r in recs:
        if r.counter.startswith(f"{fa.KERNEL.name}."):
            assert r.entry in fa.KERNELS[r.counter.split(".", 1)[1]]
    for case in launch_pass.CASES:
        if case["kind"] == "B2":
            plan = fm.mlp_plan(case["c"], case["h"], launch_pass.DIR_WIDTH)
            if plan.mode == "runtime":
                rec = next(r for r in recs if r.case == case["case"])
                assert rec.grid[0] == fm.rt_grid(case["s"], plan, 132)


def test_ptxas_log_and_trace_names_pair(tmp_path):
    mangled = ("_ZN51_GLOBAL__N__04cf38d3_18_flash_attention_cu_2635212325"
               "flash_decode_split_kernelI13__nv_bfloat16Li128ELb0EEEvPKT_"
               "S3_S3_PfS4_S4_iiiiiff")
    log = tmp_path / "flash_attention.log"
    log.write_text(f"ptxas info    : Compiling entry function '{mangled}' "
                   "for 'sm_90a'\nptxas info    : Used 106 registers, used "
                   "1 barriers, 96 bytes smem\n")
    table = launch_pass.ptxas_table([log])
    trace = ("void (anonymous namespace)::flash_decode_split_kernel<"
             "__nv_bfloat16, 128, false>(__nv_bfloat16 const*, float*, int)")
    key = launch_pass._demangled_targs(trace)
    assert table[key] == {"registers": 106, "static_smem": 96}
    assert launch_pass.occupancy(256, 128, 42508) == 2  # B2 at H 64
    assert launch_pass.occupancy(256, 255, 149516) == 1  # B2 at H 128


def test_recorded_launches_need_the_card():
    with pytest.raises(ValueError, match="needs a CUDA device"):
        launch_pass.recorded_launches("cpu")


# ---------------------------------------------------------------------------
# parity with the reference checker (its portable rules)
# ---------------------------------------------------------------------------

_PARITY_RULES = ("raw-hash", "mutable-default-frozen")
_PARITY_SNIPPETS = (
    """
    def seed_for(scene):
        return hash(scene) % 1000

    class C:
        def __hash__(self):
            return hash(self.name)
    """,
    """
    import dataclasses
    import numpy as np

    @dataclasses.dataclass(frozen=True)
    class Cfg:
        xs: list = dataclasses.field(default=[1, 2])
        arr: object = np.array([1.0])
        ok: tuple = (1, 2)

    @dataclasses.dataclass
    class NotFrozen:
        ys: list = dataclasses.field(default=[3])
    """,
)


def _spans(findings):
    return sorted((f.rule, f.path, f.line, f.col, f.suppressed)
                  for f in findings if f.rule in _PARITY_RULES)


@pytest.mark.parametrize("snippet", _PARITY_SNIPPETS)
def test_portable_rules_match_the_reference_on_snippets(snippet):
    from repro.analysis import astlint as ref_astlint

    src = textwrap.dedent(snippet)
    assert _spans(astlint.lint_source(src, "f.py")) == _spans(
        ref_astlint.lint_source(src, "f.py"))
    assert _spans(astlint.lint_source(src, "f.py"))


def test_portable_rules_match_the_reference_on_its_scan():
    from repro.analysis import astlint as ref_astlint
    from repro.analysis import cli as ref_cli
    from repro.analysis.findings import apply_suppressions as ref_apply

    files = ref_cli.python_files(ROOT)
    assert any(f.startswith("src/repro/") for f in files)
    ref = ref_apply(ref_astlint.lint_paths(ROOT, files), ROOT)
    port = apply_suppressions(astlint.lint_paths(ROOT, files), ROOT)
    assert _spans(port) == _spans(ref)
    assert any(f.suppressed for f in ref if f.rule in _PARITY_RULES)


def test_bank_conflict_and_row_map_match_the_reference():
    from repro.analysis import pallas_pass
    from repro.core import streaming as ref_streaming

    from repro_torch.core import streaming

    for layout in launch_pass.REGISTERED_LAYOUTS:
        assert launch_pass.recompute_bank_conflict(layout) == \
            pallas_pass.recompute_bank_conflict(layout)
    rows, padded = streaming.layout_row_map(streaming.StreamingCfg(
        layout="bank_interleaved"))
    ref_rows, ref_padded = ref_streaming.layout_row_map(
        ref_streaming.StreamingCfg(layout="bank_interleaved"))
    assert padded == ref_padded
    np.testing.assert_array_equal(rows, np.asarray(ref_rows))


# ---------------------------------------------------------------------------
# the repo's baseline: the CLI on the CPU
# ---------------------------------------------------------------------------


def test_cli_on_the_cpu_is_clean(tmp_path):
    out = tmp_path / "analysis.json"
    assert cli.main(["--root", str(ROOT), "--device", "cpu", "--json",
                     str(out)]) == 0
    s = json.loads(out.read_text())
    assert s["rules"] == 14 and s["findings"] == 0
    assert s["passes"] == ["ast", "program", "launch"]
    assert s["steady_tick_transfer_free"] is True
    progs = s["program"]["programs"]
    assert set(progs) == {"render_windows", "render_windows_streaming",
                          "render_windows_streaming_multi_scene",
                          "prime_reference_select",
                          "prime_reference_select_multi_scene"}
    assert all(p["transfer_free"] and p["ops"] > 0 for p in progs.values())
    assert len(s["launch"]["launches"]) == len(
        launch_pass.plan_launches(root=ROOT))
    assert s["seconds"] < 60  # the reference's lint budget


def test_ast_scan_covers_the_port_and_not_the_reference():
    files = cli.python_files(ROOT)
    assert "chip_smoke.py" in files and "tests/torch_ranks.py" in files
    assert "src/repro_torch/core/engine.py" in files
    assert "scripts/steady_tick_bench.py" in files
    assert not any(f.startswith("src/repro/") for f in files)
    assert "tests/test_analysis.py" not in files


# ---------------------------------------------------------------------------
# tick-program steady-state probe
# ---------------------------------------------------------------------------


def test_serving_steady_state_adds_no_tick_program():
    from repro_torch.core import pipeline
    from repro_torch.core.config import RenderConfig
    from repro_torch.nerf import models, rays, scenes
    from repro_torch.serve.render_engine import RenderServeEngine, \
        RenderSession

    model, _ = models.make_model("dvgo", grid_res=32, channels=4,
                                 decoder="direct", num_samples=16)
    params = model.init_baked(scenes.make_scene("lego"), device="cpu")
    cam = rays.Camera.square(32)
    # a pinned pool bucket: the ladder has one rung, so every program is
    # made in the warmup tick and the steady window must add none
    cfg = RenderConfig(camera=cam, num_slots=2, window=2, pool_bucket=512,
                       device="cpu")
    serve = RenderServeEngine(model, params, config=cfg)
    trajs = [pipeline.orbit_trajectory(6, step_deg=1.0, phase_deg=20.0 * i)
             for i in range(2)]
    serve.submit([RenderSession(sid=i, poses=list(t))
                  for i, t in enumerate(trajs)])
    assert serve.step()  # warmup tick: makes the batch program
    probe = GraphProbe(serve.engine)
    assert serve.engine.tick_programs and probe.new_programs() == 0
    steady = 0
    with probe.assert_no_new_programs("steady serving"):
        while serve.step():
            steady += 1
    serve.finalize()
    assert steady >= 2, "steady window too short to prove anything"
    assert probe.delta() == {"tick_programs": 0, "captures": 0}
    # a new shape makes a program, and the probe sees it
    with pytest.raises(AssertionError, match="new tick programs"):
        with probe.assert_no_new_programs():
            serve.engine.render_windows(
                torch.stack([trajs[0][0]] * 3),
                torch.stack([torch.stack(trajs[0][:2])] * 3))
