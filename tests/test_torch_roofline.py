"""The port's roofline (``repro_torch.roofline``: the op-by-op cost counter
and the report) against the reference's (``repro.roofline``: the HLO
walker and the report), the twins of ``tests/test_roofline.py``.

* The scanned matmul: the reference's program compiled over 8 forced host
  devices and walked (one JAX subprocess); the port's twin counted on a
  fake (2, 4) process group over meta tensors. Per-rank FLOPs equal
  exactly, ``TRIPS * 2 * 2 * 64 * 64 * 256``; the port's weighted
  collective bytes equal a hand count of its program (a scan's carry keeps
  its layout, so each trip ends in an all-reduce of the [64, 256] float32
  carry block, then the sum's float32 scalar), printed beside JAX's.
* Collective factors and dtypes; ``RooflineReport``'s terms with the
  reference's constants patched in, ``to_dict()`` value for value;
  ``model_flops`` and ``analytic_hbm_bytes`` for every registry arch x
  shape x {single, multi} axis sizes, equal to the reference's.
* The staged tick: the counter on the port's staged window at the
  reference test's tiny config (flops and bytes positive, the table read at
  least once, deterministic, bytes per frame exact).
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro.configs import SHAPES as J_SHAPES
from repro.configs import registry as j_registry
from repro.roofline import analysis as j_analysis
from repro_torch.configs import registry as t_registry
from repro_torch.configs.base import SHAPES as T_SHAPES
from repro_torch.launch import dryrun
from repro_torch.models import common
from repro_torch.models.common import P
from repro_torch.roofline import analysis, cost

ROOT = Path(__file__).resolve().parents[1]
TRIPS = 5

_JAX_WALKER = """
import os, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P, NamedSharding, Mesh
from repro.roofline import hlo_cost
mesh = Mesh(np.asarray(jax.devices()).reshape(2, 4), ("data", "model"))
TRIPS = %d
def f(x, ws):
    def body(c, w):
        h = jnp.tanh(c @ w)
        h = jax.lax.with_sharding_constraint(
            h, NamedSharding(mesh, P("data", "model")))
        return h @ w.T, None
    c, _ = jax.lax.scan(body, x, ws)
    return c.sum()
x = jax.ShapeDtypeStruct((128, 256), jnp.float32)
ws = jax.ShapeDtypeStruct((TRIPS, 256, 256), jnp.float32)
cc = jax.jit(f, in_shardings=(
    NamedSharding(mesh, P("data", None)),
    NamedSharding(mesh, P(None, None, "model")))).lower(x, ws).compile()
res = hlo_cost.analyze(cc.as_text())
print(json.dumps({k: res[k] for k in ("flops", "weighted_coll_bytes")}))
""" % TRIPS


def _scanned_matmul_counts() -> dict:
    """The twin program on rank 0 of a fake (2, 4) (data, model) mesh: x
    [128, 256] split over ``data``, ws [TRIPS, 256, 256] split over
    ``model`` on its last dim, the constraint inside the loop, the carry
    kept in x's layout at each trip's end."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    with dryrun.fake_world(8):
        mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 4),
                          mesh_dim_names=("data", "model"))
        x = DTensor.from_local(dryrun.meta((64, 256), torch.float32), mesh,
                               [Shard(0), Replicate()], run_check=False,
                               shape=(128, 256), stride=(256, 1))
        ws = DTensor.from_local(
            dryrun.meta((TRIPS, 256, 64), torch.float32), mesh,
            [Replicate(), Shard(2)], run_check=False,
            shape=(TRIPS, 256, 256), stride=(256 * 256, 256, 1))

        def f(x, ws):
            c = x
            with common.use_mesh(mesh):
                for i in range(TRIPS):
                    h = torch.tanh(c @ ws[i])
                    h = common.shard(h, P("data", "model"))
                    c = (h @ ws[i].T).redistribute(mesh, x.placements)
                return c.sum().full_tensor()

        return cost.analyze(f, x, ws)


def test_counter_exact_on_scanned_matmul_against_the_walker():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_JAX_WALKER)],
                       capture_output=True, text=True, env=env,
                       cwd=str(ROOT), timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    walker = json.loads(r.stdout.strip().splitlines()[-1])
    res = _scanned_matmul_counts()
    # per rank: two matmuls a trip, [64, 256] x [256, 64] and [64, 64] x
    # [64, 256]
    expect_flops = TRIPS * (2 * 2 * 64 * 64 * 256)
    assert res["flops"] == expect_flops == walker["flops"]
    # the port's hand count: each trip's carry all-reduced over ``model``
    # ([64, 256] float32, ring factor 2), then the float32 sum over
    # ``data``
    hand = TRIPS * 64 * 256 * 4 * 2 + 4 * 2
    print(f"weighted collective bytes: port {res['weighted_coll_bytes']}, "
          f"hand count {hand}, JAX walker {walker['weighted_coll_bytes']}")
    assert res["weighted_coll_bytes"] == hand
    assert res["coll_counts"] == {"all-reduce": TRIPS + 1}
    assert res["weighted_coll_bytes_bf16wire"] == hand / 2


def test_collective_factors_and_dtypes():
    """An all-gather with a bfloat16 [128, 64] result and a float32
    [128, 64] all-reduce (the reference's HLO snippet as functional
    collectives on a fake group of 2): result bytes by kind, the all-reduce
    weighted x2, the float32 share halved in the bf16-wire term."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol

    with dryrun.fake_world(2):
        group = dist.group.WORLD

        def f():
            ag = funcol.all_gather_tensor(
                torch.zeros(64, 64, dtype=torch.bfloat16), 0, group)
            ar = funcol.all_reduce(torch.zeros(128, 64), "sum", group)
            return ag.wait() if hasattr(ag, "wait") else ag, ar

        res = cost.analyze(f)
    assert res["coll_by_op"]["all-gather"] == 128 * 64 * 2
    assert res["coll_by_op"]["all-reduce"] == 128 * 64 * 4
    assert res["weighted_coll_bytes"] == 128 * 64 * 2 + 2 * 128 * 64 * 4
    assert res["weighted_coll_bytes_bf16wire"] == (
        res["weighted_coll_bytes"] - 128 * 64 * 4)


def _report_kw():
    return dict(arch="a", shape="s", mesh="single", num_devices=256,
                flops=197e12, bytes_accessed=819e9, coll_weighted_bytes=50e9,
                coll_by_op={}, coll_counts={}, hbm_bytes=819e9 / 2,
                model_flops_global=197e12 * 256 * 0.5)


def test_roofline_report_terms(monkeypatch):
    """The reference's ``test_roofline_report_terms`` with the v5e's
    constants patched into the port's module: every term and ``to_dict()``
    equal to the reference's report on the same numbers."""
    for name, value in (("PEAK_FLOPS_BF16", j_analysis.PEAK_FLOPS_BF16),
                        ("HBM_BW", j_analysis.HBM_BW),
                        ("LINK_BW", j_analysis.ICI_LINK_BW)):
        monkeypatch.setattr(analysis, name, value)
    r = analysis.RooflineReport(**_report_kw())
    assert abs(r.compute_s - 1.0) < 1e-9
    assert abs(r.memory_s - 0.5) < 1e-9  # the analytic model comes first
    assert abs(r.collective_s - 1.0) < 1e-9
    assert r.dominant in ("compute", "collective")
    assert abs(r.mfu - 0.5) < 1e-9
    assert abs(r.useful_flops_fraction - 0.5) < 1e-9
    assert r.to_dict() == j_analysis.RooflineReport(**_report_kw()).to_dict()


def test_constants_are_the_h100s():
    """The card's datasheet numbers, none of the reference's TPU's."""
    assert (analysis.PEAK_FLOPS_BF16, analysis.HBM_BW, analysis.LINK_BW) == (
        989.4e12, 3.35e12, 50e9)
    tpu = {j_analysis.PEAK_FLOPS_BF16, j_analysis.HBM_BW}
    assert not tpu & {analysis.PEAK_FLOPS_BF16, analysis.HBM_BW,
                      analysis.LINK_BW, analysis.NVLINK_BW}


AXES = {"single": {"data": 16, "model": 16},
        "multi": {"pod": 2, "data": 16, "model": 16}}


@pytest.mark.parametrize("arch", t_registry.list_archs())
def test_model_flops_and_analytic_hbm_bytes_match_jax(arch):
    t_cfg, j_cfg = t_registry.get(arch), j_registry.get(arch)
    for shape in T_SHAPES:
        t_shape, j_shape = T_SHAPES[shape], J_SHAPES[shape]
        assert t_shape.tokens_per_step == j_shape.tokens_per_step
        assert analysis.model_flops(t_cfg, t_shape) == \
            j_analysis.model_flops(j_cfg, j_shape)
        for sizes in AXES.values():
            for args in ((3.5e9, 1.2e9, 0.0), (2.0e8, 4.0e8, 3.0e8)):
                assert analysis.analytic_hbm_bytes(t_cfg, t_shape, sizes,
                                                   *args) == \
                    j_analysis.analytic_hbm_bytes(j_cfg, j_shape, sizes,
                                                  *args)


def test_report_from_counts():
    """``from_counts`` carries the counter's keys and the memory into the
    report's fields."""
    counts = {"flops": 10.0, "bytes": 20.0, "weighted_coll_bytes": 6.0,
              "weighted_coll_bytes_bf16wire": 4.0,
              "coll_by_op": {"all-reduce": 3.0},
              "coll_counts": {"all-reduce": 1}}
    r = analysis.from_counts("a", "s", "single", 4, counts,
                             {"arg_bytes": 7, "output_bytes": 5,
                              "alias_bytes": 2}, model_flops_global=20.0)
    assert (r.flops, r.bytes_accessed, r.coll_weighted_bytes,
            r.coll_bf16wire_bytes) == (10.0, 20.0, 6.0, 4.0)
    assert (r.arg_bytes, r.output_bytes, r.alias_bytes, r.temp_bytes) == (
        7, 5, 2, 0)
    assert r.useful_flops_fraction == 0.5


def test_counter_on_staged_tick():
    """The twin of the reference's ``test_analyze_compiled_on_flat_core
    _tick``: the counter on the port's staged window (one session, two
    targets) at the same tiny config counts positive FLOPs, reads the
    feature table (grid 16^3 x 4 channels x 4 bytes) at least once, is
    deterministic across two engines (after a first one has built the
    cached constants), leaves the frames as they are, and divides by the
    frames exactly."""
    from repro_torch import api
    from repro_torch.core.config import RenderConfig
    from repro_torch.core.engine import DeviceSparwEngine

    cfg = RenderConfig(scene="lego", res=16, window=2, grid_res=16,
                       channels=4, decoder="direct", num_samples=8,
                       backend="reference", pool_holes=True).resolved()
    r = api.make_renderer(cfg, device="cpu")
    refs = torch.eye(4)[None]
    tgts = torch.stack([torch.eye(4)] * 2)[None]

    def run():
        eng = DeviceSparwEngine(r.model, r.params, config=cfg)
        out, res = cost.measure(eng.render_windows, refs, tgts)
        return out.frames, res

    # a first engine builds the per-device constants every later one reads
    # (``scenes._consts``, ``grids.corners``), so it is left uncounted
    plain = DeviceSparwEngine(r.model, r.params, config=cfg).render_windows(
        refs, tgts).frames
    frames, res = run()
    assert torch.equal(frames, plain)
    assert res["flops"] > 0
    assert res["bytes"] >= 16**3 * 4 * 4
    frames2, res2 = run()
    assert (res2["flops"], res2["bytes"]) == (res["flops"], res["bytes"])
    assert cost.bytes_moved_per_frame(res, 2) == res["bytes"] / 2
    with pytest.raises(ValueError):
        cost.bytes_moved_per_frame(res, 0)
