"""Slice 2 of the port, the fused streaming tick: kernel B3's plain version,
the dual-RIT gather, the analytic traffic counts, one streaming tick and
the fused trajectory, each against the JAX package (interpret-mode Pallas)
on the same numpy inputs (B3 also at blocks over 32 channels and over
one H100 block's shared memory); plus the port's own fused == staged and
bank_interleaved == identity contracts and the ``fused_tick`` config
validation."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as j_api
from repro.core import config as j_config
from repro.core import pipeline as j_pipeline
from repro.core import streaming as j_streaming
from repro.core.engine import DeviceSparwEngine as JEngine
from repro.kernels import streaming_pipeline as j_sp
from repro_torch import api as t_api
from repro_torch.core import config as t_config
from repro_torch.core import pipeline as t_pipeline
from repro_torch.core import streaming as t_streaming
from repro_torch.core.engine import DeviceSparwEngine as TEngine
from repro_torch.kernels import streaming_pipeline as t_sp
from repro_torch.nerf import models as t_models
from repro_torch.nerf import scenes as t_scenes
from repro_torch.utils import psnr

# the reference's own kernel tolerances (tests/test_kernels.py)
F32_TOL = dict(atol=2e-5, rtol=1e-5)
BF16_TOL = dict(atol=3e-2, rtol=3e-2)
TICK_BASE = dict(scene="lego", res=24, window=2, grid_res=16, channels=4,
                 decoder="direct", num_samples=8, backend="streaming")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    return j_streaming.StreamingCfg(**kw), t_streaming.StreamingCfg(**kw)


def _rit_set(rng, rows, cap, p):
    ids = rng.integers(0, p, size=(rows, cap, 8)).astype(np.int32)
    w = rng.uniform(0.0, 1.0, size=(rows, cap, 8)).astype(np.float32)
    pad = rng.uniform(size=(rows, cap)) < 0.3  # RIT pad rows: id 0, w 0
    ids[pad] = 0
    w[pad] = 0.0
    return ids, w


@pytest.mark.parametrize("num_seg", [1, 2])
@pytest.mark.parametrize("layout", ["identity", "bank_interleaved"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_gather_dual_plain_matches_pallas(dtype, layout, num_seg):
    rng = np.random.default_rng(20 + num_seg)
    jc, _ = _cfgs(grid_res=16, capacity=32, layout=layout)
    table = rng.standard_normal((16**3, 4)).astype(np.float32)
    mv_table = np.array(j_streaming.build_mvoxel_table(jnp.asarray(table),
                                                         jc))
    num_mv, p, _ = mv_table.shape
    ids_h, w_h = _rit_set(rng, num_seg * num_mv, 32, p)
    ids_r, w_r = _rit_set(rng, num_seg * num_mv, 64, p)
    j_tab, t_tab = jnp.asarray(mv_table), torch.as_tensor(mv_table)
    if dtype == "bfloat16":
        j_tab, t_tab = j_tab.astype(jnp.bfloat16), t_tab.to(torch.bfloat16)
    want = j_sp.fused_gather_dual(
        j_tab, jnp.asarray(ids_h), jnp.asarray(w_h), jnp.asarray(ids_r),
        jnp.asarray(w_r), num_seg=num_seg, interpret=True)
    got = t_sp.fused_gather_dual(
        t_tab, torch.as_tensor(ids_h), torch.as_tensor(w_h),
        torch.as_tensor(ids_r), torch.as_tensor(w_r), num_seg=num_seg)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    for g, w in zip(got, want):
        assert g.dtype == t_tab.dtype and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, dtype=np.float32), **tol)


@pytest.mark.parametrize("edge,c", [(8, 40), (16, 12)])
def test_fused_gather_dual_plain_matches_pallas_wide_blocks(edge, c):
    """B3's plain version against the Pallas kernel (interpret mode) at the
    blocks fault C4 was about, fp32, grid 16: [729, 40] (C over 32) and
    the edge-16, C = 12 block [4913, 12] (too large for one H100 block's
    shared memory, which the kernel reads in place)."""
    rng = np.random.default_rng(edge + c)
    jc, _ = _cfgs(grid_res=16, mvoxel_edge=edge, capacity=32)
    table = rng.standard_normal((16**3, c)).astype(np.float32)
    mv_table = np.array(j_streaming.build_mvoxel_table(jnp.asarray(table),
                                                         jc))
    num_mv, p, _ = mv_table.shape
    assert p == (edge + 1) ** 3
    ids_h, w_h = _rit_set(rng, 2 * num_mv, 32, p)
    ids_r, w_r = _rit_set(rng, 2 * num_mv, 64, p)
    args = (mv_table, ids_h, w_h, ids_r, w_r)
    want = j_sp.fused_gather_dual(*(jnp.asarray(a) for a in args),
                                  num_seg=2, interpret=True)
    got = t_sp.fused_gather_dual(*(torch.as_tensor(a) for a in args),
                                 num_seg=2)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32_TOL)


def test_fused_gather_dual_takes_plain_only_for_cpu_tensors():
    rng = np.random.default_rng(0)
    ids, w = _rit_set(rng, 8, 4, 729)
    meta = lambda a: torch.as_tensor(a).to("meta")
    with pytest.raises(ValueError, match="no kernel"):
        t_sp.fused_gather_dual(meta(np.zeros((8, 729, 4), np.float32)),
                               meta(ids), meta(w), meta(ids), meta(w),
                               num_seg=1)
    assert t_sp.KERNEL.launches == 0 and t_sp.KERNEL._lib is None


def _points_and_segs(rng, n, num_seg, pile=0):
    pts = rng.uniform(-1.0, 1.0, size=(n, 3)).astype(np.float32)
    pts[:pile] = 0.01  # pile samples into one MVoxel: forces overflow
    # every fifth sample is padding (seg == num_seg): it must drop out
    seg = np.where(np.arange(n) % 5 == 4, num_seg,
                   np.arange(n) % num_seg).astype(np.int32)
    return pts, seg


@pytest.mark.parametrize("num_seg", [1, 2])
@pytest.mark.parametrize("layout", ["identity", "bank_interleaved"])
def test_rit_blocks_match_reference(layout, num_seg):
    rng = np.random.default_rng(30 + num_seg)
    jc, tc = _cfgs(grid_res=16, capacity=32, layout=layout)
    pts, seg = _points_and_segs(rng, 1500, num_seg, pile=200)
    want = j_sp._rit_blocks(jnp.asarray(pts), jnp.asarray(seg), num_seg, jc)
    got = t_sp._rit_blocks(torch.as_tensor(pts), torch.as_tensor(seg),
                           num_seg, tc)
    np.testing.assert_array_equal(got.samples.numpy(),
                                  np.asarray(want.samples))
    np.testing.assert_array_equal(got.overflow.numpy(),
                                  np.asarray(want.overflow))
    np.testing.assert_array_equal(got.ids_mv.numpy(),
                                  np.asarray(want.ids_mv))
    np.testing.assert_allclose(got.w_mv.numpy(), np.asarray(want.w_mv),
                               atol=1e-6)
    assert np.asarray(want.overflow).any()  # an overflowing bucket
    # padding samples take no capacity and never overflow, also at 1 seg
    assert not got.overflow.numpy()[seg == num_seg].any()
    assert not np.isin(np.flatnonzero(seg == num_seg),
                       got.samples.numpy()).any()


@pytest.mark.parametrize("ref_cap_factor", [2, 4])
@pytest.mark.parametrize("layout", ["identity", "bank_interleaved"])
def test_gather_features_tick_matches_reference(layout, ref_cap_factor):
    rng = np.random.default_rng(40 + ref_cap_factor)
    jc, tc = _cfgs(grid_res=16, capacity=32, layout=layout)
    table = rng.standard_normal((16**3, 4)).astype(np.float32)
    pts_h, seg_h = _points_and_segs(rng, 900, 2, pile=150)
    pts_r, seg_r = _points_and_segs(rng, 1400, 2, pile=300)
    j_tab = jnp.asarray(table)
    want = j_sp.gather_features_tick(
        j_tab, j_streaming.build_mvoxel_table(j_tab, jc), jc,
        jnp.asarray(pts_h), jnp.asarray(seg_h), jnp.asarray(pts_r),
        jnp.asarray(seg_r), num_seg=2, ref_cap_factor=ref_cap_factor,
        interpret=True)
    t_tab = torch.as_tensor(table)
    got = t_sp.gather_features_tick(
        t_tab, t_streaming.build_mvoxel_table(t_tab, tc), tc,
        torch.as_tensor(pts_h), torch.as_tensor(seg_h),
        torch.as_tensor(pts_r), torch.as_tensor(seg_r), num_seg=2,
        ref_cap_factor=ref_cap_factor)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32_TOL)


@pytest.mark.parametrize("layout", ["identity", "bank_interleaved"])
def test_tick_traffic_and_serving_sweeps_match_reference(layout):
    jc, tc = _cfgs(grid_res=48, capacity=512, layout=layout)
    for args in ((4, 1, 512, 1024), (8, 4, 256, 512)):
        assert t_sp.tick_traffic(tc, *args) == j_sp.tick_traffic(jc, *args)
    assert t_sp.halo_block_bytes(tc, 8, 2) == j_sp.halo_block_bytes(jc, 8, 2)
    for args in ((10, 2, 8.0), (0, 0, 4.0), (7, 3, 2.0)):
        assert t_sp.serving_sweeps_per_tick(*args) == \
            j_sp.serving_sweeps_per_tick(*args)


# ---------------------------------------------------------------------------
# engines: one tick, the trajectory, and the port's own contracts
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tick_setup():
    j_cfg = j_config.RenderConfig(**TICK_BASE, fused_tick=True,
                                  pallas_interpret=True)
    t_cfg = t_config.RenderConfig(**TICK_BASE, fused_tick=True)
    j_ren = j_api.make_renderer(j_cfg)
    t_ren = t_api.make_renderer(t_cfg, device="cpu")
    return j_ren, t_ren, j_cfg, t_cfg


def _poses(n, step_deg=4.0, phase_deg=0.0):
    return (j_pipeline.orbit_trajectory(n, step_deg=step_deg,
                                        phase_deg=phase_deg),
            t_pipeline.orbit_trajectory(n, step_deg=step_deg,
                                        phase_deg=phase_deg))


def test_tick_memory_stats_match_reference(tick_setup):
    j_ren, t_ren, j_cfg, t_cfg = tick_setup
    j_eng = JEngine(j_ren.model, j_ren.params, config=j_cfg)
    t_eng = TEngine(t_ren.model, t_ren.params, config=t_cfg)
    for kw in (dict(sessions=1), dict(sessions=2, window=2),
               dict(sessions=4, window=2, bucket=256),
               dict(sessions=3, window=2, bucket=0)):
        assert t_eng.tick_memory_stats(**kw) == j_eng.tick_memory_stats(**kw)


def test_render_tick_streaming_matches_reference(tick_setup):
    """One fused tick for two sessions from the same references (the JAX
    prime, handed to both): frames >= 40 dB, equal hole counts and
    overflow flags, next references allclose (the baked grids differ by
    ~1e-4 from float32 linspace ulps, see ROADMAP C)."""
    j_ren, t_ren, j_cfg, t_cfg = tick_setup
    j_eng = JEngine(j_ren.model, j_ren.params, config=j_cfg)
    t_eng = TEngine(t_ren.model, t_ren.params, config=t_cfg)
    ja, ta = _poses(5, step_deg=4.0)
    jb, tb = _poses(5, step_deg=6.0, phase_deg=40.0)
    j_ref = jnp.stack([ja[0], jb[0]])
    rgb, dep = j_eng.prime_reference(j_ref)
    j_tgt = jnp.stack([jnp.stack(ja[1:3]), jnp.stack(jb[1:3])])
    j_next = jnp.stack([ja[3], jb[3]])
    want = j_eng.render_windows_streaming(rgb, dep, j_ref, j_tgt, j_next)
    t_st = lambda ps: torch.stack(ps)
    got = t_eng.render_windows_streaming(
        torch.as_tensor(np.array(rgb)), torch.as_tensor(np.array(dep)),
        t_st([ta[0], tb[0]]), torch.stack([t_st(ta[1:3]), t_st(tb[1:3])]),
        t_st([ta[3], tb[3]]))
    np.testing.assert_array_equal(got.hole_counts.numpy(),
                                  np.asarray(want.hole_counts))
    np.testing.assert_array_equal(got.overflowed.numpy(),
                                  np.asarray(want.overflowed))
    assert np.asarray(want.hole_counts).sum() > 0
    for g, w in zip(got.frames.reshape(-1, 24, 24, 3),
                    np.asarray(want.frames).reshape(-1, 24, 24, 3)):
        assert float(psnr(g, torch.as_tensor(w))) >= 40.0
    np.testing.assert_allclose(got.next_rgb_ref.numpy(),
                               np.asarray(want.next_rgb_ref), atol=1e-3)
    np.testing.assert_allclose(got.next_dep_ref.numpy(),
                               np.asarray(want.next_dep_ref), atol=1e-3)


@pytest.mark.parametrize("case", ["plain", "rit_overflow", "dense_fallback"])
def test_fused_trajectory_matches_reference(case):
    """The fused path through the facade; RIT capacity 32 overflows into
    the fallback gather, hole_cap 8 into the dense window fallback."""
    kw = dict(TICK_BASE, fused_tick=True,
              stream_capacity=32 if case == "rit_overflow" else 512,
              hole_cap=8 if case == "dense_fallback" else None)
    j_ren = j_api.make_renderer(j_config.RenderConfig(**kw,
                                                      pallas_interpret=True))
    t_ren = t_api.make_renderer(t_config.RenderConfig(**kw), device="cpu")
    jp, tp = _poses(5)
    want = j_ren.render(j_config.RenderRequest(poses=tuple(jp)))
    got = t_ren.render(t_config.RenderRequest(poses=tuple(tp)))
    assert len(got.frames) == len(want.frames) == 5
    for g, w in zip(got.frames, want.frames):
        assert float(psnr(g, torch.as_tensor(np.array(w)))) >= 40.0
    for f in ("frames", "reference_renders", "warped_pixels",
              "sparse_pixels", "fallback_pixels", "total_pixels",
              "hole_fractions"):
        assert getattr(got.stats, f) == getattr(want.stats, f), f
    # priming render + one per tick, as in the reference
    assert got.stats.reference_renders == 1 + 3
    if case == "dense_fallback":
        assert got.stats.fallback_pixels > 0


def test_fused_trajectory_matches_staged(tick_setup):
    _, t_ren, _, t_cfg = tick_setup
    _, poses = _poses(4)
    staged = TEngine(t_ren.model, t_ren.params,
                     config=t_cfg.replace(fused_tick=False))
    fused = TEngine(t_ren.model, t_ren.params, config=t_cfg)
    fs, st_s = staged.render_trajectory(poses)
    ff, st_f = fused.render_trajectory(poses)
    assert len(fs) == len(ff) == len(poses)
    assert st_s.hole_fractions == st_f.hole_fractions
    for a, b in zip(fs, ff):
        assert float(psnr(a, b)) >= 60.0


def test_fused_trajectory_layout_bit_identical(tick_setup):
    _, t_ren, _, t_cfg = tick_setup
    _, poses = _poses(4)
    lay_model = t_models.NerfModel(dataclasses.replace(
        t_ren.model.cfg, mvoxel_layout="bank_interleaved"))
    eng_i = TEngine(t_ren.model, t_ren.params, config=t_cfg)
    eng_b = TEngine(lay_model, {"table": t_ren.params["table"],
                                "decoder": {}},
                    config=t_cfg.replace(mvoxel_layout="bank_interleaved"))
    fi, _ = eng_i.render_trajectory(poses)
    fb, _ = eng_b.render_trajectory(poses)
    for a, b in zip(fi, fb):
        assert torch.equal(a, b)


def test_fused_tick_config_validation():
    with pytest.raises(ValueError, match="backend"):
        t_config.RenderConfig(fused_tick=True, backend="reference")
    with pytest.raises(ValueError, match="pool_holes"):
        t_config.RenderConfig(fused_tick=True, backend="streaming",
                              pool_holes=False)
    with pytest.raises(ValueError, match="num_slots"):
        t_config.RenderConfig(num_slots=0)
    assert t_config.RenderConfig(fused_tick=True,
                                 backend="streaming").fused_tick
    # a config that passes validation but a model on the reference backend
    model, _ = t_models.make_model("dvgo", grid_res=16, channels=4,
                                   decoder="direct", num_samples=8)
    params = model.init_baked(t_scenes.make_scene("lego"), device="cpu")
    with pytest.raises(ValueError, match="streaming backend"):
        TEngine(model, params, config=t_config.RenderConfig(
            **TICK_BASE, fused_tick=True))
