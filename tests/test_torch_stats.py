"""The paper's statistics in the port against the JAX package on the same
numpy inputs: the cost model (``core/costmodel.py``), the SRAM layout and
bank-conflict model (``core/layout.py``), the streaming module's traffic,
cache and bank statistics and ``streaming_gather``, and ``sparw``'s
``transform_points`` / ``project``.

Tolerances: integer outputs (coordinates, ids, banks, orders, counts) and
every statistic and cost-model field are equal (the same numpy arithmetic
on the same numbers, and the same integer ids, ROADMAP's rule); gathered
features are float32 sums of 8 products in another order, held at the
reference's kernel tolerance atol 2e-5 / rtol 1e-5; transformed and
projected points at atol 1e-5 / rtol 1e-6 (float32 3x3 products and a
division, ``o + R x`` in another order).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import costmodel as j_cost
from repro.core import layout as j_layout
from repro.core import sparw as j_sparw
from repro.core import streaming as j_stream
from repro.nerf import rays as j_rays
from repro_torch.core import costmodel as t_cost
from repro_torch.core import layout as t_layout
from repro_torch.core import sparw as t_sparw
from repro_torch.core import streaming as t_stream
from repro_torch.nerf import rays as t_rays

F32 = dict(atol=2e-5, rtol=1e-5)
RES = 24


def _points(n, seed, lo=-1.05, hi=1.05):
    """Uniform points, a few of them exactly on vertex planes and on the
    clip boundary (the floor's edge cases)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    grid = np.linspace(-1.0, 1.0, RES, dtype=np.float32)
    pts[:16] = rng.choice(grid, (16, 3))
    pts[16:20] = np.float32(1.0)
    pts[20:24] = np.float32(-1.0)
    return pts


def _ray_points(n_rays=64, res=16, samples=24):
    """Samples along a camera's rays: the pixel-centric access order."""
    cam = t_rays.Camera.square(res)
    o, d = t_rays.generate_rays(cam, t_rays.orbit_pose(0.5))
    o, d = o[:n_rays], d[:n_rays]
    pts, _ = t_rays.sample_along_rays(o, d, 0.5, 6.0, samples)
    return pts.reshape(-1, 3).numpy()


def _stream_cfgs():
    return [(j_stream.StreamingCfg(grid_res=RES, mvoxel_edge=e, layout=lay),
             t_stream.StreamingCfg(grid_res=RES, mvoxel_edge=e, layout=lay))
            for e in (4, 8) for lay in ("identity", "bank_interleaved")]


# ---------------------------------------------------------------------------
# streaming statistics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("res", [16, 24, 33])
def test_sample_base_coords_match_reference(res):
    pts = _points(3000, res)
    want = np.asarray(j_stream.sample_base_coords(jnp.asarray(pts), res))
    got = t_stream.sample_base_coords(torch.from_numpy(pts), res).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", range(4))
def test_halo_banks_row_map_and_conflict_factor_match_reference(k):
    j_cfg, t_cfg = _stream_cfgs()[k]
    np.testing.assert_array_equal(t_stream.halo_point_banks(t_cfg),
                                  j_stream.halo_point_banks(j_cfg))
    j_rows, j_pad = j_stream.layout_row_map(j_cfg)
    t_rows, t_pad = t_stream.layout_row_map(t_cfg)
    np.testing.assert_array_equal(t_rows, j_rows)
    assert t_pad == j_pad and t_cfg.halo_rows == j_cfg.halo_rows
    assert t_stream.bank_conflict_factor(t_cfg) == \
        j_stream.bank_conflict_factor(j_cfg)


def test_bank_conflict_factor_orders_the_layouts():
    ident, inter = (t_stream.StreamingCfg(layout=lay)
                    for lay in ("identity", "bank_interleaved"))
    assert t_stream.bank_conflict_factor(inter) == 1.0
    assert t_stream.bank_conflict_factor(ident) > 1.5


@pytest.mark.parametrize("k", [0, 1])
def test_streaming_gather_matches_reference(k):
    j_cfg, t_cfg = _stream_cfgs()[k]
    rng = np.random.default_rng(5)
    table = rng.standard_normal((RES**3, 6)).astype(np.float32)
    pts = _points(2500, 6)
    j_feats, j_order = j_stream.streaming_gather(jnp.asarray(table),
                                                 jnp.asarray(pts), j_cfg)
    t_feats, t_order = t_stream.streaming_gather(torch.from_numpy(table),
                                                 torch.from_numpy(pts), t_cfg)
    np.testing.assert_array_equal(t_order.numpy(), np.asarray(j_order))
    np.testing.assert_allclose(t_feats.numpy(), np.asarray(j_feats), **F32)


def test_vertex_stream_and_lru_stats_match_reference():
    pts = _ray_points()
    want = j_stream.vertex_access_stream(pts, RES)
    got = t_stream.vertex_access_stream(pts, RES)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (pts.shape[0] * 8,)
    for lines, per_line in ((16, 8), (64, 8), (256, 4), (1, 8)):
        assert t_stream.lru_cache_stats(got, lines, per_line) == \
            j_stream.lru_cache_stats(want, lines, per_line)


@pytest.mark.parametrize("cache_bytes", [2 * 2**20, 16 * 2**10, 64])
def test_pixel_centric_and_streaming_traffic_match_reference(cache_bytes):
    pts = _ray_points()
    for channels in (4, 12):
        assert t_stream.pixel_centric_traffic(
            pts, RES, channels, cache_bytes=cache_bytes) == \
            j_stream.pixel_centric_traffic(pts, RES, channels,
                                           cache_bytes=cache_bytes)
    for j_cfg, t_cfg in _stream_cfgs():
        j_mv = j_stream.mvoxel_ids(jnp.asarray(pts), j_cfg)
        t_mv = t_stream.mvoxel_ids(torch.from_numpy(pts), t_cfg)
        np.testing.assert_array_equal(t_mv.numpy(), np.asarray(j_mv))
        for channels in (4, 12):
            assert t_stream.streaming_traffic(t_mv, t_cfg, channels) == \
                j_stream.streaming_traffic(np.asarray(j_mv), j_cfg,
                                           channels)


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vertex_ids():
    from repro_torch.nerf import grids

    ids, _ = grids.corner_ids_weights(torch.from_numpy(_ray_points()), RES)
    return ids.numpy()


@pytest.mark.parametrize("sram", [dict(), dict(num_banks=64),
                                  dict(concurrent_rays=64),
                                  dict(ports_per_bank=2),
                                  dict(num_banks=8, concurrent_rays=12)])
def test_layout_stats_match_reference(sram, vertex_ids):
    j_cfg, t_cfg = j_layout.SramCfg(**sram), t_layout.SramCfg(**sram)
    assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
    np.testing.assert_array_equal(
        t_layout.feature_major_banks(vertex_ids, t_cfg),
        j_layout.feature_major_banks(vertex_ids, j_cfg))
    assert t_layout.bank_conflict_stats(vertex_ids, t_cfg) == \
        j_layout.bank_conflict_stats(vertex_ids, j_cfg)
    assert t_layout.channel_major_stats(vertex_ids, t_cfg) == \
        j_layout.channel_major_stats(vertex_ids, j_cfg)


def test_channel_major_view_matches_reference():
    table = np.arange(40, dtype=np.float32).reshape(10, 4)
    got = t_layout.channel_major_view(table)
    np.testing.assert_array_equal(got, j_layout.channel_major_view(table))
    assert got.flags["C_CONTIGUOUS"]


# ---------------------------------------------------------------------------
# cost model
# ---------------------------------------------------------------------------


def _traces(hole_fraction, window):
    """A FrameTrace measured with the port's statistics on one frame's
    rays, and a SparwTrace, in both packages' classes."""
    pts = _ray_points(n_rays=256, res=16, samples=32)
    channels = 12
    pc = t_stream.pixel_centric_traffic(pts, RES, channels,
                                        cache_bytes=64 * 2**10)
    scfg = t_stream.StreamingCfg(grid_res=RES)
    fs = t_stream.streaming_traffic(
        t_stream.mvoxel_ids(torch.from_numpy(pts), scfg), scfg, channels)
    ids = t_stream.vertex_access_stream(pts, RES).reshape(-1, 8)
    conflict = t_layout.bank_conflict_stats(ids, t_layout.SramCfg())
    fields = dict(num_rays=256, num_samples=pts.shape[0],
                  feat_channels=channels, mlp_flops_per_sample=2 * 5700.0,
                  pc_dram_bytes=pc["bytes"],
                  pc_streaming_fraction=pc["streaming_fraction"],
                  fs_dram_bytes=fs["bytes"],
                  sram_bytes=pts.shape[0] * 8 * channels * 4.0,
                  feature_major_slowdown=conflict["slowdown"])
    sp = dict(window=window, hole_fraction=hole_fraction, warp_pixels=256)
    return ((j_cost.FrameTrace(**fields), j_cost.SparwTrace(**sp)),
            (t_cost.FrameTrace(**fields), t_cost.SparwTrace(**sp)))


def _result(v):
    return dataclasses.asdict(v) | {"t_total": getattr(v, "t_total", None)}


HW = [dict(), dict(dram_bw_stream=51.2e9, gu_ports=4, npu_util=0.5),
      dict(wireless_bw=50e6, dram_random_factor=8.0)]


@pytest.mark.parametrize("hw_kw", HW, ids=["paper", "wider", "link"])
@pytest.mark.parametrize("hole_fraction, window", [(0.03, 16), (0.3, 4)])
def test_costmodel_matches_reference(hw_kw, hole_fraction, window):
    (j_tr, j_sp), (t_tr, t_sp) = _traces(hole_fraction, window)
    j_hw, t_hw = j_cost.HardwareCfg(**hw_kw), t_cost.HardwareCfg(**hw_kw)
    assert dataclasses.asdict(t_hw) == dataclasses.asdict(j_hw)
    for sf in (0.0, 0.4, 1.0):
        assert t_cost._dram_time(1e6, sf, t_hw) == \
            j_cost._dram_time(1e6, sf, j_hw)
        assert t_cost._dram_energy(1e6, sf, t_hw) == \
            j_cost._dram_energy(1e6, sf, j_hw)
    for gather in ("gpu", "gu_feature_major", "gu_channel_major"):
        for mlp in ("gpu", "npu"):
            for streaming in (False, True):
                kw = dict(gather=gather, mlp=mlp, streaming=streaming)
                assert _result(t_cost.full_frame_cost(t_tr, t_hw, **kw)) \
                    == _result(j_cost.full_frame_cost(j_tr, j_hw, **kw))
                for use_sparw in (False, True):
                    for remote in (False, True):
                        args = ("v", t_tr, t_sp, t_hw)
                        got = t_cost.evaluate_variant(
                            *args, use_sparw=use_sparw, remote=remote, **kw)
                        want = j_cost.evaluate_variant(
                            "v", j_tr, j_sp, j_hw, use_sparw=use_sparw,
                            remote=remote, **kw)
                        assert dataclasses.asdict(got) == \
                            dataclasses.asdict(want)
    assert _result(t_cost.warp_cost(4096, t_hw)) == \
        _result(j_cost.warp_cost(4096, j_hw))
    assert dataclasses.asdict(t_cost.remote_baseline(t_tr, t_hw)) == \
        dataclasses.asdict(j_cost.remote_baseline(j_tr, j_hw))
    for remote in (False, True):
        got = t_cost.standard_variants(t_tr, t_sp, t_hw, remote=remote)
        want = j_cost.standard_variants(j_tr, j_sp, j_hw, remote=remote)
        assert {k: dataclasses.asdict(v) for k, v in got.items()} == \
            {k: dataclasses.asdict(v) for k, v in want.items()}
    got = t_cost.gpu_software_variants(t_tr, t_sp, t_hw)
    want = j_cost.gpu_software_variants(j_tr, j_sp, j_hw)
    assert {k: dataclasses.asdict(v) for k, v in got.items()} == \
        {k: dataclasses.asdict(v) for k, v in want.items()}
    base, cicero = got["gpu_baseline"], got["cicero_sw"]
    assert cicero.speedup_over(base) == \
        want["cicero_sw"].speedup_over(want["gpu_baseline"])
    assert cicero.energy_saving_over(base) == \
        want["cicero_sw"].energy_saving_over(want["gpu_baseline"])


# ---------------------------------------------------------------------------
# sparw: transform and project
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("res", [16, 48])
def test_transform_points_and_project_match_reference(res):
    j_cam, t_cam = j_rays.Camera.square(res), t_rays.Camera.square(res)
    rng = np.random.default_rng(res)
    pts = rng.uniform(-1.5, 1.5, (4000, 3)).astype(np.float32)
    pts[:, 2] += 2.5
    pts[:8, 2] = np.float32(0.0)  # the safe-z branch
    pts[8:12, 2] = np.float32(-1e-7)
    ref_pose = np.array(j_rays.orbit_pose(jnp.asarray(0.3)))
    tgt_pose = np.array(j_rays.orbit_pose(jnp.asarray(0.45),
                                            wobble=0.1))
    want = j_sparw.transform_points(jnp.asarray(pts), jnp.asarray(ref_pose),
                                    jnp.asarray(tgt_pose))
    got = t_sparw.transform_points(torch.from_numpy(pts),
                                   torch.from_numpy(ref_pose),
                                   torch.from_numpy(tgt_pose))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-6)
    for g, w in zip(t_sparw.project(torch.from_numpy(pts), t_cam),
                    j_sparw.project(jnp.asarray(pts), j_cam)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-6)
