"""Adaptive sampling in the port (``RenderConfig.adaptive_sampling``):
``sparw.warp_disagreement``, the config checks, ``render_rays`` at a
reduced sample count, the staged engine's fine/coarse pooled fill and the
serving engine's per-slot coarse controllers, each against the JAX
package (interpret-mode Pallas) on the same inputs.

A hole is "fine" (full sample budget) unless its warped 3x3 neighbourhood
holds >= 3 warped pixels whose radiance variance is at most
``adaptive_var_threshold``; the classification, so ``fine_counts``, the
statistics and the pool buckets, must match the reference exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as j_api
from repro.core import config as j_config
from repro.core import pipeline as j_pipeline
from repro.core import schedule as j_schedule
from repro.core import sparw as j_sparw
from repro.nerf import rays as j_rays
from repro.nerf import scenes as j_scenes
from repro.serve import render_engine as j_serve
from repro_torch import api as t_api
from repro_torch.core import config as t_config
from repro_torch.core import pipeline as t_pipeline
from repro_torch.core import schedule as t_schedule
from repro_torch.core import sparw as t_sparw
from repro_torch.nerf import rays as t_rays
from repro_torch.nerf import scenes as t_scenes
from repro_torch.serve import render_engine as t_serve
from repro_torch.utils import psnr

F32_TOL = dict(atol=2e-5, rtol=1e-5)
BASE = dict(scene="lego", res=32, window=4, grid_res=24, channels=4,
            decoder="direct", num_samples=16, backend="streaming",
            adaptive_sampling=True, coarse_factor=4)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def renderers():
    j_ren = j_api.make_renderer(j_config.RenderConfig(
        **BASE, pallas_interpret=True))
    t_ren = t_api.make_renderer(t_config.RenderConfig(**BASE), device="cpu")
    return j_ren, t_ren


def _stats_dict(st):
    return {k: getattr(st, k) for k in (
        "frames", "reference_renders", "warped_pixels", "sparse_pixels",
        "fallback_pixels", "total_pixels", "hole_fractions")}


@pytest.mark.parametrize("shape", [(16, 16), (2, 3, 12, 20)])
def test_warp_disagreement_matches_reference(shape):
    rng = np.random.default_rng(len(shape))
    rgb = rng.uniform(0.0, 1.0, shape + (3,)).astype(np.float32)
    holes = rng.uniform(size=shape) < 0.3
    rgb[holes] = 0.0  # warped colours are 0 at holes
    j_var, j_cnt = j_sparw.warp_disagreement(jnp.asarray(rgb),
                                             jnp.asarray(holes))
    t_var, t_cnt = t_sparw.warp_disagreement(torch.as_tensor(rgb),
                                             torch.as_tensor(holes))
    assert tuple(t_var.shape) == tuple(t_cnt.shape) == shape
    assert t_cnt.dtype == torch.int32
    np.testing.assert_array_equal(t_cnt.numpy(), np.asarray(j_cnt))
    np.testing.assert_allclose(t_var.numpy(), np.asarray(j_var), **F32_TOL)


# each bad config with the word its error message must hold, in both
# packages
BAD_CONFIGS = {
    "needs_pool_holes": (dict(adaptive_sampling=True, pool_holes=False),
                         "pool_holes"),
    "coarse_factor_below_2": (dict(coarse_factor=1), "coarse_factor"),
    "num_samples_not_divisible": (dict(adaptive_sampling=True,
                                       num_samples=30, coarse_factor=4),
                                  "divisible"),
    "with_fused_tick": (dict(adaptive_sampling=True, fused_tick=True,
                             backend="streaming"), "fused_tick"),
    "bad_mode": (dict(mode="sideways"), "mode"),
    "bad_engine": (dict(engine="gpu"), "engine"),
}


@pytest.mark.parametrize("name", list(BAD_CONFIGS))
def test_config_checks_match_reference(name):
    kw, word = BAD_CONFIGS[name]
    with pytest.raises(Exception) as j_exc:
        j_config.RenderConfig(**kw)
    with pytest.raises(Exception) as t_exc:
        t_config.RenderConfig(**kw)
    assert t_exc.type is j_exc.type
    assert word in str(j_exc.value) and word in str(t_exc.value)


@pytest.mark.parametrize("coarse", [False, True])
def test_render_rays_num_samples_matches_reference(renderers, coarse):
    """The streaming backend at the coarse pool's ``num_samples // 4``:
    its RIT is built over R * ns samples at that ns."""
    j_ren, t_ren = renderers
    ns = 4 if coarse else None
    pose = t_pipeline.orbit_trajectory(1)[0]
    j_o, j_d = j_rays.generate_rays(j_ren.cam,
                                    j_pipeline.orbit_trajectory(1)[0])
    t_o, t_d = t_rays.generate_rays(t_ren.cam, pose)
    j_col, j_dep = j_ren.model.render_rays(j_ren.params, j_o[:300],
                                           j_d[:300], num_samples=ns)
    t_col, t_dep = t_ren.model.render_rays(t_ren.params, t_o[:300],
                                           t_d[:300], num_samples=ns)
    np.testing.assert_allclose(t_col.numpy(), np.asarray(j_col), atol=1e-5)
    np.testing.assert_allclose(t_dep.numpy(), np.asarray(j_dep), atol=1e-4)


def test_adaptive_trajectory_matches_reference(renderers):
    """Staged adaptive ``render_trajectory`` (3 windows, so the fine and
    coarse controllers both observe): frames >= 40 dB from JAX's, equal
    statistics and pool buckets; then every window's ``fine_counts``
    and hole counts, and the coarse pool really takes holes."""
    j_ren, t_ren = renderers
    n_frames = 12
    j_poses = j_pipeline.orbit_trajectory(n_frames, step_deg=3.0)
    t_poses = t_pipeline.orbit_trajectory(n_frames, step_deg=3.0)
    want = j_ren.render(j_config.RenderRequest(poses=tuple(j_poses)))
    got = t_ren.render(t_config.RenderRequest(poses=tuple(t_poses)))
    assert len(got.frames) == n_frames
    for g, w in zip(got.frames, want.frames):
        assert float(psnr(g, torch.as_tensor(np.array(w)))) >= 40.0
    assert _stats_dict(got.stats) == _stats_dict(want.stats)
    j_eng = j_ren.pipeline.device_engine
    t_eng = t_ren.pipeline.device_engine
    assert t_eng.pool_buckets_used == j_eng.pool_buckets_used
    assert len(t_eng.pool_buckets_used) >= 2  # the ladder moved
    assert t_eng.pool_ladder_size == j_eng.pool_ladder_size
    coarse_total = 0
    j_plan = j_schedule.WarpSchedule(4, "offtraj").windows(j_poses)
    t_plan = t_schedule.WarpSchedule(4, "offtraj").windows(t_poses)
    for jw, tw in zip(j_plan, t_plan):
        j_res = j_eng.render_window(
            jw["ref_pose"], jnp.stack([j_poses[i] for i in jw["frames"]]))
        t_res = t_eng.render_window(
            tw["ref_pose"], torch.stack([t_poses[i] for i in tw["frames"]]))
        np.testing.assert_array_equal(t_res.hole_counts.numpy(),
                                      np.asarray(j_res.hole_counts))
        np.testing.assert_array_equal(t_res.fine_counts.numpy(),
                                      np.asarray(j_res.fine_counts))
        assert bool(t_res.overflowed) == bool(j_res.overflowed)
        coarse_total += int((t_res.hole_counts - t_res.fine_counts).sum())
    assert coarse_total > 0


def test_adaptive_serving_matches_reference(renderers):
    """3 sessions on 2 slots, staged, adaptive: per-slot coarse
    controllers; frames >= 40 dB, equal stats and pool metrics."""
    j_ren, t_ren = renderers
    j_eng = j_serve.RenderServeEngine(j_ren.model, j_ren.params,
                                      config=j_ren.config.replace(
                                          num_slots=2))
    t_eng = t_serve.RenderServeEngine(t_ren.model, t_ren.params,
                                      config=t_ren.config.replace(
                                          num_slots=2))
    mk = lambda mod, serve: [
        serve.RenderSession(sid=i, poses=list(mod.orbit_trajectory(
            6, step_deg=3.0, phase_deg=25.0 * i))) for i in range(3)]
    j_sess, t_sess = mk(j_pipeline, j_serve), mk(t_pipeline, t_serve)
    want = j_eng.run(j_sess)
    got = t_eng.run(t_sess)
    assert got["complete"] and want["complete"]
    assert got["ticks"] == want["ticks"]
    assert got["pool"]["adaptive_sampling"] is True
    for key in ("samples_per_tick", "samples_per_tick_mean",
                "samples_per_tick_fixed_cap", "utilization", "recompiles",
                "ladder_size", "enabled", "adaptive_sampling"):
        assert got["pool"][key] == want["pool"][key], key
    assert got["pool"] == want["pool"]
    assert t_eng._pool_log == j_eng._pool_log
    assert any(e["bucket_coarse"] > 0 for e in t_eng._pool_log)
    assert any(e["fine_total"] < e["hole_total"] for e in t_eng._pool_log)
    for js, ts in zip(j_sess, t_sess):
        assert _stats_dict(ts.stats) == _stats_dict(js.stats)
        for g, w in zip(ts.frames, js.frames):
            assert float(psnr(g, torch.as_tensor(np.array(w)))) >= 40.0


def test_adaptive_multi_scene_serving_matches_reference():
    """Multi-scene staged serving with adaptive sampling: both pooled
    fills gather each segment from its scene's page (kernel B4's plain
    version); 3 sessions over 2 scenes on 2 slots against JAX."""
    kw = dict(BASE, res=24, window=2, grid_res=16, num_samples=8,
              num_slots=2)
    j_ren = j_api.make_renderer(j_config.RenderConfig(
        **kw, pallas_interpret=True))
    t_ren = t_api.make_renderer(t_config.RenderConfig(**kw), device="cpu")
    loaders = {
        j_serve: lambda name: j_scenes.bake_dense_table(
            j_scenes.make_scene(name), 16, 4),
        t_serve: lambda name: t_scenes.bake_dense_table(
            t_scenes.make_scene(name), 16, 4)}
    fleet = [(0, "chair", 4, 0.0), (1, "drums", 2, 120.0),
             (2, "chair", 2, 60.0)]
    out = {}
    for ren, serve, mod in ((j_ren, j_serve, j_pipeline),
                            (t_ren, t_serve, t_pipeline)):
        eng = serve.RenderServeEngine(ren.model, ren.params,
                                      config=ren.config,
                                      scene_loader=loaders[serve])
        sess = [serve.RenderSession(sid=sid, scene=sc, poses=list(
            mod.orbit_trajectory(n, step_deg=4.0, phase_deg=ph)))
            for sid, sc, n, ph in fleet]
        out[serve] = (eng.run(sess), sess, eng)
    (want, j_sess, j_eng), (got, t_sess, t_eng) = out[j_serve], out[t_serve]
    assert got["complete"] and want["complete"]
    assert got["ticks"] == want["ticks"]
    assert got["pool"] == want["pool"]
    assert t_eng._pool_log == j_eng._pool_log
    for js, ts in zip(j_sess, t_sess):
        assert _stats_dict(ts.stats) == _stats_dict(js.stats)
        for g, w in zip(ts.frames, js.frames):
            assert float(psnr(g, torch.as_tensor(np.array(w)))) >= 40.0


def test_adaptive_mlp_decoder_matches_reference():
    """The coarse pool through the fused MLP (kernel B2's plain version)
    at num_samples // 4, random decoder weights: frames >= 40 dB from
    JAX's, equal statistics and pool buckets."""
    from repro.nerf import models as j_models
    from repro_torch.convert import params_from_numpy
    from repro_torch.nerf import models as t_models

    rng = np.random.default_rng(7)
    shapes = dict(w1=(8, 32), b1=(32,), w2=(32, 32), b2=(32,),
                  w_sigma=(32, 1), w_rgb=(41, 3), b_rgb=(3,))
    dec = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
           for k, s in shapes.items()}
    table = (0.3 * rng.standard_normal((16**3, 8))).astype(np.float32)
    mk = dict(grid_res=16, channels=8, decoder="mlp", mlp_hidden=32,
              num_samples=16, backend="streaming")
    kw = dict(BASE, res=24, grid_res=16, channels=8, decoder="mlp")
    j_ren = j_api.make_renderer(
        j_config.RenderConfig(**kw, pallas_interpret=True),
        model=j_models.make_model("dvgo", **mk)[0],
        params={"table": jnp.asarray(table),
                "decoder": {k: jnp.asarray(v) for k, v in dec.items()}})
    t_ren = t_api.make_renderer(
        t_config.RenderConfig(**kw), model=t_models.make_model("dvgo",
                                                               **mk)[0],
        params=params_from_numpy({"table": table, "decoder": dec}, "cpu"),
        device="cpu")
    want = j_ren.render(j_config.RenderRequest(poses=tuple(
        j_pipeline.orbit_trajectory(12, step_deg=3.0))))
    got = t_ren.render(t_config.RenderRequest(poses=tuple(
        t_pipeline.orbit_trajectory(12, step_deg=3.0))))
    for g, w in zip(got.frames, want.frames):
        assert float(psnr(g, torch.as_tensor(np.array(w)))) >= 40.0
    assert _stats_dict(got.stats) == _stats_dict(want.stats)
    assert t_ren.pipeline.device_engine.pool_buckets_used == \
        j_ren.pipeline.device_engine.pool_buckets_used
