"""The paper's baselines in the port: the per-frame host loop
(``engine="host"``), TEMP-N (``mode="temporal"``, which warps from the
previously rendered frame) and DS-2 (half resolution, bilinear x2), with
``WarpSchedule.plan`` and the renderer's engine LRU, each against the JAX
package (interpret-mode Pallas) on the same trajectory."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as j_api
from repro.core import config as j_config
from repro.core import pipeline as j_pipeline
from repro.core import schedule as j_schedule
from repro_torch import api as t_api
from repro_torch.core import config as t_config
from repro_torch.core import pipeline as t_pipeline
from repro_torch.core import schedule as t_schedule
from repro_torch.utils import psnr

BASE = dict(scene="lego", res=32, window=4, grid_res=24, channels=4,
            decoder="direct", num_samples=16, backend="streaming")
N_FRAMES = 8


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


def _poses():
    return (j_pipeline.orbit_trajectory(N_FRAMES, step_deg=3.0),
            t_pipeline.orbit_trajectory(N_FRAMES, step_deg=3.0))


def _stats_dict(st):
    return {k: getattr(st, k) for k in (
        "frames", "reference_renders", "warped_pixels", "sparse_pixels",
        "fallback_pixels", "total_pixels", "hole_fractions")}


@pytest.mark.parametrize("mode", ["offtraj", "temporal"])
def test_warp_schedule_plan_matches_reference(mode):
    j_poses, t_poses = _poses()
    want = j_schedule.WarpSchedule(3, mode).plan(j_poses)
    got = t_schedule.WarpSchedule(3, mode).plan(t_poses)
    assert len(got) == len(want) == N_FRAMES
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("frame", "window_start", "ref_frame_idx"):
            assert g[k] == w[k], k
        np.testing.assert_allclose(g["ref_pose"].numpy(),
                                   np.asarray(w["ref_pose"]), atol=1e-5)


@pytest.mark.parametrize("mode", ["offtraj", "temporal"])
def test_host_loop_matches_reference(renderers, mode):
    """``engine="host"`` offtraj SpaRW and TEMP-N: frames >= 40 dB from
    JAX's and equal statistics; TEMP-N's later windows reuse the previous
    rendered frame, so it counts one reference render."""
    j_ren, t_ren = renderers
    j_poses, t_poses = _poses()
    j_cfg = j_ren.config.replace(engine="host", mode=mode)
    t_cfg = t_ren.config.replace(engine="host", mode=mode)
    want, j_stats = j_ren.pipeline.render_trajectory(j_poses, config=j_cfg)
    got, t_stats = t_ren.pipeline.render_trajectory(t_poses, config=t_cfg)
    assert len(got) == len(want) == N_FRAMES
    for g, w in zip(got, want):
        assert g.shape == (32, 32, 3) and torch.isfinite(g).all()
        assert float(psnr(g, torch.as_tensor(np.array(w)))) >= 40.0
    assert _stats_dict(t_stats) == _stats_dict(j_stats)
    assert t_stats.reference_renders == (1 if mode == "temporal" else 2)
    assert len(t_ren.pipeline._device_engines) == 0  # no device engine


def test_host_loop_matches_device_engine(renderers):
    """Offtraj SpaRW on the host loop against the device engine of the
    same config: the same warp and holes, the holes rendered at their
    exact count instead of a pooled batch."""
    _, t_ren = renderers
    _, t_poses = _poses()
    host, h_stats = t_ren.pipeline.render_trajectory(
        t_poses, config=t_ren.config.replace(engine="host"))
    dev, d_stats = t_ren.pipeline.render_trajectory(t_poses)
    assert h_stats.hole_fractions == d_stats.hole_fractions
    assert h_stats.reference_renders == d_stats.reference_renders
    for a, b in zip(host, dev):
        assert float(psnr(a, b)) >= 60.0


def test_temporal_facade_routes_to_host_loop():
    """``make_renderer(RenderConfig(engine="host", mode="temporal"))``
    renders through ``render``; TEMP-N cannot be served."""
    cfg = t_config.RenderConfig(**dict(BASE, res=24, grid_res=16,
                                       num_samples=8),
                                engine="host", mode="temporal")
    ren = t_api.make_renderer(cfg, device="cpu")
    assert (ren.pipeline.mode, ren.pipeline.engine) == ("temporal", "host")
    assert ren.pipeline.window == 4 and ren.pipeline.hole_cap is None
    res = ren.render(t_pipeline.orbit_trajectory(5, step_deg=3.0))
    assert len(res.frames) == 5 and res.stats.reference_renders == 1
    with pytest.raises(ValueError, match="offtraj"):
        ren.serve([t_pipeline.orbit_trajectory(2)])


def test_ds2_matches_reference(renderers):
    """DS-2: >= 40 dB from JAX's frames, and the edge rows and columns
    (where the bilinear upsample renormalises its weights) allclose."""
    j_ren, t_ren = renderers
    j_poses, t_poses = _poses()
    want = j_ren.render_ds2(j_poses[:3])
    got = t_ren.render_ds2(t_poses[:3])
    assert len(got) == 3
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == (32, 32, 3)
        assert float(psnr(g, torch.as_tensor(w.copy()))) >= 40.0
        g = g.numpy()
        for edge in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1]):
            np.testing.assert_allclose(g[edge], w[edge], atol=1e-5)


def test_bilinear_upsample_matches_jax_resize():
    """The x2 upsample alone, on random images, odd sizes included."""
    import jax

    rng = np.random.default_rng(0)
    for h, w in ((4, 6), (5, 7), (16, 16)):
        img = rng.uniform(size=(h, w, 3)).astype(np.float32)
        want = np.asarray(jax.image.resize(jnp.asarray(img),
                                           (2 * h, 2 * w, 3),
                                           method="bilinear"))
        got = torch.nn.functional.interpolate(
            torch.as_tensor(img).permute(2, 0, 1)[None],
            size=(2 * h, 2 * w), mode="bilinear", align_corners=False,
            antialias=False)[0].permute(1, 2, 0).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)


def test_engine_lru_eviction_matches_reference():
    """The renderer's engine cache keeps the most recently used entries
    (a get refreshes), as the reference's does."""
    j_lru, t_lru = j_pipeline._EngineLRU(3), t_pipeline._EngineLRU(3)
    ops = [("put", "a"), ("put", "b"), ("put", "c"), ("get", "a"),
           ("put", "d"), ("get", "b"), ("put", "e"), ("get", "c"),
           ("get", "a"), ("put", "f")]
    for op, key in ops:
        if op == "put":
            j_lru.put(key, key.upper())
            t_lru.put(key, key.upper())
        else:
            assert t_lru.get(key) == j_lru.get(key)
    for key in "abcdef":
        assert t_lru.get(key) == j_lru.get(key)
    assert len(t_lru) == len(j_lru) == 3
    assert t_lru.maxsize == j_lru.maxsize == 3
