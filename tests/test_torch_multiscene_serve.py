"""Slice 3 of the port, multi-scene serving: ``RenderServeEngine(...,
scene_loader=...)`` on its fused and staged ticks against the JAX
package's (interpret-mode Pallas) on the same mixed-scene fleet, and the
port's own paging contracts: mixed-scene ticks against exclusive runs,
``scene=None`` against the single-scene engine, upload on a miss only,
eviction and repage, pinned pages, and the error paths.

The reference's own mixed-scene bitwise test is red on this CPU (ROADMAP
C2), so mixed against exclusive is numerical here: >= 60 dB and equal hole
fractions."""
import numpy as np
import pytest
import torch

from repro import api as j_api
from repro.core import config as j_config
from repro.core import pipeline as j_pipeline
from repro.nerf import scenes as j_scenes
from repro.serve import render_engine as j_serve
from repro_torch import api as t_api
from repro_torch.core import config as t_config
from repro_torch.core import pipeline as t_pipeline
from repro_torch.nerf import scenes as t_scenes
from repro_torch.serve import render_engine as t_serve
from repro_torch.utils import psnr

BASE = dict(scene="lego", res=24, window=2, grid_res=16, channels=4,
            decoder="direct", num_samples=8, backend="streaming",
            num_slots=2, fused_tick=True)
# (sid, scene, frames, orbit phase): 5 sessions, 4 scenes on 2 pages. Tick
# 1 evicts drums for ficus (chair is pinned by session 0), tick 2 evicts
# chair to repage drums and admits ficus as a hit: 4 misses, 1 hit, 2
# evictions; every tick mixes two scenes.
FLEET = [(0, "chair", 4, 0.0), (1, "drums", 2, 120.0), (2, "ficus", 2, 60.0),
         (3, "drums", 2, 200.0), (4, "ficus", 2, 300.0)]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port():
    ren = t_api.make_renderer(t_config.RenderConfig(**BASE), device="cpu")

    def loader(name):
        return t_scenes.bake_dense_table(t_scenes.make_scene(name),
                                         BASE["grid_res"], BASE["channels"])

    return ren, loader


def _traj(mod, n, phase=0.0):
    return list(mod.orbit_trajectory(n, step_deg=4.0, phase_deg=phase))


def _run(ren, loader, specs, **cfg_kw):
    """specs = [(sid, scene, frames, phase)] -> (engine, sessions, metrics)
    on the port."""
    eng = t_serve.RenderServeEngine(ren.model, ren.params,
                                    config=ren.config.replace(**cfg_kw),
                                    scene_loader=loader)
    sess = [t_serve.RenderSession(sid=sid, poses=_traj(t_pipeline, n, ph),
                                  scene=sc) for sid, sc, n, ph in specs]
    return eng, sess, eng.run(sess)


@pytest.fixture(scope="module")
def fleet_runs(port):
    """The fleet on the port and on JAX, fused and staged."""
    t_ren, t_loader = port
    j_ren = j_api.make_renderer(j_config.RenderConfig(
        **BASE, pallas_interpret=True))

    def j_loader(name):
        return j_scenes.bake_dense_table(j_scenes.make_scene(name),
                                         BASE["grid_res"], BASE["channels"])

    out = {}
    for fused in (True, False):
        j_eng = j_serve.RenderServeEngine(
            j_ren.model, j_ren.params,
            config=j_ren.config.replace(fused_tick=fused),
            scene_loader=j_loader)
        j_sess = [j_serve.RenderSession(sid=sid, poses=_traj(j_pipeline, n,
                                                             ph), scene=sc)
                  for sid, sc, n, ph in FLEET]
        want = j_eng.run(j_sess)
        _, t_sess, got = _run(t_ren, t_loader, FLEET, fused_tick=fused)
        out[fused] = (got, t_sess, want, j_sess)
    return out


def _stats_dict(st):
    return {k: getattr(st, k) for k in (
        "frames", "reference_renders", "warped_pixels", "sparse_pixels",
        "fallback_pixels", "total_pixels", "hole_fractions")}


@pytest.mark.parametrize("fused", [True, False])
def test_mixed_scene_serving_matches_reference(fleet_runs, fused):
    got, t_sess, want, j_sess = fleet_runs[fused]
    assert got["complete"] and want["complete"]
    assert got["ticks"] == want["ticks"] == 3
    assert got["scene_cache"] == want["scene_cache"]
    sc = got["scene_cache"]
    assert (sc["misses"], sc["hits"], sc["evictions"], sc["uploads"]) == \
        (4, 1, 2, 4)
    assert got["pool"] == want["pool"] and got["memory"] == want["memory"]
    for ts, js in zip(t_sess, j_sess):
        assert _stats_dict(ts.stats) == _stats_dict(js.stats)
        assert got["per_session"][ts.sid] == {
            **want["per_session"][js.sid],
            "p50_latency_s": got["per_session"][ts.sid]["p50_latency_s"],
            "p95_latency_s": got["per_session"][ts.sid]["p95_latency_s"]}
        for g, w in zip(ts.frames, js.frames):
            assert g.shape == (24, 24, 3)
            assert float(psnr(g, torch.as_tensor(np.array(w)))) >= 40.0


def test_mixed_scene_ticks_match_exclusive_runs(port, fleet_runs):
    """Sessions on different scenes sharing ticks render what each
    renders with the engine to itself: >= 60 dB, equal hole fractions."""
    ren, loader = port
    _, mixed, _, _ = fleet_runs[True]
    for spec in (FLEET[0], FLEET[2]):
        _, excl, m = _run(ren, loader, [spec])
        assert m["complete"]
        mine = next(s for s in mixed if s.sid == spec[0])
        assert mine.stats.hole_fractions == excl[0].stats.hole_fractions
        for a, b in zip(mine.frames, excl[0].frames):
            assert float(psnr(a, b)) >= 60.0


def test_mixed_scene_fused_matches_staged(fleet_runs):
    (m_f, f_sess, _, _), (m_s, s_sess, _, _) = fleet_runs[True], \
        fleet_runs[False]
    assert m_f["ticks"] == m_s["ticks"]
    assert m_f["memory"]["serving_path"] == "fused"
    assert m_s["memory"]["serving_path"] == "staged"
    for a, b in zip(f_sess, s_sess):
        assert a.stats.hole_fractions == b.stats.hole_fractions
        for fa, fb in zip(a.frames, b.frames):
            assert float(psnr(fa, fb)) >= 60.0


@pytest.mark.parametrize("fused", [True, False])
def test_default_scene_matches_single_scene_engine(port, fused):
    """scene=None on a multi-scene engine pages the engine's own params in
    and renders what the engine without a loader renders, bit for bit."""
    ren, loader = port
    cfg = ren.config.replace(fused_tick=fused)
    plain = t_serve.RenderServeEngine(ren.model, ren.params, config=cfg)
    p_sess = [t_serve.RenderSession(sid=i, poses=_traj(t_pipeline, 4, ph))
              for i, ph in enumerate((0.0, 60.0))]
    assert plain.run(p_sess)["complete"]
    _, m_sess, m = _run(ren, loader, [(0, None, 4, 0.0), (1, None, 4, 60.0)],
                        fused_tick=fused)
    assert m["complete"] and m["scene_cache"]["uploads"] == 1
    for a, b in zip(p_sess, m_sess):
        assert a.stats.hole_fractions == b.stats.hole_fractions
        for fa, fb in zip(a.frames, b.frames):
            assert torch.equal(fa, fb)


def test_cached_scene_admission_uploads_nothing(port):
    ren, loader = port
    calls = []

    def counting_loader(name):
        calls.append(name)
        return {"table": loader(name)}  # the dict form of a loader result

    eng = t_serve.RenderServeEngine(ren.model, ren.params, config=ren.config,
                                    scene_loader=counting_loader)
    m1 = eng.run([t_serve.RenderSession(sid=0, poses=_traj(t_pipeline, 3),
                                        scene="chair")])
    assert m1["scene_cache"]["uploads"] == 1
    assert m1["scene_cache"]["misses"] == 1
    m2 = eng.run([t_serve.RenderSession(sid=1, poses=_traj(t_pipeline, 3),
                                        scene="chair")])
    assert m2["scene_cache"]["uploads"] == 0
    assert m2["scene_cache"]["uploaded_bytes"] == 0
    assert m2["scene_cache"]["hits"] >= 1
    assert m2["scene_cache"]["evictions"] == 0
    assert calls == ["chair"]


def test_eviction_and_repage_parity(port):
    """A scene evicted and paged in again renders what a never-evicted
    engine renders, bit for bit (the page index is not part of the math)."""
    ren, loader = port
    eng = t_serve.RenderServeEngine(ren.model, ren.params, config=ren.config,
                                    scene_loader=loader)
    t = _traj(t_pipeline, 4)
    eng.run([t_serve.RenderSession(sid=0, poses=list(t), scene="chair")])
    eng.run([t_serve.RenderSession(sid=1, poses=list(t), scene="drums"),
             t_serve.RenderSession(sid=2, poses=list(t), scene="ficus")])
    assert eng.scene_cache.evictions >= 1
    assert "chair" not in eng.scene_cache  # the LRU victim
    repaged = t_serve.RenderSession(sid=3, poses=list(t), scene="chair")
    m = eng.run([repaged])
    assert m["scene_cache"]["misses"] >= 1  # it really was paged in again
    fresh, excl, _ = _run(ren, loader, [(0, "chair", 4, 0.0)])
    assert fresh.scene_cache.evictions == 0
    assert repaged.stats.hole_fractions == excl[0].stats.hole_fractions
    for fa, fb in zip(repaged.frames, excl[0].frames):
        assert torch.equal(fa, fb)


def test_live_slots_pin_their_pages(port):
    ren, loader = port
    eng, sess, m = _run(ren, loader, [(0, "chair", 10, 0.0)] + [
        (1 + i, sc, 2, 90.0) for i, sc in enumerate(
            ["drums", "ficus", "hotdog", "mic"])])
    assert m["complete"]
    assert m["scene_cache"]["evictions"] >= 2  # the churn page recycled
    assert "chair" in eng.scene_cache  # the pinned page survived
    assert all(f is not None for f in sess[0].frames)


def test_scene_byte_budget_yields_to_pins_and_evicts_cold_pages(port):
    ren, loader = port
    page_bytes = (16**3 * 4 + ren.model.streaming_cfg.num_mvoxels
                  * ren.model.streaming_cfg.halo_rows * 4) * 4
    eng, _, m = _run(ren, loader, [(0, "chair", 2, 0.0),
                                   (1, "drums", 2, 90.0)],
                     scene_cache_bytes=page_bytes)
    sc = m["scene_cache"]
    assert m["complete"] and sc["budget_bytes"] == page_bytes
    # both admitted together: the budget yields to the second pin
    assert sc["evictions"] == 0 and sc["resident_scenes"] == 2
    m2 = eng.run([t_serve.RenderSession(sid=2, poses=_traj(t_pipeline, 2),
                                        scene="ficus")])
    # one page fits the budget: both cold pages go
    assert m2["scene_cache"]["evictions"] == 2
    assert m2["scene_cache"]["resident_bytes"] == page_bytes
    with pytest.raises(ValueError, match="scene_cache_bytes"):
        t_config.RenderConfig(scene_cache_bytes=-1)


def test_scene_requires_loader_backend_and_page_shape(port):
    ren, loader = port
    plain = t_serve.RenderServeEngine(ren.model, ren.params,
                                      config=ren.config)
    with pytest.raises(ValueError, match="no scene_loader"):
        plain.submit([t_serve.RenderSession(
            sid=0, poses=_traj(t_pipeline, 2), scene="chair")])
    assert plain.queue == []
    ref_cfg = t_config.RenderConfig(**dict(BASE, backend="reference",
                                           fused_tick=False))
    rd = t_api.make_renderer(ref_cfg, device="cpu")
    with pytest.raises(ValueError, match="segment-aware streaming"):
        t_serve.RenderServeEngine(rd.model, rd.params, config=rd.config,
                                  scene_loader=loader)
    wrong = t_serve.RenderServeEngine(
        ren.model, ren.params, config=ren.config,
        scene_loader=lambda name: np.zeros((8**3, 4), np.float32))
    with pytest.raises(ValueError, match="table shape"):
        wrong.run([t_serve.RenderSession(sid=0, poses=_traj(t_pipeline, 2),
                                         scene="chair")])
    # a facade request carries its scene into the session
    req = t_config.RenderRequest(poses=tuple(_traj(t_pipeline, 2)),
                                 scene="chair")
    assert t_serve.RenderSession.from_request(req, sid=7).scene == "chair"
    with pytest.raises(ValueError, match="scene must be"):
        t_config.RenderRequest(poses=tuple(_traj(t_pipeline, 2)), scene="")
