"""Slice 2 of the port, the multi-session serving engine: ``RenderServeEngine``
on its staged and fused ticks against the JAX package's (interpret-mode
Pallas) on the same fleet, the admission policies, slot-reuse isolation
on the fused recurrence, submit validation and the ``Renderer.serve``
device rule.

The reference's bitwise batched == exclusive contract is red in JAX itself
on this CPU (ROADMAP C2), so parity with it is numerical: frames >= 40 dB,
equal ticks, per-session statistics and traffic accounting."""
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro import api as j_api
from repro.core import config as j_config
from repro.core import pipeline as j_pipeline
from repro.serve import policies as j_policies
from repro.serve import render_engine as j_serve
from repro_torch import api as t_api
from repro_torch.core import config as t_config
from repro_torch.core import pipeline as t_pipeline
from repro_torch.serve import policies as t_policies
from repro_torch.serve import render_engine as t_serve
from repro_torch.utils import psnr

BASE = dict(scene="lego", res=24, window=2, grid_res=16, channels=4,
            decoder="direct", num_samples=8, backend="streaming",
            num_slots=2)


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


def _trajs(mod, n_sessions, n_frames, step_deg=4.0):
    return [mod.orbit_trajectory(n_frames, step_deg=step_deg,
                                 phase_deg=25.0 * i)
            for i in range(n_sessions)]


def _stats_dict(st):
    return {k: getattr(st, k) for k in (
        "frames", "reference_renders", "warped_pixels", "sparse_pixels",
        "fallback_pixels", "total_pixels", "hole_fractions")}


def _key_tree(d):
    return {k: _key_tree(v) if isinstance(v, dict) else None
            for k, v in d.items()}


@pytest.mark.parametrize("fused", [False, True])
def test_serve_run_matches_reference(renderers, fused):
    """3 sessions over 2 slots: queueing, slot reuse and (fused) priming
    on admission all run."""
    j_ren, t_ren = renderers
    j_eng = j_serve.RenderServeEngine(
        j_ren.model, j_ren.params,
        config=j_ren.config.replace(fused_tick=fused))
    t_eng = t_serve.RenderServeEngine(
        t_ren.model, t_ren.params,
        config=t_ren.config.replace(fused_tick=fused))
    j_sess = [j_serve.RenderSession(sid=i, poses=list(t))
              for i, t in enumerate(_trajs(j_pipeline, 3, 5))]
    t_sess = [t_serve.RenderSession(sid=i, poses=list(t))
              for i, t in enumerate(_trajs(t_pipeline, 3, 5))]
    want = j_eng.run(j_sess)
    got = t_eng.run(t_sess)
    assert got["complete"] and want["complete"]
    assert got["ticks"] == want["ticks"]
    assert got["total_frames"] == want["total_frames"] == 15
    assert _key_tree(got) == _key_tree(want)
    assert got["memory"] == want["memory"]
    assert got["memory"]["serving_path"] == ("fused" if fused else "staged")
    assert got["pool"] == want["pool"]
    assert got["slots"] == want["slots"]
    assert got["queue"]["depth_max"] == want["queue"]["depth_max"] == 1
    assert (got["scene_cache"], got["devices"]) == (None, 1)
    for js, ts in zip(j_sess, t_sess):
        assert ts.done
        assert _stats_dict(ts.stats) == _stats_dict(js.stats)
        assert got["per_session"][ts.sid]["hole_fraction"] == \
            want["per_session"][js.sid]["hole_fraction"]
        for g, w in zip(ts.frames, js.frames):
            assert g.shape == (24, 24, 3)
            assert float(psnr(g, torch.as_tensor(np.array(w)))) >= 40.0


def test_fused_serving_matches_staged_serving(renderers):
    _, t_ren = renderers
    trajs = _trajs(t_pipeline, 3, 5)
    out = {}
    for fused in (False, True):
        eng = t_serve.RenderServeEngine(
            t_ren.model, t_ren.params,
            config=t_ren.config.replace(fused_tick=fused))
        sess = [t_serve.RenderSession(sid=i, poses=list(t))
                for i, t in enumerate(trajs)]
        out[fused] = (eng.run(sess), sess)
    (m_s, s_sess), (m_f, f_sess) = out[False], out[True]
    assert m_s["ticks"] == m_f["ticks"]
    for a, b in zip(s_sess, f_sess):
        assert a.stats.hole_fractions == b.stats.hole_fractions
        for fa, fb in zip(a.frames, b.frames):
            assert float(psnr(fa, fb)) >= 60.0
    assert m_f["memory"]["serving_table_sweeps_per_tick_steady"] == 1.0
    assert m_f["memory"]["admission_ticks"] >= 2
    assert 1.0 < m_f["memory"]["serving_table_sweeps_per_tick_amortized"] \
        < m_s["memory"]["staged_table_sweeps_per_tick"]


def test_fused_serving_slot_reuse_reference_isolation(renderers):
    """Session B admitted into A's drained slot gets bit-identical frames
    to its exclusive fused run: priming on admission overwrites the
    reused recurrence row."""
    _, t_ren = renderers
    cfg = t_ren.config.replace(fused_tick=True, num_slots=1)
    t_a = t_pipeline.orbit_trajectory(4, step_deg=25.0)
    t_b = t_pipeline.orbit_trajectory(4, step_deg=4.0, phase_deg=180.0)
    shared = t_serve.RenderServeEngine(t_ren.model, t_ren.params, config=cfg)
    a = t_serve.RenderSession(sid=0, poses=list(t_a))
    b = t_serve.RenderSession(sid=1, poses=list(t_b))
    shared.run([a, b])
    assert a.done and b.done
    exclusive = t_serve.RenderServeEngine(t_ren.model, t_ren.params,
                                          config=cfg)
    b_alone = t_serve.RenderSession(sid=1, poses=list(t_b))
    exclusive.run([b_alone])
    assert b.stats.hole_fractions == b_alone.stats.hole_fractions
    for fa, fb in zip(b.frames, b_alone.frames):
        assert torch.equal(fa, fb)


def _queue(rows, now):
    return [SimpleNamespace(priority=p, deadline_ms=d, arrival=i,
                            submitted_s=now - age)
            for i, (p, d, age) in enumerate(rows)]


@pytest.mark.parametrize("rows", [
    [(0, None, 0.0), (2, None, 0.1), (2, 500.0, 0.2), (1, 50.0, 0.3)],
    [(0, 100.0, 0.5), (0, 300.0, 0.1), (0, None, 0.0), (0, 10.0, 0.0)],
    [(1, None, 0.0), (1, None, 0.0), (0, 1.0, 2.0)],
])
def test_policies_match_reference(rows):
    now = 1000.0
    for name in ("fifo", "priority"):
        jp = j_policies.resolve_policy(name)
        tp = t_policies.resolve_policy(name)
        assert tp.name == jp.name
        for t in (now, now + 0.2, now + 1.0):
            q = _queue(rows, now)
            assert tp.select(q, t) == jp.select(q, t)
            assert list(tp.shed(q, t)) == list(jp.shed(q, t))
    assert isinstance(t_policies.resolve_policy(None), t_policies.FifoPolicy)
    with pytest.raises(ValueError, match="unknown"):
        t_policies.resolve_policy("lifo")
    with pytest.raises(TypeError):
        t_policies.resolve_policy(object())
    assert math.isinf(t_policies.PriorityPolicy._remaining_s(
        SimpleNamespace(deadline_ms=None), now))


def test_priority_serving_sheds_and_reorders(renderers):
    """The priority policy admits the urgent session first and sheds one
    whose deadline expired in the queue; the facade's serve returns
    results in request order."""
    _, t_ren = renderers
    trajs = _trajs(t_pipeline, 3, 2)
    reqs = [t_config.RenderRequest(poses=tuple(trajs[0])),
            t_config.RenderRequest(poses=tuple(trajs[1]), deadline_ms=-1.0),
            t_config.RenderRequest(poses=tuple(trajs[2]), priority=5)]
    results, m = t_ren.serve(reqs, policy="priority", num_slots=1)
    assert m["policy"] == "priority" and m["queue"]["shed"] == 1
    assert [r.sid for r in results] == [0, 1, 2]
    assert m["per_session"][1]["shed"] and len(results[1].frames) == 2
    assert results[1].frames[0] is None
    assert all(f is not None for r in (results[0], results[2])
               for f in r.frames)
    assert m["total_frames"] == 4


def test_submit_validation(renderers):
    _, t_ren = renderers
    eng = t_serve.RenderServeEngine(t_ren.model, t_ren.params,
                                    config=t_ren.config)
    pose = [torch.eye(4)]
    with pytest.raises(ValueError, match="scene"):
        eng.submit([t_serve.RenderSession(sid=0, poses=pose, scene="ship")])
    with pytest.raises(ValueError, match="window override"):
        eng.submit([t_serve.RenderSession(sid=0, poses=pose, window=3)])
    with pytest.raises(ValueError, match="duplicates"):
        eng.submit([t_serve.RenderSession(sid=0, poses=pose),
                    t_serve.RenderSession(sid=0, poses=pose)])
    assert eng.queue == [] and eng._num_submitted == 0
    with pytest.raises(ValueError, match="empty"):
        t_serve.RenderSession(sid=0, poses=[])


def test_serve_needs_a_card_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = t_config.RenderConfig(**BASE, fused_tick=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_api.make_renderer(cfg)
    ren = t_api.make_renderer(cfg, device="cpu")
    frames, stats, m = ren.pipeline.render_trajectories(
        _trajs(t_pipeline, 2, 3))
    assert m["complete"] and m["slots"]["num_slots"] == 2
    assert all(f.device.type == "cpu" for fs in frames for f in fs)
    assert [s.frames for s in stats] == [3, 3]
