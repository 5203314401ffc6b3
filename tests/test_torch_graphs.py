"""Slice 10 of the port, the dispatch-only steady tick: the twins of the
reference's zero-host-sync and compile-count tests, on the CPU.

The reference runs its steady ticks under ``jax.transfer_guard
("disallow")``. Here a ``TorchDispatchMode`` raises on every op that reads
a CUDA tensor back to the host or sizes its output from device data
(``_local_scalar_dense``, ``nonzero``, ``bincount``, ``unique*``,
``masked_select``, ``repeat_interleave.Tensor``, ...); the card's own check
(no synchronizing call at all, graphs replaying bit-equal to eager) is
``chip_smoke.py``'s phase S. Also: the tick programs are one per key, as
the reference's compiled programs; the deferred dense fallback gives the
in-tick rule's frames bit for bit; ``build_rit`` against the reference;
and the launch accounting of a captured graph, on a stub kernel."""
import contextlib
import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import api as j_api
from repro.core import config as j_config
from repro.core import pipeline as j_pipeline
from repro.core import streaming as j_streaming
from repro.core.engine import DeviceSparwEngine as JEngine
from repro_torch import api as t_api
from repro_torch.configs import cicero_nerf as t_cn
from repro_torch.core import config as t_config
from repro_torch.core import pipeline as t_pipeline
from repro_torch.core import raybatch, sparw
from repro_torch.core import streaming as t_streaming
from repro_torch.core.engine import DeviceSparwEngine as TEngine
from repro_torch.core.engine import TickProgram
from repro_torch.kernels import _build
from repro_torch.nerf import models as t_models
from repro_torch.nerf import scenes as t_scenes
from repro_torch.serve import render_engine as t_serve
from repro_torch.utils import psnr

BASE = dict(scene="lego", res=24, window=2, grid_res=16, channels=4,
            decoder="direct", num_samples=8, backend="streaming",
            num_slots=2)
# ops that read a CUDA tensor back or size their output from its data
SYNC_OPS = {"_local_scalar_dense", "item", "is_nonzero", "equal",
            "allclose", "nonzero", "nonzero_static", "argwhere", "bincount",
            "masked_select", "histc"}


class SyncDetector(TorchDispatchMode):
    """Raises on any op of ``SYNC_OPS``, ``unique*`` or
    ``repeat_interleave.Tensor`` inside its block."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in SYNC_OPS or name.lstrip("_").startswith("unique") or (
                name == "repeat_interleave"
                and func._overloadname == "Tensor"):
            raise AssertionError(f"synchronizing op {func} in a steady tick")
        return func(*args, **(kwargs or {}))


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ren():
    return t_api.make_renderer(t_config.RenderConfig(**BASE), device="cpu")


def _trajs(n_sessions, n_frames, step_deg=4.0):
    return [t_pipeline.orbit_trajectory(n_frames, step_deg=step_deg,
                                        phase_deg=25.0 * i)
            for i in range(n_sessions)]


def _engine(ren, **cfg_kw):
    return t_serve.RenderServeEngine(ren.model, ren.params,
                                     config=ren.config.replace(**cfg_kw))


def _loader(name):
    return t_scenes.bake_dense_table(t_scenes.make_scene(name),
                                     BASE["grid_res"], BASE["channels"])


# ---------------------------------------------------------------------------
# build_rit: counts from the sorted ids' boundaries
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["empty_buckets", "dump_ids_spread",
                                  "all_dump", "last_bucket_overflows"])
def test_build_rit_matches_reference(case):
    jc = j_streaming.StreamingCfg(grid_res=16, capacity=8)
    tc = t_streaming.StreamingCfg(grid_res=16, capacity=8)
    rng = np.random.default_rng(5)
    n_slots = 3 * jc.num_mvoxels
    if case == "empty_buckets":  # most buckets get nothing
        mv = rng.choice([0, 5, n_slots - 1], size=200)
    elif case == "dump_ids_spread":  # ids past num_slots, several values
        mv = rng.integers(0, n_slots + 40, size=600)
    elif case == "all_dump":
        mv = rng.integers(n_slots, 2 * n_slots, size=100)
    else:
        mv = np.concatenate([np.full(20, n_slots - 1),
                             rng.integers(0, n_slots, size=100)])
    want = j_streaming.build_rit(jnp.asarray(mv, jnp.int32), jc,
                                 num_slots=n_slots)
    with SyncDetector():
        got = t_streaming.build_rit(torch.as_tensor(mv), tc,
                                    num_slots=n_slots)
    for name, w, g in zip(want._fields, want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


# ---------------------------------------------------------------------------
# steady ticks read nothing back
# ---------------------------------------------------------------------------


def test_steady_staged_ragged_step_has_no_sync(ren):
    """Mixed window and hole-cap overrides, so the per-slot arrays are
    staged at admission; the next tick is pure dispatch."""
    serve = _engine(ren)
    trajs = _trajs(2, 6)
    serve.submit([t_serve.RenderSession(sid=0, poses=list(trajs[0]),
                                        window=1),
                  t_serve.RenderSession(sid=1, poses=list(trajs[1]),
                                        hole_cap=serve.engine.hole_cap // 2)])
    assert serve.step()  # admission + first (eager) run of the key
    with SyncDetector():
        assert serve.step()
        assert serve.step()
    while serve.step():
        pass
    serve.finalize()
    assert serve.engine.num_window_calls == serve.num_ticks
    assert serve._pending == []


def test_steady_fused_step_has_no_sync(ren):
    serve = _engine(ren, fused_tick=True)
    sessions = [t_serve.RenderSession(sid=i, poses=list(t))
                for i, t in enumerate(_trajs(2, 6))]
    serve.submit(sessions)
    assert serve.step()  # admission: priming render + first run
    with SyncDetector():
        assert serve.step()
        assert serve.step()
    serve.finalize()  # the frames and statistics are read here
    assert all(s.done for s in sessions)


def test_steady_mixed_scene_step_after_churn_has_no_sync(ren):
    """After scene churn (misses, evictions, a repage) a steady mixed-scene
    fused tick is pure dispatch, and the churn made no new tick program."""
    serve = t_serve.RenderServeEngine(
        ren.model, ren.params, config=ren.config.replace(fused_tick=True),
        scene_loader=_loader)
    serve.run([t_serve.RenderSession(sid=0, poses=_trajs(1, 4)[0],
                                     scene="chair"),
               t_serve.RenderSession(sid=1, poses=_trajs(2, 4)[1],
                                     scene="drums")])
    programs = set(serve.engine.tick_programs)
    serve.submit([t_serve.RenderSession(sid=2, poses=_trajs(1, 6)[0],
                                        scene="ficus"),
                  t_serve.RenderSession(sid=3, poses=_trajs(2, 6)[1],
                                        scene="chair")])
    assert serve.step()  # admission: one miss, one repage
    with SyncDetector():
        assert serve.step()
    while serve.step():
        pass
    serve.finalize()
    assert serve.scene_cache.evictions >= 1
    assert set(serve.engine.tick_programs) == programs


@pytest.mark.parametrize("path", ["staged", "adaptive", "fused"])
def test_warm_engine_call_has_no_sync(ren, path):
    """A warm ``render_windows`` / ``render_windows_streaming`` call on
    device-resident inputs (the reference's transfer-free flat tick)."""
    cfg = ren.config.replace(adaptive_sampling=path == "adaptive",
                             fused_tick=path == "fused")
    eng = TEngine(ren.model, ren.params, config=cfg)
    trajs = _trajs(2, 3)
    ref = torch.stack([t[0] for t in trajs])
    tgt = torch.stack([torch.stack(t[1:]) for t in trajs])
    if path == "fused":
        rgb, dep = eng.prime_reference(ref)
        call = lambda: eng.render_windows_streaming(rgb, dep, ref, tgt, ref)
    else:
        call = lambda: eng.render_windows(ref, tgt)
    first = call()
    with SyncDetector():
        warm = call()
    assert len(eng.tick_programs) == 1
    assert torch.equal(warm.sparse_frames, first.sparse_frames)
    assert torch.equal(warm.frames, first.frames)


@pytest.mark.parametrize("name", ["NGP_BENCH", "TENSORF_BENCH"])
def test_other_kinds_steady_tick_has_no_sync(name):
    """The hash and VM grids on the staged tick (their features decode
    through B2): a warm engine call and a steady serving step read nothing
    back, and the warm call repeats the first call's outputs bit for bit
    (on the card the warm call is the graph replay, ``chip_smoke.py``
    phase S)."""
    model = t_models.NerfModel(dataclasses.replace(
        getattr(t_cn, name), backend="streaming", num_samples=16))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    ren = t_api.make_renderer(t_config.RenderConfig(
        res=16, window=2, backend="streaming", num_slots=2), model=model,
        params=params, device="cpu")
    eng = TEngine(ren.model, ren.params, config=ren.config)
    trajs = _trajs(2, 3)
    ref = torch.stack([t[0] for t in trajs])
    tgt = torch.stack([torch.stack(t[1:]) for t in trajs])
    first = eng.render_windows(ref, tgt)
    with SyncDetector():
        warm = eng.render_windows(ref, tgt)
    assert len(eng.tick_programs) == 1
    for field in ("sparse_frames", "holes", "hole_counts", "overflowed"):
        assert torch.equal(getattr(warm, field), getattr(first, field))
    assert torch.equal(warm.frames, first.frames)
    assert int(first.hole_counts.sum()) > 0
    serve = _engine(ren)
    serve.submit([t_serve.RenderSession(sid=i, poses=list(t))
                  for i, t in enumerate(_trajs(2, 6))])
    assert serve.step()  # admission + first (eager) run of the key
    with SyncDetector():
        assert serve.step()
    while serve.step():
        pass
    serve.finalize()
    assert serve._pending == []


# ---------------------------------------------------------------------------
# one tick program per key
# ---------------------------------------------------------------------------


def test_programs_track_pool_buckets_within_ladder(ren):
    trajs = [t_pipeline.orbit_trajectory(n, step_deg=1.0, phase_deg=10.0 * n)
             for n in (5, 3, 4)]
    serve = _engine(ren, num_slots=3)
    sessions = [t_serve.RenderSession(sid=0, poses=list(trajs[0])),
                t_serve.RenderSession(sid=1, poses=list(trajs[1]), window=1),
                t_serve.RenderSession(sid=2, poses=list(trajs[2]),
                                      hole_cap=serve.engine.hole_cap // 2)]
    serve.run(sessions)
    eng = serve.engine
    keys = set(eng.tick_programs)
    assert {(k[3], k[4]) for k in keys} == eng.pool_buckets_used
    assert len(keys) == len(eng.pool_buckets_used) <= eng.pool_ladder_size
    assert all(k[:3] == ("staged", 3, 2) for k in keys)
    # a reused engine on the same fleet adds no program
    serve.run([t_serve.RenderSession(sid=10 + i, poses=list(t))
               for i, t in enumerate(trajs)])
    assert set(eng.tick_programs) == keys
    assert eng.num_captures == 0  # the CPU runs every program eagerly


@pytest.mark.parametrize("cfg_kw", [dict(pool_holes=False),
                                    dict(pool_bucket=128)])
def test_fixed_bucket_is_one_program(ren, cfg_kw):
    serve = _engine(ren, **cfg_kw)
    m = serve.run([t_serve.RenderSession(sid=i, poses=list(t))
                   for i, t in enumerate(_trajs(2, 6))])
    assert m["complete"] and m["ticks"] == 3
    assert len(serve.engine.tick_programs) == 1
    (prog,) = serve.engine.tick_programs.values()
    assert prog.calls == 3


# ---------------------------------------------------------------------------
# the dense fallback, decided where the frames are read
# ---------------------------------------------------------------------------


def _spied(monkeypatch, module, name, log):
    real = getattr(module, name)

    def spy(*args, **kw):
        out = real(*args, **kw)
        log.append(out)
        return out
    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("fused", [False, True])
def test_forced_overflow_frames_match_in_tick_rule(monkeypatch, fused):
    """A hole cap of 8 and a pool of 128 overflow the hot session: its
    frames are bit for bit the in-tick rule ``where(holes, where(
    overflowed, dense, sparse), warped)``, >= 40 dB from JAX's, with equal
    flags and hole counts."""
    kw = dict(BASE, hole_cap=8, pool_bucket=128, fused_tick=fused)
    t_ren = t_api.make_renderer(t_config.RenderConfig(**kw), device="cpu")
    j_ren = j_api.make_renderer(j_config.RenderConfig(
        **kw, pallas_interpret=True))
    t_eng = TEngine(t_ren.model, t_ren.params, config=t_ren.config)
    j_eng = JEngine(j_ren.model, j_ren.params, config=j_ren.config)
    trajs = [(j_pipeline.orbit_trajectory(3, step_deg=d, phase_deg=p),
              t_pipeline.orbit_trajectory(3, step_deg=d, phase_deg=p))
             for d, p in ((0.5, 0.0), (20.0, 40.0))]  # quiet, hot
    j_ref = jnp.stack([j[0] for j, _ in trajs])
    j_tgt = jnp.stack([jnp.stack(j[1:]) for j, _ in trajs])
    t_ref = torch.stack([t[0] for _, t in trajs])
    t_tgt = torch.stack([torch.stack(t[1:]) for _, t in trajs])
    warps, fills = [], []
    _spied(monkeypatch, sparw, "warp_frames_flat", warps)
    if fused:
        _spied(monkeypatch, raybatch, "scatter_segments", fills)
        rgb, dep = j_eng.prime_reference(j_ref)
        want = j_eng.render_windows_streaming(rgb, dep, j_ref, j_tgt, j_ref)
        got = t_eng.render_windows_streaming(
            torch.as_tensor(np.array(rgb)), torch.as_tensor(np.array(dep)),
            t_ref, t_tgt, t_ref)
    else:
        _spied(monkeypatch, t_eng, "_pooled_fill", fills)
        want = j_eng.render_windows(j_ref, j_tgt)
        got = t_eng.render_windows(t_ref, t_tgt)
    monkeypatch.undo()
    ovf = got.overflowed
    np.testing.assert_array_equal(ovf.numpy(), np.asarray(want.overflowed))
    np.testing.assert_array_equal(got.hole_counts.numpy(),
                                  np.asarray(want.hole_counts))
    assert ovf.tolist() == [False, True]
    (warped,), (fill,) = warps, fills
    sparse = fill if fused else fill[0]
    s, n, h, w = warped.holes.shape
    dense = t_eng._dense_fill_flat(t_eng.params, t_tgt)
    in_tick = torch.where(
        warped.holes.reshape(s, n, h * w)[..., None],
        torch.where(ovf[:, None, None, None], dense,
                    sparse.reshape(s, n, h * w, 3)),
        warped.rgb.reshape(s, n, h * w, 3))
    assert torch.equal(got.frames, in_tick.reshape(s, n, h, w, 3))
    assert not torch.equal(got.frames, got.sparse_frames)
    for g, j in zip(got.frames.reshape(-1, h, w, 3),
                    np.asarray(want.frames).reshape(-1, h, w, 3)):
        assert float(psnr(g, torch.as_tensor(np.array(j)))) >= 40.0


def test_served_overflow_matches_reference_stats():
    """Served with the fallback resolved in ``finalize``: equal stats and
    fallback pixels to JAX's fleet, frames >= 40 dB."""
    kw = dict(BASE, hole_cap=8, pool_bucket=128)
    t_ren = t_api.make_renderer(t_config.RenderConfig(**kw), device="cpu")
    j_ren = j_api.make_renderer(j_config.RenderConfig(
        **kw, pallas_interpret=True))
    fleet = ((0.5, 0.0), (20.0, 40.0))  # (step, phase) degrees
    got, _ = t_ren.serve([t_config.RenderRequest(poses=tuple(
        t_pipeline.orbit_trajectory(4, step_deg=d, phase_deg=p)))
        for d, p in fleet])
    want, _ = j_ren.serve([j_config.RenderRequest(poses=tuple(
        j_pipeline.orbit_trajectory(4, step_deg=d, phase_deg=p)))
        for d, p in fleet])
    assert got[1].stats.fallback_pixels > 0
    for g, w in zip(got, want):
        for k in ("frames", "reference_renders", "sparse_pixels",
                  "fallback_pixels", "hole_fractions"):
            assert getattr(g.stats, k) == getattr(w.stats, k), k
        for a, b in zip(g.frames, w.frames):
            assert float(psnr(a, torch.as_tensor(np.array(b)))) >= 40.0


def test_consecutive_ticks_frames_do_not_share_storage(ren):
    for fused in (False, True):
        serve = _engine(ren, num_slots=1, fused_tick=fused)
        sess = t_serve.RenderSession(sid=0, poses=_trajs(1, 4)[0])
        serve.run([sess])
        a, b = sess.frames[0], sess.frames[2]  # ticks 1 and 2
        assert a.untyped_storage().data_ptr() \
            != b.untyped_storage().data_ptr()


# ---------------------------------------------------------------------------
# replay launch accounting, on a stub kernel and a stand-in graph
# ---------------------------------------------------------------------------


class _StandInGraph:
    """Records nothing: what the capture ran counts at each replay."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


@contextlib.contextmanager
def _stand_in_capture(graph, pool=None):
    yield


def test_replay_counts_launches_on_stub_kernel(monkeypatch):
    monkeypatch.setattr(_build, "_KERNELS", list(_build._KERNELS))
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph", _stand_in_capture)
    stub = _build.CudaKernel("stub", {"stub_a": "i", "stub_b": "i"})
    stub._lib = SimpleNamespace(stub_a=lambda *a: 0, stub_b=lambda *a: 0)
    out = torch.zeros(3)
    pinned = object()
    runs = []

    def fn():
        runs.append(1)
        stub.call("stub_a", 1)
        stub.call("stub_b", 1)
        stub.call("stub_b", 2)
        _build.keep_alive(pinned)
        return {"out": out}

    prog = TickProgram(fn)
    counts = lambda: (stub.launches, dict(stub.entry_launches))
    prog(True)  # eager
    assert counts() == (3, {"stub_a": 1, "stub_b": 2})
    res = prog(True)  # capture, then the first replay
    assert len(runs) == 2 and prog.graph.replays == 1
    assert counts() == (6, {"stub_a": 2, "stub_b": 4})
    assert prog._keep == [pinned]
    assert res["out"] is not out and torch.equal(res["out"], out)
    prog(True)
    prog(True)
    assert len(runs) == 2 and prog.graph.replays == 3
    assert counts() == (12, {"stub_a": 4, "stub_b": 8})
    prog(False)  # graphs off: eager again, counted by the wrapper
    assert len(runs) == 3 and counts()[0] == 15
