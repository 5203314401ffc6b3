"""Fault C7's repair: a sharded window stays deferred. The reference
decides the dense fallback inside its tick program and hands back
sharded arrays that nobody reads until ``finalize``; the port's sharded
``render_windows`` now gathers the deferred fields (sparse frames, holes,
hole counts, overflow flags, fine counts) and leaves the fallback to the
first read, where it re-renders the gathered targets with the full
params.

Two gloo ranks on the CPU (``tests/torch_ranks.py``). A ``TorchDispatch
Mode`` that raises on every op reading a tensor back stands in for the
card's "no synchronizing call" (``tests/test_torch_graphs.py``'s guard),
around each sharded ``render_windows`` and each steady serving tick. The
results resolve bit-equal to the unsharded port, to the rule the port
ran before (each owner resolves its block, then the blocks are
gathered), and >= 40 dB with equal integers against JAX's engine.
"""
import numpy as np
import pytest
import torch

import torch_ranks
from test_torch_shard import RAYBATCH, SERVE, \
    _check_against_jax, _jax_fields, _min_psnr, _port_fields, _run_stats, \
    _windows
from repro_torch.nerf import scenes as t_scenes

FIELDS = ("frames", "holes", "hole_counts", "overflowed", "fine_counts")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _overflow_windows():
    """Session 0 turns half a degree a frame; session 1, rank 1's, turns
    20 degrees a frame and overflows a hole cap of 8."""
    (r0, t0), (r1, t1) = _windows(1, 0.5), _windows(2, 20.0)
    return np.stack([r0[0], r1[1]]), np.stack([t0[0], t1[1]])


# (config, windows): the streaming backend (seg-aware chunks, kernel B1's
# plain version) with and without a forced overflow, and the reference
# backend's overflow
JOBS = {
    "streaming": (dict(RAYBATCH, backend="streaming"), _windows(2, 1.0)),
    "streaming_overflow": (dict(RAYBATCH, backend="streaming", hole_cap=8,
                                pool_bucket=128), _overflow_windows()),
    "reference_overflow": (dict(RAYBATCH, hole_cap=8, pool_bucket=128),
                           _overflow_windows()),
}


@pytest.fixture(scope="module")
def windows_on_two_ranks(tmp_path_factory):
    names = sorted(JOBS)
    outs = torch_ranks.launch(
        torch_ranks.deferred_windows_rank, 2,
        tmp_path_factory.mktemp("deferred"),
        [(JOBS[n][0], [JOBS[n][1]]) for n in names])
    return {n: [out[i] for out in outs] for i, n in enumerate(names)}


@pytest.mark.parametrize("job", sorted(JOBS))
def test_sharded_window_returns_deferred_without_a_device_read(
        windows_on_two_ranks, job):
    for rank_out in windows_on_two_ranks[job]:
        assert rank_out["calls"][0]["deferred"]


@pytest.mark.parametrize("job", sorted(JOBS))
def test_deferred_window_resolves_bit_equal(windows_on_two_ranks, job):
    """Against the unsharded port, against the owner-resolves-first rule
    and against JAX (>= 40 dB, equal integers); an overflow in rank 1's
    session makes every rank that reads the frames run one dense fill
    over both sessions' targets."""
    cfg_kw, (ref, tgt) = JOBS[job]
    base = _port_fields(cfg_kw, ref, tgt)
    for rank_out in windows_on_two_ranks[job]:
        call = rank_out["calls"][0]
        for k in FIELDS:
            np.testing.assert_array_equal(call["fields"][k], base[k],
                                          err_msg=k)
            np.testing.assert_array_equal(call["owner_rule"][k], base[k],
                                          err_msg=k)
        want_fills = int(base["overflowed"].any())
        assert rank_out["dense_fills"] == want_fills
    if job.endswith("overflow"):
        assert base["overflowed"].tolist() == [False, True]
    _check_against_jax(windows_on_two_ranks[job][0]["calls"][0]["fields"],
                       _jax_fields(cfg_kw, ref, tgt))


# (sid, frames, orbit phase, scene): three scenes on two slots, sessions
# long enough that ticks run with both slots busy; sessions 1 and 3 at a
# hole cap of 8, so that their windows overflow and take the dense
# fallback in ``finalize``
FLEET = [(0, 6, 0.0, "chair"), (1, 4, 120.0, "drums"),
         (2, 4, 60.0, "ficus"), (3, 4, 200.0, "drums")]
HOLE_CAPS = {1: 8, 3: 8}


def test_sharded_multi_scene_serving_is_dispatch_only(tmp_path):
    """Two ranks serve the multi-scene fleet staged; every tick that
    admits nothing runs under the guard. Frames, per-session stats and
    ``run()``'s statistics equal the unsharded port's on both ranks; the
    stats equal JAX's and the frames sit >= 40 dB from them."""
    tables = {name: t_scenes.bake_dense_table(
        t_scenes.make_scene(name), SERVE["grid_res"],
        SERVE["channels"]).numpy() for name in ("chair", "drums", "ficus")}
    outs = torch_ranks.launch(torch_ranks.guarded_serve_rank, 2, tmp_path,
                              SERVE, FLEET, tables, HOLE_CAPS)
    base, base_m = _serve_with_caps(FLEET, tables)
    assert sum(s["stats"]["fallback_pixels"] for s in base) > 0
    for out in outs:
        assert out["guarded_ticks"] >= 1
        assert out["metrics"]["devices"] == 2
        assert _run_stats(out["metrics"]) == _run_stats(base_m)
        for got, want in zip(out["sessions"], base):
            np.testing.assert_array_equal(got["frames"], want["frames"])
            assert got["stats"] == want["stats"]
    j_sess, j_m = _serve_jax_with_caps(FLEET)
    assert j_m["ticks"] == base_m["ticks"]
    for got, js in zip(outs[0]["sessions"], j_sess):
        assert got["stats"]["hole_fractions"] == js.stats.hole_fractions
        assert got["stats"]["fallback_pixels"] == js.stats.fallback_pixels
        assert _min_psnr(got["frames"],
                         np.stack([np.array(f) for f in js.frames])) >= 40.0


def _serve_with_caps(fleet, tables):
    """``test_torch_shard._serve_port`` with ``HOLE_CAPS``."""
    from repro_torch.core import pipeline as t_pipeline
    from repro_torch.serve import render_engine as t_serve

    ren = torch_ranks.renderer(SERVE)
    eng = t_serve.RenderServeEngine(
        ren.model, ren.params, config=ren.config,
        scene_loader=lambda name: torch.as_tensor(tables[name]))
    sess = [t_serve.RenderSession(sid=sid, poses=list(
        t_pipeline.orbit_trajectory(n, step_deg=4.0, phase_deg=ph)),
        scene=sc, hole_cap=HOLE_CAPS.get(sid)) for sid, n, ph, sc in fleet]
    metrics = eng.run(sess)
    return [torch_ranks.session_result(s) for s in sess], metrics


def _serve_jax_with_caps(fleet):
    """``test_torch_shard._serve_jax`` (multi-scene) with ``HOLE_CAPS``."""
    from repro import api as j_api
    from repro.core import config as j_config
    from repro.core import pipeline as j_pipeline
    from repro.nerf import scenes as j_scenes
    from repro.serve import render_engine as j_serve

    ren = j_api.make_renderer(j_config.RenderConfig(**SERVE,
                                                    pallas_interpret=True))
    eng = j_serve.RenderServeEngine(
        ren.model, ren.params, config=ren.config,
        scene_loader=lambda name: j_scenes.bake_dense_table(
            j_scenes.make_scene(name), SERVE["grid_res"], SERVE["channels"]))
    sess = [j_serve.RenderSession(sid=sid, poses=list(
        j_pipeline.orbit_trajectory(n, step_deg=4.0, phase_deg=ph)),
        scene=sc, hole_cap=HOLE_CAPS.get(sid)) for sid, n, ph, sc in fleet]
    return sess, eng.run(sess)
