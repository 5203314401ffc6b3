"""Slice 17 of the port, session sharding of the render path:
``RenderConfig(shard=ShardConfig(num_devices=D))`` over D gloo ranks on the
CPU (``tests/torch_ranks.py`` spawns them, each joining through a
``FileStore`` in the test's ``tmp_path``; a rank past its deadline is
killed and fails the test).

Each sharded run is held against the port's unsharded run of the same
windows or fleet, bit for bit (every rank renders its block through the
same chunks the unsharded batch cuts, so no float sum changes order), and
against the JAX engine's unsharded run at >= 40 dB with equal integers
(the reference's own sharded test holds its sharded run bit-equal to its
unsharded one)."""
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_ranks
from repro.core import config as j_config
from repro.core import pipeline as j_pipeline
from repro.nerf import scenes as j_scenes
from repro.serve import render_engine as j_serve
from repro import api as j_api
from repro_torch.core import config as t_config
from repro_torch.core import pipeline as t_pipeline
from repro_torch.core import raybatch
from repro_torch.core.engine import DeviceSparwEngine
from repro_torch.nerf import scenes as t_scenes
from repro_torch.serve import render_engine as t_serve
from repro_torch.utils import psnr

# the reference's sharded test (tests/test_raybatch.py): dvgo, grid 32, 4
# channels, direct, 16 samples, camera 32, window 2, two sessions
RAYBATCH = dict(scene="lego", res=32, window=2, grid_res=32, channels=4,
                decoder="direct", num_samples=16, num_slots=2)
# the serving tests' config (tests/test_torch_serve.py)
SERVE = dict(scene="lego", res=24, window=2, grid_res=16, channels=4,
             decoder="direct", num_samples=8, backend="streaming",
             num_slots=2)
INT_FIELDS = ("hole_counts", "overflowed", "fine_counts")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo process group of one rank in this process, for the length of
    the test."""
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store1"), 1), rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def _windows(n_sessions, step_deg=1.0):
    """Reference and target poses of one window per session, numpy."""
    trajs = [t_pipeline.orbit_trajectory(4, step_deg=step_deg,
                                         phase_deg=25.0 * i)
             for i in range(n_sessions)]
    ref = torch.stack([t[0] for t in trajs]).numpy()
    tgt = torch.stack([torch.stack(t[:2]) for t in trajs]).numpy()
    return ref, tgt


def _jax_fields(cfg_kw, ref, tgt):
    import jax.numpy as jnp

    ren = j_api.make_renderer(j_config.RenderConfig(**cfg_kw,
                                                    pallas_interpret=True))
    res = ren.pipeline.device_engine.render_windows(jnp.asarray(ref),
                                                    jnp.asarray(tgt))
    return {k: np.asarray(getattr(res, k)) for k in ("frames",) + INT_FIELDS}


def _port_fields(cfg_kw, ref, tgt):
    eng = torch_ranks.renderer(cfg_kw).pipeline.device_engine
    return torch_ranks.window_fields(eng.render_windows(
        torch.as_tensor(ref), torch.as_tensor(tgt)))


def _min_psnr(a, b):
    return min(float(psnr(torch.as_tensor(np.array(x)),
                          torch.as_tensor(np.array(y))))
               for x, y in zip(a.reshape(-1, *a.shape[-3:]),
                               b.reshape(-1, *b.shape[-3:])))


def _check_against_jax(got, want):
    for k in INT_FIELDS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert _min_psnr(got["frames"], want["frames"]) >= 40.0


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

CONFIG_CASES = {
    "shard_zero_devices": (dict(num_devices=0), {}),
    "shard_empty_axis": (dict(num_devices=2, axis_name=""), {}),
    "slots_not_divisible": (dict(num_devices=2), dict(num_slots=3)),
    "slots_divisible": (dict(num_devices=2), dict(num_slots=4)),
    "one_device_odd_slots": (dict(num_devices=1), dict(num_slots=3)),
    "fused_sharded": (dict(num_devices=2),
                      dict(num_slots=4, backend="streaming",
                           fused_tick=True)),
    "fused_one_device": (dict(num_devices=1),
                         dict(backend="streaming", fused_tick=True)),
    "adaptive_sharded": (dict(num_devices=4),
                         dict(num_slots=8, adaptive_sampling=True)),
}


def _outcome(mod, shard_kw, cfg_kw):
    try:
        cfg = mod.RenderConfig(shard=mod.ShardConfig(**shard_kw), **cfg_kw)
    except ValueError as e:
        return "raises", str(e)
    return "ok", cfg.shard.enabled


@pytest.mark.parametrize("case", sorted(CONFIG_CASES))
def test_shard_config_matches_reference(case):
    shard_kw, cfg_kw = CONFIG_CASES[case]
    assert _outcome(t_config, shard_kw, cfg_kw) == \
        _outcome(j_config, shard_kw, cfg_kw)


def test_shard_config_is_part_of_the_config_key():
    cfg = t_config.RenderConfig(num_slots=4,
                                shard=t_config.ShardConfig(num_devices=2))
    assert cfg.shard.enabled and not t_config.ShardConfig().enabled
    assert cfg != cfg.replace(shard=None)
    assert cfg.replace() in {cfg}  # hashable: a cache key


def test_make_mesh_is_none_when_off():
    assert raybatch.make_mesh(None, "cpu") is None
    assert raybatch.make_mesh(t_config.ShardConfig(num_devices=1),
                              "cpu") is None


def test_make_mesh_refuses_without_a_process_group():
    with pytest.raises(ValueError, match="process group has 0 ranks"):
        raybatch.make_mesh(t_config.ShardConfig(num_devices=2), "cpu")
    # the engine refuses the same way: no quiet unsharded fallback
    ren = torch_ranks.renderer(dict(RAYBATCH, shard=2))
    with pytest.raises(ValueError, match="process group has 0 ranks"):
        DeviceSparwEngine(ren.model, ren.params, config=ren.config)


def test_make_mesh_refuses_a_smaller_world(world_of_one):
    with pytest.raises(ValueError, match="requests 2 devices but the "
                                         "process group has 1 ranks"):
        raybatch.make_mesh(t_config.ShardConfig(num_devices=2), "cpu")


# ---------------------------------------------------------------------------
# render_windows over 2 ranks
# ---------------------------------------------------------------------------

RENDER_CASES = {
    "reference_backend": (dict(RAYBATCH), 1.0),
    "streaming_backend": (dict(RAYBATCH, backend="streaming"), 1.0),
    # the second session turns 20 degrees a frame and overflows a hole cap
    # of 8: the fallback stays deferred, and each rank that reads the
    # frames runs one dense fill over the gathered targets
    "overflow": (dict(RAYBATCH, hole_cap=8, pool_bucket=128), None),
}


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_sharded_render_windows_matches_unsharded(tmp_path, case):
    cfg_kw, step = RENDER_CASES[case]
    if step is None:
        (r0, t0), (r1, t1) = _windows(1, 0.5), _windows(2, 20.0)
        ref, tgt = np.stack([r0[0], r1[1]]), np.stack([t0[0], t1[1]])
    else:
        ref, tgt = _windows(2, step)
    outs = torch_ranks.launch(torch_ranks.render_windows_rank, 2, tmp_path,
                              dict(cfg_kw, shard=2), [(ref, tgt)])
    base = _port_fields(cfg_kw, ref, tgt)
    for rank, out in enumerate(outs):
        assert out["mesh"] == 2
        # each rank's own tick program, keyed on its S / D = 1 sessions
        assert [k[:3] for k in out["keys"]] == [("staged_sharded", 1, 2)]
        got = out["calls"][0]
        for k, v in base.items():
            np.testing.assert_array_equal(got[k], v, err_msg=(rank, k))
    _check_against_jax(outs[0]["calls"][0], _jax_fields(cfg_kw, ref, tgt))
    if step is None:
        assert base["overflowed"].tolist() == [False, True]
        assert [o["dense_fills"] for o in outs] == [1, 1]


def test_sharded_adaptive_render_windows(tmp_path):
    """Adaptive sampling's fine and coarse pools, 4 sessions on 2 ranks."""
    cfg_kw = dict(RAYBATCH, num_slots=4, adaptive_sampling=True,
                  coarse_factor=4, res=24, grid_res=24)
    ref, tgt = _windows(4, 3.0)
    (out0, out1) = torch_ranks.launch(torch_ranks.render_windows_rank, 2,
                                      tmp_path, dict(cfg_kw, shard=2),
                                      [(ref, tgt)])
    base = _port_fields(cfg_kw, ref, tgt)
    for got in (out0["calls"][0], out1["calls"][0]):
        for k, v in base.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert (base["fine_counts"] < base["hole_counts"]).any()
    _check_against_jax(out0["calls"][0], _jax_fields(cfg_kw, ref, tgt))


def test_sharded_session_counts(tmp_path):
    """S = 3 over 2 ranks raises the reference's error; S = 1 renders
    unsharded on every rank."""
    ref, tgt = _windows(3)
    outs = torch_ranks.launch(
        torch_ranks.render_windows_rank, 2, tmp_path,
        dict(RAYBATCH, shard=2), [(ref, tgt), (ref[:1], tgt[:1])])
    base = _port_fields(RAYBATCH, ref[:1], tgt[:1])
    for out in outs:
        assert out["calls"][0] == ("render_windows: 3 sessions cannot shard "
                                   "evenly over 2 devices")
        for k, v in base.items():
            np.testing.assert_array_equal(out["calls"][1][k], v)


def test_rank1_renders_rank0_params(tmp_path):
    """The engine takes rank 0's params (and MVoxel table): rank 1, handed
    another scene's, renders rank 0's frames."""
    cfg_kw = dict(RAYBATCH, backend="streaming")
    ref, tgt = _windows(2)
    outs = torch_ranks.launch(torch_ranks.render_windows_rank, 2, tmp_path,
                              dict(cfg_kw, shard=2), [(ref, tgt)], "ficus")
    base = _port_fields(cfg_kw, ref, tgt)
    other = torch_ranks.window_fields(torch_ranks.renderer(
        cfg_kw, "ficus").pipeline.device_engine.render_windows(
        torch.as_tensor(ref), torch.as_tensor(tgt)))
    assert not np.array_equal(other["frames"], base["frames"])
    for out in outs:
        np.testing.assert_array_equal(out["calls"][0]["frames"],
                                      base["frames"])


# ---------------------------------------------------------------------------
# staged serving over 2 ranks
# ---------------------------------------------------------------------------

# (sid, frames, orbit phase, scene): uneven lengths, so slots drain and
# refill at different ticks
FLEET = [(0, 5, 0.0, None), (1, 2, 25.0, None), (2, 3, 50.0, None),
         (3, 4, 75.0, None)]
# the multi-scene fleet of tests/test_torch_multiscene_serve.py, staged
SCENE_FLEET = [(0, 4, 0.0, "chair"), (1, 2, 120.0, "drums"),
               (2, 2, 60.0, "ficus"), (3, 2, 200.0, "drums"),
               (4, 2, 300.0, "ficus")]


def _serve_port(cfg_kw, fleet, tables=None):
    ren = torch_ranks.renderer(cfg_kw)
    loader = None if tables is None else (
        lambda name: torch.as_tensor(tables[name]))
    eng = t_serve.RenderServeEngine(ren.model, ren.params, config=ren.config,
                                    scene_loader=loader)
    sess = [t_serve.RenderSession(sid=sid, poses=list(
        t_pipeline.orbit_trajectory(n, step_deg=4.0, phase_deg=ph)),
        scene=sc) for sid, n, ph, sc in fleet]
    metrics = eng.run(sess)
    return [torch_ranks.session_result(s) for s in sess], metrics


def _serve_jax(cfg_kw, fleet, multi_scene):
    ren = j_api.make_renderer(j_config.RenderConfig(**cfg_kw,
                                                    pallas_interpret=True))
    loader = None if not multi_scene else (
        lambda name: j_scenes.bake_dense_table(
            j_scenes.make_scene(name), cfg_kw["grid_res"],
            cfg_kw["channels"]))
    eng = j_serve.RenderServeEngine(ren.model, ren.params, config=ren.config,
                                    scene_loader=loader)
    sess = [j_serve.RenderSession(sid=sid, poses=list(
        j_pipeline.orbit_trajectory(n, step_deg=4.0, phase_deg=ph)),
        scene=sc) for sid, n, ph, sc in fleet]
    return sess, eng.run(sess)


def _run_stats(m):
    """``run()``'s metrics without walls, latencies and waits."""
    return {"ticks": m["ticks"], "complete": m["complete"],
            "total_frames": m["total_frames"], "pool": m["pool"],
            "memory": m["memory"], "slots": m["slots"],
            "scene_cache": m["scene_cache"],
            "queue": {k: m["queue"][k]
                      for k in ("depth_mean", "depth_max", "shed")},
            "per_session": {s: {k: v for k, v in row.items()
                                if "latency" not in k}
                            for s, row in m["per_session"].items()}}


@pytest.mark.parametrize("multi_scene", [False, True],
                         ids=["one_scene", "multi_scene"])
def test_sharded_staged_serving_matches_unsharded(tmp_path, multi_scene):
    """The staged serving engine over 2 ranks: frames, per-session stats
    and ``run()``'s statistics equal to the unsharded port's on every
    rank, ``"devices"`` 2, frames >= 40 dB from JAX's and equal stats. The
    reference runs its multi-scene fleet sharded over two forced host
    devices (its pages replicated), so the port shards it the same way,
    every page on every rank."""
    fleet = SCENE_FLEET if multi_scene else FLEET
    tables = None
    if multi_scene:
        tables = {name: t_scenes.bake_dense_table(
            t_scenes.make_scene(name), SERVE["grid_res"],
            SERVE["channels"]).numpy()
            for name in ("chair", "drums", "ficus")}
    outs = torch_ranks.launch(torch_ranks.serve_rank, 2, tmp_path,
                              dict(SERVE, shard=2), fleet, tables)
    base, base_m = _serve_port(SERVE, fleet, tables)
    assert base_m["devices"] == 1
    for out in outs:
        assert out["metrics"]["devices"] == 2
        assert _run_stats(out["metrics"]) == _run_stats(base_m)
        for got, want in zip(out["sessions"], base):
            np.testing.assert_array_equal(got["frames"], want["frames"])
            assert got["stats"] == want["stats"]
    j_sess, j_m = _serve_jax(SERVE, fleet, multi_scene)
    assert j_m["ticks"] == base_m["ticks"]
    for got, js in zip(outs[0]["sessions"], j_sess):
        assert got["stats"]["hole_fractions"] == js.stats.hole_fractions
        assert got["stats"]["sparse_pixels"] == js.stats.sparse_pixels
        assert _min_psnr(got["frames"],
                         np.stack([np.array(f) for f in js.frames])) >= 40.0
