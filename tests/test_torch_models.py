"""Slice 11 of the port, the paper's other model families: the hash grid
(Instant-NGP), the VM grid (TensoRF), the analytic ``oracle`` and the
paper's configs (``configs/cicero_nerf.py``), against the JAX package on
the same numpy inputs and weights.

Tolerances: hash ids are integers and must be equal; trilinear weights and
grid features are float32 sums of a few products in another order, held
at the reference's kernel tolerance atol 2e-5 / rtol 1e-5; the oracle's
density reaches 60 with a slope of up to 600 per unit, so it is held at
atol 2e-4 (its colours at 2e-5); rays rendered through the streaming
backend's MLP decoder (JAX: Pallas in interpret mode; the port: B2's plain
version) at 1e-4 (64 samples composited); whole frames at >= 40 dB PSNR
with equal hole counts and ``RenderStats``, the port's rule for frames."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as j_api
from repro.configs import cicero_nerf as j_cn
from repro.core import config as j_config
from repro.core import pipeline as j_pipeline
from repro.core.engine import DeviceSparwEngine as JEngine
from repro.nerf import grids as j_grids
from repro.nerf import models as j_models
from repro.nerf import scenes as j_scenes
from repro.serve import render_engine as j_serve
from repro_torch import api as t_api
from repro_torch.configs import cicero_nerf as t_cn
from repro_torch.convert import params_from_numpy
from repro_torch.core import config as t_config
from repro_torch.core import pipeline as t_pipeline
from repro_torch.core.engine import DeviceSparwEngine as TEngine
from repro_torch.nerf import grids as t_grids
from repro_torch.nerf import models as t_models
from repro_torch.nerf import scenes as t_scenes
from repro_torch.serve import render_engine as t_serve
from repro_torch.utils import params_device, psnr

F32 = dict(atol=2e-5, rtol=1e-5)
CONFIG_NAMES = ["DVGO", "NGP", "TENSORF", "DVGO_BENCH", "NGP_BENCH",
                "TENSORF_BENCH"]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _points(n, seed, lo=-1.05, hi=1.05):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, (n, 3)).astype(np.float32)


def _models(name, **kw):
    """The JAX and port models of config ``name`` with ``kw`` replaced,
    and the JAX model's weights (key 0) as numpy."""
    j_cfg = dataclasses.replace(getattr(j_cn, name), **kw)
    t_cfg = dataclasses.replace(getattr(t_cn, name), **kw)
    j_model, t_model = j_models.NerfModel(j_cfg), t_models.NerfModel(t_cfg)
    return j_model, t_model, _np_tree(j_model.init(jax.random.PRNGKey(0)))


# ---------------------------------------------------------------------------
# the configs and the grids
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", CONFIG_NAMES)
def test_configs_match_reference(name):
    j_cfg, t_cfg = getattr(j_cn, name), getattr(t_cn, name)
    want = dataclasses.asdict(j_cfg)
    want.pop("pallas_interpret")
    assert dataclasses.asdict(t_cfg) == want
    assert t_cfg.feat_channels == j_cfg.feat_channels
    assert t_cfg.feature_table_bytes() == j_cfg.feature_table_bytes()
    assert t_cfg.decoder_cfg.in_channels == j_cfg.decoder_cfg.in_channels
    jh, th = j_cfg.hash_cfg, t_cfg.hash_cfg
    assert th.out_channels == jh.out_channels
    for level in range(jh.num_levels):
        assert th.level_res(level) == jh.level_res(level)
        assert th.level_dense(level) == jh.level_dense(level)
    assert dataclasses.asdict(t_cfg.tensorf_cfg) == dataclasses.asdict(
        j_cfg.tensorf_cfg)
    assert t_cn.NERF_CONFIGS.keys() == j_cn.NERF_CONFIGS.keys()
    assert t_cn.NERF_BENCH_CONFIGS.keys() == j_cn.NERF_BENCH_CONFIGS.keys()
    assert dataclasses.asdict(t_cn.CiceroPipelineCfg()) == \
        dataclasses.asdict(j_cn.CiceroPipelineCfg())


@pytest.mark.parametrize("name", ["NGP", "NGP_BENCH"])
def test_hash_ids_and_weights_match_reference(name):
    """Every level; at ``cicero-ngp`` the hashed levels reach res 1024,
    where each prime's product passes 2^32 (the reference's uint32
    wraparound)."""
    j_cfg, t_cfg = getattr(j_cn, name).hash_cfg, getattr(t_cn, name).hash_cfg
    pts = _points(4000, 1)
    hashed = 0
    for level in range(j_cfg.num_levels):
        j_ids, j_w = j_grids.hash_level_ids_weights(jnp.asarray(pts), j_cfg,
                                                    level)
        t_ids, t_w = t_grids.hash_level_ids_weights(torch.as_tensor(pts),
                                                    t_cfg, level)
        np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids),
                                      err_msg=f"level {level}")
        np.testing.assert_allclose(t_w.numpy(), np.asarray(j_w), **F32)
        hashed += not t_cfg.level_dense(level)
    assert hashed >= 3


def test_hash_of_corner_coords_wraps_as_uint32():
    coords = np.array([[1023, 1023, 1023], [1, 2, 3], [0, 0, 0],
                       [1023, 0, 1023], [512, 777, 1]], np.int32)
    for size in (2**19, 2**14, 12345):
        want = j_grids._hash_coords(jnp.asarray(coords), size)
        got = t_grids._hash_coords(torch.as_tensor(coords), size)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["NGP_BENCH", "TENSORF_BENCH", "TENSORF"])
def test_grid_query_matches_reference(name):
    """``hash_query`` / ``tensorf_query`` on the reference's weights,
    carried across by ``params_from_numpy`` (lists stay lists)."""
    j_cfg, t_cfg = getattr(j_cn, name), getattr(t_cn, name)
    pts = _points(3000, 2)
    if j_cfg.kind == "ngp":
        jp = j_grids.hash_init(jax.random.PRNGKey(3), j_cfg.hash_cfg)
        want = j_grids.hash_query(jp, jnp.asarray(pts), j_cfg.hash_cfg)
        tp = params_from_numpy(_np_tree(jp), "cpu")
        assert isinstance(tp["tables"], list)
        got = t_grids.hash_query(tp, torch.as_tensor(pts), t_cfg.hash_cfg)
    else:
        jp = j_grids.tensorf_init(jax.random.PRNGKey(3), j_cfg.tensorf_cfg)
        want = j_grids.tensorf_query(jp, jnp.asarray(pts),
                                     j_cfg.tensorf_cfg)
        tp = params_from_numpy(_np_tree(jp), "cpu")
        assert [len(tp[k]) for k in ("planes", "lines")] == [3, 3]
        got = t_grids.tensorf_query(tp, torch.as_tensor(pts),
                                    t_cfg.tensorf_cfg)
    assert got.shape == (3000, t_cfg.feat_channels)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("kind", ["dvgo", "ngp", "tensorf"])
def test_query_features_match_reference(kind):
    """``NerfModel.query_features`` on both backends: the streaming dense
    grid takes the Gathering Unit path, the other kinds their plain
    queries."""
    kw = dict(grid_res=16, channels=5, hash_levels=4, hash_table_size=2**10,
              hash_base_res=4, hash_max_res=64, tensorf_rank=3)
    pts = _points(800, 4)
    for backend in ("reference", "streaming"):
        j_model, _ = j_models.make_model(kind, backend=backend,
                                         pallas_interpret=True, **kw)
        t_model, _ = t_models.make_model(kind, backend=backend, **kw)
        jp = j_model.prepare_streaming(j_model.init(jax.random.PRNGKey(5)))
        tp = t_model.prepare_streaming(
            params_from_numpy(_np_tree(jp), "cpu"))
        assert ("mv_table" in tp) == (kind == "dvgo"
                                      and backend == "streaming")
        want = j_model.query_features(jp, jnp.asarray(pts))
        got = t_model.query_features(tp, torch.as_tensor(pts))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_oracle_query_field_matches_reference():
    """The fig. 26 scene: "materials" with a specular lobe of 0.6."""
    j_sc = j_scenes.make_scene("materials", specular=0.6)
    t_sc = t_scenes.make_scene("materials", specular=0.6)
    rng = np.random.default_rng(6)
    pts = _points(4000, 6, -1.0, 1.0)
    d = rng.standard_normal((4000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    j_model, _ = j_models.make_model("oracle", scene=j_sc)
    t_model, _ = t_models.make_model("oracle", scene=t_sc)
    j_sig, j_rgb = j_model.query_field({}, jnp.asarray(pts), jnp.asarray(d))
    t_sig, t_rgb = t_model.query_field({}, torch.as_tensor(pts),
                                       torch.as_tensor(d))
    np.testing.assert_allclose(t_sig.numpy(), np.asarray(j_sig), atol=2e-4,
                               rtol=1e-5)
    np.testing.assert_allclose(t_rgb.numpy(), np.asarray(j_rgb), **F32)
    lobe = t_scenes.scene_radiance(t_sc, torch.as_tensor(pts),
                                   torch.as_tensor(d)) \
        - t_scenes.scene_albedo(t_sc, torch.as_tensor(pts))
    assert float(lobe.max()) > 0.1  # the specular lobe is exercised


@pytest.mark.parametrize("kind", ["ngp", "tensorf"])
def test_render_rays_streaming_mlp_matches_reference(kind):
    """The streaming backend's MLP decoder (kernel B2) over the hash / VM
    features: C = 12 (6 levels x 2) and C = 8 at hidden 32."""
    name = {"ngp": "NGP_BENCH", "tensorf": "TENSORF_BENCH"}[kind]
    j_model, t_model, np_params = _models(name, backend="streaming")
    j_model = j_models.NerfModel(dataclasses.replace(
        j_model.cfg, pallas_interpret=True))
    tp = params_from_numpy(np_params, "cpu")
    rng = np.random.default_rng(7)
    o = np.tile(np.array([[0.0, 0.3, 2.6]], np.float32), (96, 1))
    d = rng.standard_normal((96, 3)).astype(np.float32) * 0.2
    d[:, 2] = -1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    j_col, j_dep = j_model.render_rays(np_params, jnp.asarray(o),
                                       jnp.asarray(d))
    t_col, t_dep = t_model.render_rays(tp, torch.as_tensor(o),
                                       torch.as_tensor(d))
    np.testing.assert_allclose(t_col.numpy(), np.asarray(j_col), atol=1e-4)
    np.testing.assert_allclose(t_dep.numpy(), np.asarray(j_dep), atol=1e-4)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


@pytest.mark.parametrize("kind", ["dvgo", "ngp", "tensorf", "oracle"])
def test_init_shapes_scales_and_seed(kind):
    kw = dict(grid_res=24, channels=6, hash_levels=3, hash_table_size=2**12,
              tensorf_rank=4, mlp_hidden=32)
    j_model, _ = j_models.make_model(kind, **kw)
    t_model, _ = t_models.make_model(kind, **kw)
    want = j_model.init(jax.random.PRNGKey(0))
    gen = lambda seed: torch.Generator().manual_seed(seed)
    got = t_model.init(gen(0), device="cpu")
    assert _shapes(got) == _shapes(_np_tree(want))
    again, other = t_model.init(gen(0), "cpu"), t_model.init(gen(1), "cpu")
    flat = lambda t: torch.cat([x.reshape(-1) for x in jax.tree_util
                                .tree_leaves(t, is_leaf=torch.is_tensor)])
    assert torch.equal(flat(got), flat(again))
    assert not torch.equal(flat(got), flat(other))
    scales = {"table": 0.01, "tables": 0.01, "planes": 0.1, "lines": 0.1,
              "basis": 1.0 / np.sqrt(3 * 4)}
    for key, scale in scales.items():
        if key in got:
            vals = torch.cat([x.reshape(-1) for x in (
                got[key] if isinstance(got[key], list) else [got[key]])])
            assert abs(float(vals.std()) / scale - 1.0) < 0.15, key
    w1 = got["decoder"]["w1"]
    assert w1.shape[0] == t_model.cfg.feat_channels
    assert abs(float(w1.std()) * np.sqrt(w1.shape[0]) - 1.0) < 0.15


def test_init_needs_a_card_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model, _ = t_models.make_model("ngp", hash_levels=2,
                                   hash_table_size=2**8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(torch.Generator().manual_seed(0))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    assert {t.device.type for t in params["tables"]} == {"cpu"}


# ---------------------------------------------------------------------------
# the slice end to end: make_renderer -> render / serve
# ---------------------------------------------------------------------------

SLICE = dict(res=16, window=4, backend="streaming")


def _renderers(name):
    if name == "oracle":  # the analytic specular scene, params {}
        j_model, _ = j_models.make_model(
            "oracle", scene=j_scenes.make_scene("materials", specular=0.6),
            num_samples=32)
        t_model, _ = t_models.make_model(
            "oracle", scene=t_scenes.make_scene("materials", specular=0.6),
            num_samples=32)
        np_params = {}
    else:
        j_model, t_model, np_params = _models(name, backend="streaming")
    j_ren = j_api.make_renderer(
        j_config.RenderConfig(**SLICE, pallas_interpret=True),
        model=j_model, params=np_params)
    t_ren = t_api.make_renderer(t_config.RenderConfig(**SLICE),
                                model=t_model,
                                params=params_from_numpy(np_params, "cpu"),
                                device="cpu")
    return j_ren, t_ren


def _same_frames_and_stats(got, want):
    for k in ("frames", "reference_renders", "warped_pixels",
              "sparse_pixels", "fallback_pixels", "total_pixels",
              "hole_fractions"):
        assert getattr(got.stats, k) == getattr(want.stats, k), k
    assert got.stats.sparse_pixels > 0
    assert len(got.frames) == len(want.frames) == 8
    for g, w in zip(got.frames, want.frames):
        assert g.shape == (16, 16, 3)
        assert float(psnr(g, torch.as_tensor(np.array(w)))) >= 40.0


@pytest.mark.parametrize("name", ["NGP_BENCH", "TENSORF_BENCH", "oracle"])
@pytest.mark.parametrize("entry", ["render", "serve"])
def test_slice_matches_reference(name, entry):
    j_ren, t_ren = _renderers(name)
    j_traj = j_pipeline.orbit_trajectory(8, step_deg=4.0)
    t_traj = t_pipeline.orbit_trajectory(8, step_deg=4.0)
    if entry == "render":
        want = j_ren.render(j_config.RenderRequest(poses=tuple(j_traj)))
        got = t_ren.render(t_config.RenderRequest(poses=tuple(t_traj)))
        _same_frames_and_stats(got, want)
        return
    (want,), j_m = j_ren.serve([j_config.RenderRequest(poses=tuple(j_traj))])
    (got,), t_m = t_ren.serve([t_config.RenderRequest(poses=tuple(t_traj))])
    _same_frames_and_stats(got, want)
    assert t_m["ticks"] == j_m["ticks"] == 2
    assert t_m["pool"] == j_m["pool"]
    assert t_m["memory"] is None and j_m["memory"] is None


def test_oracle_renderer_matches_reference():
    """The fig. 26 setup through ``CiceroRenderer(model, {}, ...)``: the
    specular "materials" scene, window 4, 8 frames 4 degrees apart, the
    warp-angle threshold at 4 degrees."""
    j_model, _ = j_models.make_model(
        "oracle", scene=j_scenes.make_scene("materials", specular=0.6),
        num_samples=32)
    t_model, _ = t_models.make_model(
        "oracle", scene=t_scenes.make_scene("materials", specular=0.6),
        num_samples=32)
    kw = dict(res=24, window=4, phi_deg=4.0)
    j_ren = j_pipeline.CiceroRenderer(j_model, {},
                                      config=j_config.RenderConfig(**kw))
    t_ren = t_pipeline.CiceroRenderer(
        t_model, {}, config=t_config.RenderConfig(**kw, device="cpu"))
    assert t_ren.device == torch.device("cpu")
    want_f, want_s = j_ren.render_trajectory(
        j_pipeline.orbit_trajectory(8, step_deg=4.0))
    got_f, got_s = t_ren.render_trajectory(
        t_pipeline.orbit_trajectory(8, step_deg=4.0))
    assert dataclasses.asdict(got_s) == dataclasses.asdict(want_s)
    assert got_s.sparse_pixels > 0
    for g, w in zip(got_f, want_f):
        assert float(psnr(g, torch.as_tensor(np.array(w)))) >= 40.0


# ---------------------------------------------------------------------------
# what the reference refuses, and the device rule
# ---------------------------------------------------------------------------


def _ngp_pair():
    kw = dict(hash_levels=2, hash_table_size=2**8, backend="streaming")
    j_model, _ = j_models.make_model("ngp", **kw)
    t_model, _ = t_models.make_model("ngp", **kw)
    np_params = _np_tree(j_model.init(jax.random.PRNGKey(0)))
    return j_model, t_model, np_params


def test_fused_tick_and_multi_scene_refuse_other_kinds():
    j_model, t_model, np_params = _ngp_pair()
    tp = params_from_numpy(np_params, "cpu")
    j_cfg = j_config.RenderConfig(res=16, backend="streaming",
                                  fused_tick=True)
    t_cfg = t_config.RenderConfig(res=16, backend="streaming",
                                  fused_tick=True, device="cpu")
    for engine, model, params, cfg in ((JEngine, j_model, np_params, j_cfg),
                                       (TEngine, t_model, tp, t_cfg)):
        with pytest.raises(ValueError, match="fused_tick requires a dvgo"):
            engine(model, params, config=cfg)
    loader = lambda name: None
    for serve, model, params, cfg in (
            (j_serve, j_model, np_params, j_cfg.replace(fused_tick=False)),
            (t_serve, t_model, tp, t_cfg.replace(fused_tick=False))):
        with pytest.raises(ValueError, match="multi-scene serving needs"):
            serve.RenderServeEngine(model, params, config=cfg,
                                    scene_loader=loader)


def test_make_renderer_without_model_bakes_dvgo_only():
    for kind in ("ngp", "tensorf", "oracle"):
        with pytest.raises(ValueError, match="model_kind"):
            t_api.make_renderer(t_config.RenderConfig(model_kind=kind),
                                device="cpu")
    with pytest.raises(ValueError, match="kind must be"):
        t_models.NerfConfig(kind="mipnerf")
    with pytest.raises(ValueError, match="dvgo"):
        t_models.NerfModel(t_models.NerfConfig(kind="ngp", decoder="direct")
                           ).init_baked(t_scenes.make_scene("lego"))


def test_params_on_another_device_raise():
    _, t_model, np_params = _ngp_pair()
    tp = params_from_numpy(np_params, "cpu")
    cfg = t_config.RenderConfig(res=16, backend="streaming")
    with pytest.raises(ValueError, match="params on cpu"):
        TEngine(t_model, tp, config=cfg.replace(device="meta"))
    mixed = dict(tp, tables=[tp["tables"][0],
                             tp["tables"][1].to("meta")])
    with pytest.raises(ValueError, match="params on meta"):
        params_device(mixed)
    assert params_device(tp) == torch.device("cpu")
    assert params_device({}, "cpu") == torch.device("cpu")
    assert TEngine(t_model, tp, config=cfg).device == torch.device("cpu")


# ---------------------------------------------------------------------------
# lists in params
# ---------------------------------------------------------------------------


def test_params_from_numpy_keeps_lists():
    tree = {"tables": [np.zeros((4, 2), np.float32),
                       np.ones((4, 2), np.float32)],
            "planes": (np.zeros((3, 3, 2), np.float32),),
            "decoder": {"w1": np.eye(2, dtype=np.float32)}}
    got = params_from_numpy(tree, "cpu")
    assert isinstance(got["tables"], list) and len(got["tables"]) == 2
    assert all(isinstance(t, torch.Tensor) for t in got["tables"])
    assert torch.equal(got["tables"][1], torch.ones(4, 2))
    assert isinstance(got["planes"], list) and got["planes"][0].shape == \
        (3, 3, 2)
    assert got["decoder"]["w1"].dtype == torch.float32


def test_to_device_keeps_lists():
    tree = {"tables": [torch.zeros(3), torch.ones(2)],
            "decoder": {"w1": torch.eye(2)}}
    got = t_api._to_device(tree, torch.device("cpu"))
    assert isinstance(got["tables"], list) and len(got["tables"]) == 2
    assert torch.equal(got["tables"][1], torch.ones(2))
    moved = t_api._to_device(tree, torch.device("meta"))
    assert [t.device.type for t in moved["tables"]] == ["meta", "meta"]
    assert moved["decoder"]["w1"].device.type == "meta"
