"""The port's NeRF primitives against the JAX package on the same inputs:
camera and rays, poses, scenes and the baked table, the dense gather, the
decoders and volume compositing."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pipeline as j_pipeline
from repro.nerf import grids as j_grids
from repro.nerf import models as j_models
from repro.nerf import mlp as j_mlp
from repro.nerf import rays as j_rays
from repro.nerf import scenes as j_scenes
from repro.nerf import volrend as j_volrend
from repro_torch.core import pipeline as t_pipeline
from repro_torch.nerf import grids as t_grids
from repro_torch.nerf import models as t_models
from repro_torch.nerf import mlp as t_mlp
from repro_torch.nerf import rays as t_rays
from repro_torch.nerf import scenes as t_scenes
from repro_torch.nerf import volrend as t_volrend


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("res", [32, 48, 64])
def test_camera_and_rays_match_reference(res):
    j_cam, t_cam = j_rays.Camera.square(res), t_rays.Camera.square(res)
    assert (t_cam.focal, t_cam.cx, t_cam.cy) == (j_cam.focal, j_cam.cx,
                                                  j_cam.cy)
    poses = j_pipeline.orbit_trajectory(3, step_deg=7.0, phase_deg=10.0)
    jo, jd = j_rays.generate_rays_batch(j_cam, jnp.stack(poses))
    to, td = t_rays.generate_rays_batch(t_cam, _t(jnp.stack(poses)))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)
    jp, jt = j_rays.sample_along_rays(jo[0], jd[0], 0.5, 6.0, 32)
    tp, tt = t_rays.sample_along_rays(to[0], td[0], 0.5, 6.0, 32)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-6)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5)


def test_orbit_trajectory_matches_reference():
    want = j_pipeline.orbit_trajectory(12, step_deg=1.5, phase_deg=25.0)
    got = t_pipeline.orbit_trajectory(12, step_deg=1.5, phase_deg=25.0)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


@pytest.mark.parametrize("name", ["lego", "ship"])
def test_scene_and_baked_table_match_reference(name):
    j_sc, t_sc = j_scenes.make_scene(name), t_scenes.make_scene(name)
    np.testing.assert_array_equal(t_sc.centers, np.asarray(j_sc.centers))
    np.testing.assert_array_equal(t_sc.radii, np.asarray(j_sc.radii))
    np.testing.assert_array_equal(t_sc.albedos, np.asarray(j_sc.albedos))
    want = np.asarray(j_scenes.bake_dense_table(j_sc, 20, 8))
    got = t_scenes.bake_dense_table(t_sc, 20, 8).numpy()
    # vertex coordinates may differ by one float32 ulp (linspace rounding);
    # density's slope reaches density_scale * sharpness / 4 = 600 per unit,
    # so sigma may move by ~1e-4 and the colours by far less
    np.testing.assert_allclose(got[:, 0], want[:, 0], atol=2e-4, rtol=1e-5)
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], atol=2e-5)


def test_dense_gather_matches_reference():
    rng = np.random.default_rng(4)
    table = rng.standard_normal((20**3, 8)).astype(np.float32)
    pts = rng.uniform(-1.05, 1.05, size=(3000, 3)).astype(np.float32)
    j_ids, j_w = j_grids.corner_ids_weights(jnp.asarray(pts), 20)
    t_ids, t_w = t_grids.corner_ids_weights(torch.as_tensor(pts), 20)
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    np.testing.assert_allclose(t_w.numpy(), np.asarray(j_w), atol=1e-6)
    want = j_grids.dense_query({"table": jnp.asarray(table)},
                               jnp.asarray(pts), j_grids.DenseGridCfg(20, 8))
    got = t_grids.dense_query({"table": torch.as_tensor(table)},
                              torch.as_tensor(pts), t_grids.DenseGridCfg(20, 8))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("mode", ["mlp", "direct"])
def test_decoder_matches_reference(mode):
    rng = np.random.default_rng(5)
    j_cfg = j_mlp.DecoderCfg(mode=mode, in_channels=8, hidden=32)
    t_cfg = t_mlp.DecoderCfg(mode=mode, in_channels=8, hidden=32)
    feats = (4.0 * rng.standard_normal((500, 8))).astype(np.float32)
    dirs = rng.standard_normal((500, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    gen = torch.Generator().manual_seed(0)
    params = {k: v.numpy() for k, v in
              t_mlp.decoder_init(gen, t_cfg).items()}
    j_sig, j_rgb = j_mlp.decode({k: jnp.asarray(v) for k, v in params.items()},
                                jnp.asarray(feats), jnp.asarray(dirs), j_cfg)
    t_sig, t_rgb = t_mlp.decode({k: torch.as_tensor(v)
                                 for k, v in params.items()},
                                torch.as_tensor(feats), torch.as_tensor(dirs),
                                t_cfg)
    np.testing.assert_allclose(t_sig.numpy(), np.asarray(j_sig), atol=2e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(t_rgb.numpy(), np.asarray(j_rgb), atol=2e-5,
                               rtol=1e-5)
    assert t_mlp.decoder_flops(t_cfg) == j_mlp.decoder_flops(j_cfg)


def test_softplus_has_no_linear_cutover():
    x = torch.tensor([0.0, 19.0, 25.0, 40.0, -30.0])
    want = np.asarray(jnp.logaddexp(jnp.asarray(x.numpy()), 0.0))
    np.testing.assert_array_equal(t_mlp.softplus(x).numpy(), want)


def test_composite_matches_reference():
    rng = np.random.default_rng(6)
    sig = (rng.uniform(-1, 30, size=(200, 32))).astype(np.float32)
    rgb = rng.uniform(0, 1, size=(200, 32, 3)).astype(np.float32)
    t = np.broadcast_to(np.linspace(0.5, 6.0, 32, dtype=np.float32),
                        (200, 32)).copy()
    want = j_volrend.composite(jnp.asarray(sig), jnp.asarray(rgb),
                               jnp.asarray(t), 6.0)
    got = t_volrend.composite(torch.as_tensor(sig), torch.as_tensor(rgb),
                              torch.as_tensor(t), 6.0)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("backend", ["reference", "streaming"])
def test_render_image_batch_matches_reference(backend):
    kw = dict(grid_res=16, channels=4, decoder="direct", num_samples=16,
              backend=backend, stream_capacity=32)
    j_model, _ = j_models.make_model("dvgo", **kw)
    t_model, _ = t_models.make_model("dvgo", **kw)
    j_par = j_model.prepare_streaming(
        j_model.init_baked(j_scenes.make_scene("lego")))
    t_par = t_model.prepare_streaming({"table": _t(j_par["table"]),
                                       "decoder": {}})
    poses = jnp.stack(j_pipeline.orbit_trajectory(2, step_deg=20.0))
    want = j_model.render_image_batch(j_par, j_rays.Camera.square(16),
                                      poses, chunk=128)
    got = t_model.render_image_batch(t_par, t_rays.Camera.square(16),
                                     _t(poses), chunk=128)
    # colours in [0, 1], depths up to far = 6: float32 sums, 1e-5 relative
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)
