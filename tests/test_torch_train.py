"""NeRF training in the port (``repro_torch.nerf.train``: ``fit_field`` and
``train_images``) and the stratified ray jitter, against the JAX package on
the same numpy inputs and weights, at small widths (grid 16, 3 hash levels
of 2^10, rank 4, hidden 16, 8 samples a ray).

Tolerances, and why:

* jittered sample depths: the reference's own draw is injected; depths
  within 1e-6 and points within 1e-5, test_torch_nerf's rule (``jnp.linspace``
  rounds one ulp apart from ``torch.linspace``); without jitter the port is
  bit-equal to its evenly spaced depths;
* one step's loss: rtol 1e-5; one step's grads: per leaf rtol 1e-4 and atol
  1e-5 x the leaf's largest reference grad (float32 sums over 256 points or
  32 rays x 8 samples in another order; measured <= 4e-7 of the largest).
  Params after a step are not compared entry by entry: at step 1 Adam moves
  every entry by about +-lr whatever its grad's size, so float noise in a
  near-zero grad would flip a sign (see test_torch_optim.py for the update
  itself on identical grads);
* a whole fit_field run of each package: the held-out loss on a fixed numpy
  point set, each package's within a factor 1.25 of the other's and both
  below 0.8 x the loss at the start (the draws differ, so only outcomes are
  compared);
* frames of a streaming model after training: bit-equal to a fresh model
  object's on the same params (nothing cached from before training).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nerf import models as j_models
from repro.nerf import rays as j_rays
from repro.nerf import scenes as j_scenes
from repro.nerf import train as j_train
from repro_torch import api as t_api
from repro_torch.convert import params_from_numpy
from repro_torch.core.config import RenderConfig, RenderRequest
from repro_torch.core.pipeline import orbit_trajectory
from repro_torch.nerf import models as t_models
from repro_torch.nerf import rays as t_rays
from repro_torch.nerf import scenes as t_scenes
from repro_torch.nerf import train as t_train
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw import tree_flatten

KINDS = {
    "dvgo": dict(grid_res=16, channels=4),
    "ngp": dict(hash_levels=3, hash_table_size=2**10, hash_base_res=4,
                hash_max_res=32),
    "tensorf": dict(grid_res=16, tensorf_rank=4, channels=4),
}
SMALL = dict(mlp_hidden=16, num_samples=8, stream_capacity=64)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scenes_pair():
    return j_scenes.make_scene("lego"), t_scenes.make_scene("lego")


def _models(kind, **kw):
    cfg = dict(KINDS[kind], **SMALL, **kw)
    j_model, _ = j_models.make_model(kind, **cfg)
    t_model, _ = t_models.make_model(kind, **cfg)
    return j_model, t_model


def _weights(j_model, seed=0):
    """The reference's init at ``seed`` as numpy, and the same on the
    port (CPU)."""
    np_params = jax.tree.map(np.asarray, j_model.init(
        jax.random.PRNGKey(seed)))
    return np_params, params_from_numpy(np_params, "cpu")


def _assert_grads_close(t_grads, j_grads):
    t_leaves, j_leaves = tree_flatten(t_grads)[0], jax.tree.leaves(j_grads)
    assert len(t_leaves) == len(j_leaves)
    for i, (g, w) in enumerate(zip(t_leaves, j_leaves)):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=f"grad leaf {i} {w.shape}")


def _unit_dirs(rng, n):
    d = rng.standard_normal((n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _j_field_loss(model, p, pts, dirs, sig_t, rgb_t):
    # restated from src/repro/nerf/train.py:27-33
    sig, rgb = model.query_field(p, pts, dirs)
    w = (sig_t > 1.0).astype(jnp.float32)[:, None]
    l_sig = jnp.mean((jnp.log1p(sig) - jnp.log1p(sig_t)) ** 2)
    l_rgb = jnp.sum(w * (rgb - rgb_t) ** 2) / (jnp.sum(w) * 3.0 + 1e-6)
    return l_sig + l_rgb


def _j_image_loss(model, p, o, d, target, k):
    # restated from src/repro/nerf/train.py:74-76
    color, _ = model.render_rays(p, o, d, key=k)
    return jnp.mean((color - target) ** 2)


# ---------------------------------------------------------------------------
# the stratified jitter
# ---------------------------------------------------------------------------


def _rays(n_rays, seed=0):
    cam = j_rays.Camera.square(8)
    o, d = j_rays.generate_rays(cam, j_rays.orbit_pose(jnp.asarray(0.4)))
    idx = np.random.default_rng(seed).choice(o.shape[0], n_rays,
                                             replace=False)
    return np.asarray(o)[idx], np.asarray(d)[idx]


def test_jittered_samples_match_reference_draw():
    o, d = _rays(32)
    key = jax.random.PRNGKey(7)
    near, far, n = 0.5, 6.0, 16
    jp, jt = j_rays.sample_along_rays(jnp.asarray(o), jnp.asarray(d), near,
                                      far, n, key)
    draw = jax.random.uniform(key, (32, n), minval=0.0,
                              maxval=(far - near) / n)
    tp, tt = t_rays.sample_along_rays(torch.from_numpy(o),
                                      torch.from_numpy(d), near, far, n,
                                      jitter=torch.from_numpy(
                                          np.array(draw)))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-6)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5)
    plain = t_rays.sample_along_rays(torch.from_numpy(o), torch.from_numpy(d),
                                     near, far, n)[1]
    assert torch.equal(tt, plain + torch.from_numpy(np.array(draw)))


def test_unjittered_samples_are_unchanged_and_generator_jitter_strata():
    o, d = (torch.from_numpy(a) for a in _rays(32))
    plain = torch.linspace(0.5, 6.0, 16, dtype=torch.float32).expand(32, 16)
    pts, t = t_rays.sample_along_rays(o, d, 0.5, 6.0, 16)
    assert torch.equal(t, plain)
    assert torch.equal(pts, o[:, None, :] + d[:, None, :] * plain[..., None])
    pts_none, t_none = t_rays.sample_along_rays(o, d, 0.5, 6.0, 16,
                                                jitter=None)
    assert torch.equal(t_none, t) and torch.equal(pts_none, pts)
    _, t1 = t_rays.sample_along_rays(o, d, 0.5, 6.0, 16,
                                     jitter=torch.Generator().manual_seed(3))
    _, t2 = t_rays.sample_along_rays(o, d, 0.5, 6.0, 16,
                                     jitter=torch.Generator().manual_seed(3))
    off = t1 - plain
    assert torch.equal(t1, t2)
    assert bool((off >= 0).all()) and bool((off < 5.5 / 16).all())
    assert float(off.std()) > 0.05


@pytest.mark.parametrize("kind", ["ngp"])
def test_jittered_render_rays_matches_reference(kind):
    j_model, t_model = _models(kind)
    np_params, t_params = _weights(j_model)
    o, d = _rays(24, seed=1)
    key = jax.random.PRNGKey(5)
    c = j_model.cfg
    draw = jax.random.uniform(key, (24, c.num_samples), minval=0.0,
                              maxval=(c.far - c.near) / c.num_samples)
    jc, jd = j_model.render_rays(jax.tree.map(jnp.asarray, np_params),
                                 jnp.asarray(o), jnp.asarray(d), key=key)
    tc, td = t_model.render_rays(t_params, torch.from_numpy(o),
                                 torch.from_numpy(d),
                                 jitter=torch.from_numpy(np.array(draw)))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-4)


# ---------------------------------------------------------------------------
# one step against jax.value_and_grad
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("decoder", ["mlp", "direct"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_field_step_matches_reference_grads(kind, decoder, scenes_pair):
    j_scene, t_scene = scenes_pair
    j_model, t_model = _models(kind, decoder=decoder)
    np_params, t_params = _weights(j_model)
    rng = np.random.default_rng(11)
    pts = rng.uniform(-1.0, 1.0, (256, 3)).astype(np.float32)
    dirs = _unit_dirs(rng, 256)
    jp, jd = jnp.asarray(pts), jnp.asarray(dirs)
    sig_t = j_scenes.scene_density(j_scene, jp)
    rgb_t = j_scenes.scene_albedo(j_scene, jp)
    assert int((sig_t > 1.0).sum()) > 20  # the rgb term is exercised
    j_loss, j_grads = jax.value_and_grad(
        lambda p: _j_field_loss(j_model, p, jp, jd, sig_t, rgb_t))(
            jax.tree.map(jnp.asarray, np_params))
    new_params, _, t_loss, t_grads = t_train.field_step(
        t_model, t_scene, t_params, adamw_init(t_params), 0,
        torch.from_numpy(pts), torch.from_numpy(dirs), lr=5e-3, steps=400)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
    _assert_grads_close(t_grads, j_grads)
    for old, new in zip(tree_flatten(t_params)[0],
                        tree_flatten(new_params)[0]):
        assert new is not old and new.shape == old.shape


@pytest.mark.parametrize("kind", list(KINDS))
def test_image_step_matches_reference_grads(kind):
    j_model, t_model = _models(kind)
    np_params, t_params = _weights(j_model, seed=1)
    o, d = _rays(32, seed=2)
    target = np.random.default_rng(3).uniform(0, 1, (32, 3)).astype(
        np.float32)
    key = jax.random.PRNGKey(9)
    c = j_model.cfg
    draw = np.array(jax.random.uniform(
        key, (32, c.num_samples), minval=0.0,
        maxval=(c.far - c.near) / c.num_samples))
    j_loss, j_grads = jax.value_and_grad(
        lambda p: _j_image_loss(j_model, p, jnp.asarray(o), jnp.asarray(d),
                                jnp.asarray(target), key))(
            jax.tree.map(jnp.asarray, np_params))
    _, _, t_loss, t_grads = t_train.image_step(
        t_model, t_params, adamw_init(t_params), 0, torch.from_numpy(o),
        torch.from_numpy(d), torch.from_numpy(target),
        torch.from_numpy(draw), lr=5e-3, steps=300)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
    _assert_grads_close(t_grads, j_grads)


# ---------------------------------------------------------------------------
# whole runs
# ---------------------------------------------------------------------------


def test_fit_field_whole_run_matches_reference_outcome(scenes_pair):
    j_scene, t_scene = scenes_pair
    j_model, t_model = _models("dvgo")
    steps, batch = 60, 512
    rng = np.random.default_rng(21)
    pts = rng.uniform(-1.0, 1.0, (2048, 3)).astype(np.float32)
    dirs = _unit_dirs(rng, 2048)
    jp, jd = jnp.asarray(pts), jnp.asarray(dirs)
    sig_t = j_scenes.scene_density(j_scene, jp)
    rgb_t = j_scenes.scene_albedo(j_scene, jp)

    def j_held_out(p):
        return float(_j_field_loss(j_model, p, jp, jd, sig_t, rgb_t))

    def t_held_out(p):
        tp, td = torch.from_numpy(pts), torch.from_numpy(dirs)
        return float(t_train.field_loss(
            t_model, p, tp, td, t_scenes.scene_density(t_scene, tp),
            t_scenes.scene_albedo(t_scene, tp)))

    key = jax.random.PRNGKey(0)
    j_before = j_held_out(j_model.init(key))
    j_after = j_held_out(j_train.fit_field(j_model, j_scene, key,
                                           steps=steps, batch=batch))
    t_before = t_held_out(t_model.init(torch.Generator().manual_seed(0),
                                       device="cpu"))
    fitted = t_train.fit_field(t_model, t_scene,
                               torch.Generator().manual_seed(0),
                               steps=steps, batch=batch, device="cpu")
    assert all(p.device.type == "cpu" for p in tree_flatten(fitted)[0])
    t_after = t_held_out(fitted)
    assert np.isfinite([j_after, t_after]).all()
    assert j_after < 0.8 * j_before and t_after < 0.8 * t_before
    assert 1 / 1.25 < t_after / j_after < 1.25, (t_after, j_after)


def test_train_images_runs_and_lowers_the_loss(scenes_pair):
    _, t_scene = scenes_pair
    _, t_model = _models("ngp")
    oracle, _ = t_models.make_model("oracle", scene=t_scene,
                                    **dict(SMALL, num_samples=16))
    cam = t_rays.Camera.square(12)
    poses = orbit_trajectory(3, step_deg=30.0)
    gt = lambda c2w: oracle.render_image({}, cam, c2w)
    params, losses = t_train.train_images(
        t_model, gt, cam, poses, torch.Generator().manual_seed(0), steps=40,
        rays_per_batch=128, lr=2e-2, device="cpu")
    assert len(losses) == 40 and all(isinstance(x, float) for x in losses)
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < 0.7 * np.mean(losses[:5]), losses
    assert tree_flatten(params)[0][0].device.type == "cpu"


# ---------------------------------------------------------------------------
# hazards: configs the reference cannot differentiate, and stale caches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("decoder", ["mlp", "direct"])
@pytest.mark.parametrize("backend", ["reference", "streaming"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_training_refuses_what_the_reference_cannot_differentiate(
        kind, backend, decoder, scenes_pair):
    """Both packages' fit_field and train_images, one small step each:
    they raise ValueError for exactly the same (kind, backend, decoder)."""
    j_scene, t_scene = scenes_pair
    j_model, t_model = _models(kind, backend=backend, decoder=decoder)

    def outcome(run):
        try:
            run()
        except ValueError:
            return "raises"
        return "trains"

    j_cam, t_cam = j_rays.Camera.square(4), t_rays.Camera.square(4)
    j_pose = j_rays.orbit_pose(jnp.asarray(0.3))
    t_pose = t_rays.orbit_pose(0.3)
    want = [
        outcome(lambda: j_train.fit_field(j_model, j_scene,
                                          jax.random.PRNGKey(0), steps=1,
                                          batch=32)),
        outcome(lambda: j_train.train_images(
            j_model, lambda p: (jnp.zeros((4, 4, 3)), None), j_cam,
            jnp.stack([j_pose]), jax.random.PRNGKey(0), steps=1,
            rays_per_batch=8))]
    got = [
        outcome(lambda: t_train.fit_field(t_model, t_scene,
                                          torch.Generator().manual_seed(0),
                                          steps=1, batch=32, device="cpu")),
        outcome(lambda: t_train.train_images(
            t_model, lambda p: (torch.zeros(4, 4, 3), None), t_cam,
            [t_pose], torch.Generator().manual_seed(0), steps=1,
            rays_per_batch=8, device="cpu"))]
    assert got == want
    expect = (backend == "streaming"
              and (kind == "dvgo" or decoder == "mlp"))
    assert want == (["raises"] * 2 if expect else ["trains"] * 2)


def test_streaming_render_after_training_sees_the_new_params(scenes_pair):
    """One streaming model object renders before and after training (its
    halo-table cache holds the old table); its frames on the trained
    params equal a fresh model object's, and differ from before."""
    _, t_scene = scenes_pair
    cfg = t_models.NerfConfig(kind="dvgo", **KINDS["dvgo"], **SMALL,
                              backend="streaming")
    streaming = t_models.NerfModel(cfg)
    trainer = t_models.NerfModel(dataclasses.replace(cfg,
                                                     backend="reference"))
    rcfg = RenderConfig(res=12, window=4, backend="streaming")
    req = RenderRequest(poses=tuple(orbit_trajectory(4)))

    def frames(model, params):
        out = t_api.make_renderer(rcfg, model=model, params=params,
                                  device="cpu").render(req)
        return torch.stack(list(out.frames)), out.stats

    p0 = trainer.init(torch.Generator().manual_seed(0), device="cpu")
    before, _ = frames(streaming, p0)
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.uniform(-1, 1, (512, 3)).astype(np.float32))
    dirs = torch.from_numpy(_unit_dirs(rng, 512))
    p1, _, _, _ = t_train.field_step(trainer, t_scene, p0, adamw_init(p0), 0,
                                     pts, dirs, lr=5e-2, steps=10)
    fitted = t_train.fit_field(trainer, t_scene,
                               torch.Generator().manual_seed(0), steps=3,
                               batch=256, device="cpu")
    for params in (p1, fitted):
        got, stats = frames(streaming, params)
        want, fresh_stats = frames(t_models.NerfModel(cfg), params)
        assert torch.equal(got, want)
        assert stats == fresh_stats
        assert not torch.equal(got, before)
    again, _ = frames(streaming, p0)
    assert torch.equal(again, before)
