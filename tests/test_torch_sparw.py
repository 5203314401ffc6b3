"""The port's SpaRW stages against the JAX package on the same inputs: the
flat warp (hole masks), the hole compactions, the flat ray batches and the
reference-pose schedule."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pipeline as j_pipeline
from repro.core import raybatch as j_raybatch
from repro.core import schedule as j_schedule
from repro.core import sparw as j_sparw
from repro.nerf import rays as j_rays
from repro_torch.core import raybatch as t_raybatch
from repro_torch.core import schedule as t_schedule
from repro_torch.core import sparw as t_sparw
from repro_torch.nerf import models as t_models
from repro_torch.nerf import rays as t_rays
from repro_torch.nerf import scenes as t_scenes


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def ref_frames():
    """Two sessions' reference frames (rendered by the port on the CPU)
    and three target poses each, as numpy arrays fed to both packages."""
    model, _ = t_models.make_model("dvgo", grid_res=32, channels=4,
                                   decoder="direct", num_samples=16)
    params = model.init_baked(t_scenes.make_scene("lego"))
    refs = [j_pipeline.orbit_trajectory(1, phase_deg=p)[0] for p in (0, 40)]
    tgts = [j_pipeline.orbit_trajectory(3, step_deg=3.0, phase_deg=p + 2)
            for p in (0, 40)]
    ref_poses = np.array(jnp.stack(refs))
    rgb, dep = model.render_image_batch(params, t_rays.Camera.square(32),
                                        torch.as_tensor(ref_poses))
    return (rgb.numpy(), dep.numpy(), ref_poses,
            np.array(jnp.stack([jnp.stack(t) for t in tgts])))


@pytest.mark.parametrize("phi_deg", [None, 2.0])
def test_warp_frames_flat_matches_reference(ref_frames, phi_deg):
    rgb, dep, ref_poses, tgt_poses = ref_frames
    want = j_sparw.warp_frames_flat(*map(jnp.asarray, ref_frames),
                                    j_rays.Camera.square(32), phi_deg=phi_deg)
    got = t_sparw.warp_frames_flat(*map(_t, ref_frames),
                                   t_rays.Camera.square(32), phi_deg=phi_deg)
    j_holes, t_holes = np.asarray(want.holes), got.holes.numpy()
    # projected pixel positions are rounded to the nearest pixel; a point
    # within float32 rounding of a pixel edge can round either way in the
    # two packages' matrix products, so allow 0.1% of the pixels to differ
    assert (j_holes != t_holes).mean() <= 1e-3
    both = ~j_holes & ~t_holes
    np.testing.assert_allclose(got.rgb.numpy()[both],
                               np.asarray(want.rgb)[both], atol=1e-5)
    np.testing.assert_allclose(got.depth.numpy()[both],
                               np.asarray(want.depth)[both], atol=1e-4)
    single = t_sparw.warp_frame(_t(rgb[1]), _t(dep[1]), _t(ref_poses[1]),
                                _t(tgt_poses[1, 2]), t_rays.Camera.square(32),
                                phi_deg=phi_deg)
    np.testing.assert_array_equal(single.holes.numpy(), t_holes[1, 2])


def _random_holes(rng, s, n, hw, frac):
    return rng.uniform(size=(s, n, hw)) < frac


@pytest.mark.parametrize("bucket", [64, 1024])
def test_compact_holes_pooled_matches_reference(bucket):
    rng = np.random.default_rng(7)
    holes = _random_holes(rng, 3, 4, 256, 0.08)
    live = np.arange(4)[None, :] < np.array([[4], [2], [3]])
    want = j_sparw.compact_holes_pooled(jnp.asarray(holes), bucket,
                                        jnp.asarray(live))
    got = t_sparw.compact_holes_pooled(torch.as_tensor(holes), bucket,
                                       torch.as_tensor(live))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_compact_holes_per_frame_match_reference():
    rng = np.random.default_rng(8)
    holes = _random_holes(rng, 2, 3, 300, 0.1)
    for cap in (16, 64):
        want = j_sparw.compact_holes_flat(jnp.asarray(holes), cap)
        got = t_sparw.compact_holes_flat(torch.as_tensor(holes), cap)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        w_idx, w_n = j_sparw.compact_holes(jnp.asarray(holes[1, 2]), cap)
        g_idx, g_n = t_sparw.compact_holes(torch.as_tensor(holes[1, 2]), cap)
        np.testing.assert_array_equal(g_idx.numpy(), np.asarray(w_idx))
        assert int(g_n) == int(w_n)
    assert float(t_sparw.hole_fraction(torch.as_tensor(holes))) == \
        pytest.approx(float(j_sparw.hole_fraction(jnp.asarray(holes))))


def test_ray_batches_match_reference(ref_frames):
    _, _, ref_poses, tgt_poses = ref_frames
    j_cam, t_cam = j_rays.Camera.square(32), t_rays.Camera.square(32)
    rng = np.random.default_rng(9)
    addr = rng.integers(0, 3 * 1024, size=(2, 128)).astype(np.int32)
    idx = rng.integers(0, 1024, size=(2, 3, 40)).astype(np.int32)
    pairs = [
        (j_raybatch.pack_reference_rays(j_cam, jnp.asarray(ref_poses)),
         t_raybatch.pack_reference_rays(t_cam, _t(ref_poses))),
        (j_raybatch.pack_hole_rays_pooled(j_cam, jnp.asarray(tgt_poses),
                                          jnp.asarray(addr)),
         t_raybatch.pack_hole_rays_pooled(t_cam, _t(tgt_poses), _t(addr))),
        (j_raybatch.pack_hole_rays(j_cam, jnp.asarray(tgt_poses),
                                   jnp.asarray(idx)),
         t_raybatch.pack_hole_rays(t_cam, _t(tgt_poses), _t(idx))),
    ]
    for want, got in pairs:
        if isinstance(want, tuple) and len(want) == 2:
            np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
            want, got = want[0], got[0]
        np.testing.assert_array_equal(got.seg.numpy(), np.asarray(want.seg))
        np.testing.assert_array_equal(got.origins.numpy(),
                                      np.asarray(want.origins))
        np.testing.assert_allclose(got.dirs.numpy(), np.asarray(want.dirs),
                                   atol=1e-6)
    vals = rng.standard_normal((50, 3)).astype(np.float32)
    dst = rng.integers(0, 30, size=50)
    valid = rng.uniform(size=50) < 0.5
    dst[valid] = rng.permutation(30)[:valid.sum()]  # unique valid targets
    want = j_raybatch.scatter_segments(jnp.asarray(vals), jnp.asarray(dst),
                                       jnp.asarray(valid), 30)
    got = t_raybatch.scatter_segments(_t(vals), _t(dst), _t(valid), 30)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("window", [3, 8])
def test_reference_schedule_matches_reference(window):
    poses = j_pipeline.orbit_trajectory(20, step_deg=2.0, phase_deg=5.0)
    want = j_schedule.WarpSchedule(window, "offtraj").windows(poses)
    got = t_schedule.WarpSchedule(window, "offtraj").windows(
        [_t(p) for p in poses])
    assert [w["frames"] for w in want] == [g["frames"] for g in got]
    for w, g in zip(want, got):
        np.testing.assert_allclose(g["ref_pose"].numpy(),
                                   np.asarray(w["ref_pose"]), atol=2e-6)
    rot = np.asarray(poses[7])[:3, :3]
    np.testing.assert_allclose(
        t_schedule.so3_log(_t(rot)).numpy(),
        np.asarray(j_schedule.so3_log(jnp.asarray(rot))), atol=1e-6)
