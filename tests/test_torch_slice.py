"""Slice 1 of the port as a whole: ``repro_torch.api.make_renderer(cfg,
device="cpu")`` against ``repro.api.make_renderer(cfg)`` on the same
trajectory, both backends and both decoders (MLP weights carried across
with ``params_from_numpy``), plus the pooled-capacity controller."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as j_api
from repro.core import config as j_config
from repro.core import pipeline as j_pipeline
from repro.nerf import models as j_models
from repro_torch import api as t_api
from repro_torch.convert import params_from_numpy
from repro_torch.core import config as t_config
from repro_torch.core import pipeline as t_pipeline
from repro_torch.nerf import models as t_models
from repro_torch.utils import psnr


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _mlp_params(grid_res, c, hidden, seed=0):
    rng = np.random.default_rng(seed)
    shapes = dict(w1=(c, hidden), b1=(hidden,), w2=(hidden, hidden),
                  b2=(hidden,), w_sigma=(hidden, 1), w_rgb=(hidden + 9, 3),
                  b_rgb=(3,))
    dec = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
           for k, s in shapes.items()}
    table = rng.standard_normal((grid_res**3, c)).astype(np.float32)
    return {"table": table, "decoder": dec}


# small-capacity RIT (stream_capacity 64) so the overflow fallback runs;
# hole_cap 16 forces the dense window fallback; pool_holes=False takes the
# per-frame fixed-capacity hole batch
@pytest.mark.parametrize("backend,decoder,hole_cap,pool_holes", [
    ("reference", "direct", None, True),
    ("streaming", "direct", None, True),
    ("reference", "mlp", None, True),
    ("streaming", "mlp", None, True),
    ("streaming", "direct", 16, True),
    ("streaming", "direct", None, False),
])
def test_slice_matches_reference(backend, decoder, hole_cap, pool_holes):
    c = 4 if decoder == "direct" else 8
    kw = dict(scene="lego", res=32, window=3, grid_res=24, channels=c,
              decoder=decoder, num_samples=16, backend=backend,
              stream_capacity=64, hole_cap=hole_cap, pool_holes=pool_holes)
    j_cfg, t_cfg = j_config.RenderConfig(**kw), t_config.RenderConfig(**kw)
    if decoder == "direct":
        j_ren = j_api.make_renderer(j_cfg)
        t_ren = t_api.make_renderer(t_cfg, device="cpu")
    else:
        params = _mlp_params(24, c, 32)
        mk = dict(grid_res=24, channels=c, decoder="mlp", mlp_hidden=32,
                  num_samples=16, backend=backend, stream_capacity=64)
        j_model, _ = j_models.make_model("dvgo", **mk)
        t_model, _ = t_models.make_model("dvgo", **mk)
        j_ren = j_api.make_renderer(
            j_cfg, model=j_model,
            params={"table": jnp.asarray(params["table"]),
                    "decoder": {k: jnp.asarray(v)
                                for k, v in params["decoder"].items()}})
        t_ren = t_api.make_renderer(t_cfg, model=t_model,
                                    params=params_from_numpy(params, "cpu"),
                                    device="cpu")
    want = j_ren.render(j_config.RenderRequest(
        poses=tuple(j_pipeline.orbit_trajectory(7, step_deg=2.0))))
    got = t_ren.render(t_config.RenderRequest(
        poses=tuple(t_pipeline.orbit_trajectory(7, step_deg=2.0))))
    assert len(got.frames) == len(want.frames) == 7
    for g, w in zip(got.frames, want.frames):
        assert g.shape == (32, 32, 3) and g.device.type == "cpu"
        assert float(psnr(g, torch.as_tensor(np.array(w)))) >= 40.0
    assert got.stats.frames == want.stats.frames
    assert got.stats.reference_renders == want.stats.reference_renders
    assert abs(got.stats.sparse_pixels - want.stats.sparse_pixels) <= \
        0.01 * max(want.stats.sparse_pixels, 1)
    if hole_cap is not None:
        assert want.stats.fallback_pixels > 0  # the dense fallback ran
        assert got.stats.fallback_pixels > 0


def test_hole_cap_controller_matches_reference():
    kw = dict(worst=16 * 1024, min_bucket=128, safety=1.25, alpha=0.4)
    j_ctl = j_config.HoleCapController(**kw)
    t_ctl = t_config.HoleCapController(**kw)
    assert t_ctl.bucket == j_ctl.bucket == 16384
    for total in (900, 150, 40, 2000, 0, 0, 0, 7000):
        j_ctl.observe(total)
        t_ctl.observe(total)
        assert t_ctl.bucket == j_ctl.bucket
    for n in (0, 1, 3, 128, 129):
        assert t_config.next_pow2(n) == j_config.next_pow2(n)


def test_render_stats_and_requests_match_reference():
    j_st, t_st = j_config.RenderStats(), t_config.RenderStats()
    for holes, ovf in ((10, False), (300, True), (0, False)):
        j_st.record_frame(holes, ovf, 1024)
        t_st.record_frame(holes, ovf, 1024)
    j_st.reference_renders = t_st.reference_renders = 1
    assert t_st.mlp_work_fraction == pytest.approx(j_st.mlp_work_fraction)
    assert t_st.mean_hole_fraction == pytest.approx(j_st.mean_hole_fraction)
    t_cfg = t_config.RenderConfig(window=8)
    req = t_config.RenderRequest(poses=(torch.eye(4),), window=4, hole_cap=64)
    assert t_cfg.apply_request(req) == t_config.RenderConfig(window=4,
                                                             hole_cap=64)
    with pytest.raises(ValueError):
        t_config.RenderConfig(pool_min_bucket=100)
    with pytest.raises(ValueError):
        t_config.RenderRequest(poses=())
