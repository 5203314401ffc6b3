"""The port's MVoxel streaming structures and the streaming gather against
the JAX package on the same numpy inputs: the halo table, local corner ids,
the Ray Index Table (equal, overflow and dump-segment cases included) and
``gather_features_streaming`` with its overflow fallback."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import streaming as j_streaming
from repro.kernels import ops as j_ops
from repro_torch.core import streaming as t_streaming
from repro_torch.kernels import ops as t_ops


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    return j_streaming.StreamingCfg(**kw), t_streaming.StreamingCfg(**kw)


def _points(rng, n, pile=0):
    pts = rng.uniform(-1.0, 1.0, size=(n, 3)).astype(np.float32)
    pts[:pile] = 0.01  # pile samples into one MVoxel: forces overflow
    return pts


@pytest.mark.parametrize("layout", ["identity", "bank_interleaved"])
def test_mvoxel_table_and_local_ids_match_reference(layout):
    rng = np.random.default_rng(1)
    jc, tc = _cfgs(grid_res=24, layout=layout)
    table = rng.standard_normal((24**3, 4)).astype(np.float32)
    want = np.asarray(j_streaming.build_mvoxel_table(jnp.asarray(table), jc))
    got = t_streaming.build_mvoxel_table(torch.as_tensor(table), tc)
    np.testing.assert_array_equal(got.numpy(), want)
    assert tc.halo_rows == jc.halo_rows == want.shape[1]
    pts = _points(rng, 2000)
    j_ids, j_w = j_streaming.local_corner_ids(jnp.asarray(pts), jc)
    t_ids, t_w = t_streaming.local_corner_ids(torch.as_tensor(pts), tc)
    np.testing.assert_array_equal(
        t_streaming.remap_local_ids(t_ids, tc).numpy(),
        np.asarray(j_streaming.remap_local_ids(j_ids, jc)))
    np.testing.assert_allclose(t_w.numpy(), np.asarray(j_w), atol=1e-6)
    np.testing.assert_array_equal(
        t_streaming.mvoxel_ids(torch.as_tensor(pts), tc).numpy(),
        np.asarray(j_streaming.mvoxel_ids(jnp.asarray(pts), jc)))


@pytest.mark.parametrize("case", ["fits", "overflow", "dump_segment"])
def test_build_rit_matches_reference(case):
    rng = np.random.default_rng(2)
    cap = {"fits": 512, "overflow": 16, "dump_segment": 16}[case]
    jc, tc = _cfgs(grid_res=24, capacity=cap)
    mv = np.array(j_streaming.mvoxel_ids(
        jnp.asarray(_points(rng, 3000, pile=400)), jc))
    num_slots = None
    if case == "dump_segment":
        # two segments plus padding samples routed past the last slot
        seg = np.arange(mv.size) % 3
        mv = np.where(seg == 2, 2 * jc.num_mvoxels, mv + seg * jc.num_mvoxels)
        num_slots = 2 * jc.num_mvoxels
    want = j_streaming.build_rit(jnp.asarray(mv, jnp.int32), jc,
                                 num_slots=num_slots)
    got = t_streaming.build_rit(torch.as_tensor(mv), tc, num_slots=num_slots)
    for name, w, g in zip(want._fields, want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    if case != "fits":
        assert np.asarray(want.overflow).any()


@pytest.mark.parametrize("case", [
    "plain", "overflow", "bank_interleaved", "segments", "one_seg_padding"])
def test_gather_features_streaming_matches_reference(case):
    rng = np.random.default_rng(3)
    layout = "bank_interleaved" if case == "bank_interleaved" else "identity"
    cap = 8 if case == "overflow" else 64
    jc, tc = _cfgs(grid_res=24, capacity=cap, layout=layout)
    table = rng.standard_normal((24**3, 4)).astype(np.float32)
    pts = _points(rng, 2400, pile=200 if case == "overflow" else 0)
    seg, num_seg = None, 1
    if case == "segments":
        seg, num_seg = np.arange(2400) % 4, 3  # segment 3 is the dump
    elif case == "one_seg_padding":
        # at num_seg = 1 padding samples still take RIT capacity
        seg = (np.arange(2400) >= 2000).astype(np.int64)
    want = j_ops.gather_features_streaming(
        jnp.asarray(table), jnp.asarray(pts), jc,
        seg=None if seg is None else jnp.asarray(seg, jnp.int32),
        num_seg=num_seg, interpret=True)
    got = t_ops.gather_features_streaming(
        torch.as_tensor(table), torch.as_tensor(pts), tc,
        seg=None if seg is None else torch.as_tensor(seg), num_seg=num_seg)
    keep = slice(None) if case != "segments" else seg < num_seg
    np.testing.assert_allclose(got.numpy()[keep], np.asarray(want)[keep],
                               atol=2e-5, rtol=1e-5)
    if case == "overflow":
        blocks = t_ops.rit_blocks(torch.as_tensor(pts), tc)
        assert blocks.rit.overflow.any()
