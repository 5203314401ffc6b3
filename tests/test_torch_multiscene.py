"""Slice 3 of the port, multi-scene serving below the engine: the plain
versions of kernels B4 (``gather_trilerp_mvoxels_per_seg``) and B5
(``fused_gather_dual_per_seg``) against the JAX package's Pallas kernels
(interpret mode) on the same numpy inputs (also at 40 channels) and, bit
for bit, against B1/B3 on each segment's page; the ``scene_of_seg`` branch of
``gather_features_streaming`` and ``gather_features_tick_scenes`` (RIT,
overflow and dump-segment cases); ``SceneCache``; and the model's
stacked-page pass-through."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import streaming as j_streaming
from repro.kernels import gather_trilerp as j_gt
from repro.kernels import ops as j_ops
from repro.kernels import streaming_pipeline as j_sp
from repro_torch.core import streaming as t_streaming
from repro_torch.core.scene_cache import ParamsToken, SceneCache
from repro_torch.kernels import gather_trilerp as t_gt
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import streaming_pipeline as t_sp
from repro_torch.nerf import models as t_models
from repro_torch.nerf import scenes as t_scenes

# the reference's own kernel tolerances (tests/test_kernels.py)
F32_TOL = dict(atol=2e-5, rtol=1e-5)
BF16_TOL = dict(atol=3e-2, rtol=3e-2)
K = 3  # resident pages
SCENE_MAPS = {1: [2], 2: [2, 0], 3: [1, 1, 0]}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    return j_streaming.StreamingCfg(**kw), t_streaming.StreamingCfg(**kw)


def _pages(rng, jc, res=16):
    """K dense tables [K, res^3, 4] and their halo tables [K, num_mv, P,
    4], built by the JAX package (the port's build is tested equal)."""
    tables = rng.standard_normal((K, res**3, 4)).astype(np.float32)
    mv = np.stack([np.asarray(j_streaming.build_mvoxel_table(
        jnp.asarray(t), jc)) for t in tables])
    return tables, mv


def _rit_set(rng, rows, cap, p):
    ids = rng.integers(0, p, size=(rows, cap, 8)).astype(np.int32)
    w = rng.uniform(0.0, 1.0, size=(rows, cap, 8)).astype(np.float32)
    pad = rng.uniform(size=(rows, cap)) < 0.3  # RIT pad rows: id 0, w 0
    ids[pad] = 0
    w[pad] = 0.0
    return ids, w


def _tables(pages, dtype):
    j_tab, t_tab = jnp.asarray(pages), torch.as_tensor(pages)
    if dtype == "bfloat16":
        return j_tab.astype(jnp.bfloat16), t_tab.to(torch.bfloat16)
    return j_tab, t_tab


def _assert_close(got, want, dtype):
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, dtype=np.float32), **tol)


# ---------------------------------------------------------------------------
# B4 / B5 plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_seg", [1, 3])
@pytest.mark.parametrize("layout", ["identity", "bank_interleaved"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_per_seg_plain_matches_pallas(dtype, layout, num_seg):
    rng = np.random.default_rng(10 + num_seg)
    jc, _ = _cfgs(grid_res=16, capacity=32, layout=layout)
    _, pages = _pages(rng, jc)
    num_mv, p = pages.shape[1:3]
    ids, w = _rit_set(rng, num_seg * num_mv, 32, p)
    scn = np.asarray(SCENE_MAPS[num_seg], np.int32)
    j_tab, t_tab = _tables(pages, dtype)
    want = j_gt.gather_trilerp_mvoxels_per_seg(
        j_tab[jnp.asarray(scn)], jnp.asarray(ids), jnp.asarray(w),
        num_seg=num_seg, interpret=True)
    got = t_gt.gather_trilerp_mvoxels_per_seg(
        t_tab, torch.as_tensor(scn), torch.as_tensor(ids),
        torch.as_tensor(w), num_seg=num_seg)
    assert got.dtype == t_tab.dtype
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("num_seg", [1, 3])
@pytest.mark.parametrize("layout", ["identity", "bank_interleaved"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_gather_dual_per_seg_plain_matches_pallas(dtype, layout,
                                                        num_seg):
    rng = np.random.default_rng(20 + num_seg)
    jc, _ = _cfgs(grid_res=16, capacity=32, layout=layout)
    _, pages = _pages(rng, jc)
    num_mv, p = pages.shape[1:3]
    ids_h, w_h = _rit_set(rng, num_seg * num_mv, 32, p)
    ids_r, w_r = _rit_set(rng, num_seg * num_mv, 64, p)
    scn = np.asarray(SCENE_MAPS[num_seg], np.int32)
    j_tab, t_tab = _tables(pages, dtype)
    want = j_sp.fused_gather_dual_per_seg(
        j_tab[jnp.asarray(scn)], jnp.asarray(ids_h), jnp.asarray(w_h),
        jnp.asarray(ids_r), jnp.asarray(w_r), num_seg=num_seg,
        interpret=True)
    got = t_sp.fused_gather_dual_per_seg(
        t_tab, torch.as_tensor(scn), torch.as_tensor(ids_h),
        torch.as_tensor(w_h), torch.as_tensor(ids_r), torch.as_tensor(w_r),
        num_seg=num_seg)
    for g, wt in zip(got, want):
        assert g.dtype == t_tab.dtype
        _assert_close(g, wt, dtype)


@pytest.mark.parametrize("kernel", ["B4", "B5"])
def test_per_seg_plain_matches_pallas_at_40_channels(kernel):
    """Plain B4 and B5 against their Pallas kernels (interpret mode) at
    C = 40, fp32, grid 16: two [729, 40] blocks exceed one H100 block's
    shared memory and C exceeds the old kernels' 32 (fault C4)."""
    rng = np.random.default_rng(40)
    jc, _ = _cfgs(grid_res=16, capacity=32)
    tables = rng.standard_normal((K, 16**3, 40)).astype(np.float32)
    pages = np.stack([np.asarray(j_streaming.build_mvoxel_table(
        jnp.asarray(t), jc)) for t in tables])
    num_mv, p = pages.shape[1:3]
    scn = np.asarray(SCENE_MAPS[3], np.int32)
    sets = _rit_set(rng, 3 * num_mv, 32, p)
    if kernel == "B5":
        sets += _rit_set(rng, 3 * num_mv, 64, p)
    j_tab = jnp.asarray(pages)[jnp.asarray(scn)]
    t_args = [torch.as_tensor(a) for a in (pages, scn) + sets]
    if kernel == "B4":
        want = (j_gt.gather_trilerp_mvoxels_per_seg(
            j_tab, *(jnp.asarray(a) for a in sets), num_seg=3,
            interpret=True),)
        got = (t_gt.gather_trilerp_mvoxels_per_seg(*t_args, num_seg=3),)
    else:
        want = j_sp.fused_gather_dual_per_seg(
            j_tab, *(jnp.asarray(a) for a in sets), num_seg=3,
            interpret=True)
        got = t_sp.fused_gather_dual_per_seg(*t_args, num_seg=3)
    for g, wt in zip(got, want):
        assert g.dtype == torch.float32
        _assert_close(g, wt, "float32")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_per_seg_plain_bit_equal_to_single_scene_on_each_page(dtype):
    """Plain B4 on segment s == plain B1 on page scene_of_seg[s], and plain
    B5 == plain B3 the same way; a page outside [0, K) gives NaN rows."""
    rng = np.random.default_rng(5)
    jc, _ = _cfgs(grid_res=16, capacity=16)
    _, pages = _pages(rng, jc)
    num_mv, p = pages.shape[1:3]
    pages_t = torch.as_tensor(pages).to(dtype)
    scn = torch.tensor([2, 0, 2, 1], dtype=torch.int32)
    ns = scn.numel()
    ids_h, w_h = (torch.as_tensor(a) for a in _rit_set(rng, ns * num_mv,
                                                        16, p))
    ids_r, w_r = (torch.as_tensor(a) for a in _rit_set(rng, ns * num_mv,
                                                        32, p))
    b4 = t_gt.gather_trilerp_mvoxels_per_seg(pages_t, scn, ids_h, w_h,
                                             num_seg=ns)
    b5 = t_sp.fused_gather_dual_per_seg(pages_t, scn, ids_h, w_h, ids_r, w_r,
                                        num_seg=ns)
    rows = lambda x, s: x[s * num_mv:(s + 1) * num_mv]
    for s in range(ns):
        page = pages_t[int(scn[s])]
        b1 = t_gt.gather_trilerp_mvoxels(page, rows(ids_h, s), rows(w_h, s))
        assert torch.equal(rows(b4, s), b1)
        b3 = t_sp.fused_gather_dual(page, rows(ids_h, s), rows(w_h, s),
                                    rows(ids_r, s), rows(w_r, s), num_seg=1)
        for got, want in zip(b5, b3):
            assert torch.equal(rows(got, s), want)
    bad = torch.tensor([1, K, -1, 0], dtype=torch.int32)
    out = t_gt.gather_trilerp_mvoxels_per_seg(pages_t, bad, ids_h, w_h,
                                              num_seg=ns)
    assert torch.isnan(rows(out, 1)).all() and torch.isnan(rows(out, 2)).all()
    for s, page in ((0, 1), (3, 0)):  # the valid segments are unaffected
        assert torch.equal(rows(out, s), t_gt.gather_trilerp_mvoxels(
            pages_t[page], rows(ids_h, s), rows(w_h, s)))


def test_per_seg_wrappers_take_plain_only_for_cpu_tensors():
    rng = np.random.default_rng(0)
    ids, w = _rit_set(rng, 8, 4, 729)
    meta = lambda a: torch.as_tensor(a).to("meta")
    pages = meta(np.zeros((2, 8, 729, 4), np.float32))
    scn = meta(np.zeros((1,), np.int32))
    with pytest.raises(ValueError, match="no kernel"):
        t_gt.gather_trilerp_mvoxels_per_seg(pages, scn, meta(ids), meta(w),
                                            num_seg=1)
    with pytest.raises(ValueError, match="no kernel"):
        t_sp.fused_gather_dual_per_seg(pages, scn, meta(ids), meta(w),
                                       meta(ids), meta(w), num_seg=1)
    for kern in (t_gt.KERNEL_PER_SEG, t_sp.KERNEL_PER_SEG):
        assert kern.launches == 0 and kern._lib is None


# ---------------------------------------------------------------------------
# ops / streaming pipeline: the scened gathers
# ---------------------------------------------------------------------------


def _points_and_segs(rng, n, num_seg, pile=0):
    pts = rng.uniform(-1.0, 1.0, size=(n, 3)).astype(np.float32)
    pts[:pile] = 0.01  # pile samples into one MVoxel: forces overflow
    # every fifth sample is padding (seg == num_seg, the dump segment)
    seg = np.where(np.arange(n) % 5 == 4, num_seg,
                   np.arange(n) % num_seg).astype(np.int32)
    return pts, seg


@pytest.mark.parametrize("case", ["fits", "overflow"])
@pytest.mark.parametrize("num_seg", [1, 2])
def test_gather_features_streaming_scened_matches_reference(num_seg, case):
    """The scened branch buckets by (segment, MVoxel) at every num_seg,
    num_seg = 1 included (the dump segment takes no capacity there, unlike
    the single-scene num_seg = 1 rule); the overflow fallback reads each
    sample's own scene's table."""
    rng = np.random.default_rng(30 + num_seg)
    cap = 8 if case == "overflow" else 512
    jc, tc = _cfgs(grid_res=16, capacity=cap)
    tables, pages = _pages(rng, jc)
    pts, seg = _points_and_segs(rng, 2000, num_seg,
                                pile=300 if case == "overflow" else 0)
    scn = np.asarray(SCENE_MAPS[num_seg], np.int32)
    want = j_ops.gather_features_streaming(
        jnp.asarray(tables), jnp.asarray(pts), jc,
        mv_table=jnp.asarray(pages), seg=jnp.asarray(seg), num_seg=num_seg,
        scene_of_seg=jnp.asarray(scn), interpret=True)
    got = t_ops.gather_features_streaming(
        torch.as_tensor(tables), torch.as_tensor(pts), tc,
        mv_table=torch.as_tensor(pages), seg=torch.as_tensor(seg),
        num_seg=num_seg, scene_of_seg=torch.as_tensor(scn))
    keep = seg < num_seg  # the dump segment's output is unspecified
    np.testing.assert_allclose(got.numpy()[keep], np.asarray(want)[keep],
                               **F32_TOL)
    # the RIT: combined (segment, MVoxel) buckets, equal to JAX's
    blocks = t_ops.rit_blocks(torch.as_tensor(pts), tc,
                              seg=torch.as_tensor(seg), num_seg=num_seg,
                              scened=True)
    mv = j_streaming.mvoxel_ids(jnp.asarray(pts), jc)
    num_mv = jc.num_mvoxels
    j_seg = jnp.asarray(seg)
    bucket = jnp.where(j_seg < num_seg, j_seg * num_mv + mv,
                       num_seg * num_mv)
    want_rit = j_streaming.build_rit(bucket, jc, num_slots=num_seg * num_mv)
    for name, w, g in zip(want_rit._fields, want_rit, blocks.rit):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert blocks.num_seg == num_seg
    dump = np.flatnonzero(seg == num_seg)
    assert not np.isin(dump, blocks.rit.samples.numpy()).any()
    assert not blocks.rit.overflow.numpy()[dump].any()
    if case == "overflow":
        assert blocks.rit.overflow.numpy().any()
    # at num_seg = 1 the single-scene rule differs: padding takes capacity
    if num_seg == 1:
        plain = t_ops.rit_blocks(torch.as_tensor(pts), tc,
                                 seg=torch.as_tensor(seg), num_seg=1)
        assert plain.rit.samples.shape[0] == num_mv
        assert np.isin(dump, plain.rit.samples.numpy()).any()


def test_gather_features_streaming_scened_needs_seg_and_mv_table():
    tc = t_streaming.StreamingCfg(grid_res=16)
    tables = torch.zeros((2, 16**3, 4))
    pts = torch.zeros((10, 3))
    scn = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="seg array"):
        t_ops.gather_features_streaming(tables, pts, tc, scene_of_seg=scn)
    with pytest.raises(ValueError, match="prebuilt stacked"):
        t_ops.gather_features_streaming(
            tables, pts, tc, seg=torch.zeros(10, dtype=torch.int64),
            scene_of_seg=scn)


@pytest.mark.parametrize("layout", ["identity", "bank_interleaved"])
def test_gather_features_tick_scenes_matches_reference(layout):
    rng = np.random.default_rng(40)
    jc, tc = _cfgs(grid_res=16, capacity=32, layout=layout)
    tables, pages = _pages(rng, jc)
    pts_h, seg_h = _points_and_segs(rng, 900, 3, pile=150)
    pts_r, seg_r = _points_and_segs(rng, 1400, 3, pile=300)
    scn = np.asarray(SCENE_MAPS[3], np.int32)
    want = j_sp.gather_features_tick_scenes(
        jnp.asarray(tables), jnp.asarray(pages), jnp.asarray(scn), jc,
        jnp.asarray(pts_h), jnp.asarray(seg_h), jnp.asarray(pts_r),
        jnp.asarray(seg_r), num_seg=3, interpret=True)
    got = t_sp.gather_features_tick_scenes(
        torch.as_tensor(tables), torch.as_tensor(pages), torch.as_tensor(scn),
        tc, torch.as_tensor(pts_h), torch.as_tensor(seg_h),
        torch.as_tensor(pts_r), torch.as_tensor(seg_r), num_seg=3)
    for g, w, seg in zip(got, want, (seg_h, seg_r)):
        keep = seg < 3
        np.testing.assert_allclose(g.numpy()[keep], np.asarray(w)[keep],
                                   **F32_TOL)
    # both RITs overflow somewhere, so the scened fallback ran
    for pts, seg, cap in ((pts_h, seg_h, 32), (pts_r, seg_r, 64)):
        b = t_sp._rit_blocks(torch.as_tensor(pts), torch.as_tensor(seg), 3,
                             t_streaming.StreamingCfg(grid_res=16,
                                                      capacity=cap,
                                                      layout=layout))
        assert b.overflow.any()


def test_tick_scenes_on_one_page_equals_single_scene_tick():
    """Every segment on the same page: the scened tick equals the
    single-scene tick on that page's tables, bit for bit."""
    rng = np.random.default_rng(41)
    jc, tc = _cfgs(grid_res=16, capacity=32)
    tables, pages = _pages(rng, jc)
    pts_h, seg_h = _points_and_segs(rng, 700, 2, pile=120)
    pts_r, seg_r = _points_and_segs(rng, 900, 2, pile=200)
    args = [torch.as_tensor(a) for a in (pts_h, seg_h, pts_r, seg_r)]
    scened = t_sp.gather_features_tick_scenes(
        torch.as_tensor(tables), torch.as_tensor(pages),
        torch.tensor([1, 1], dtype=torch.int32), tc, *args, num_seg=2)
    single = t_sp.gather_features_tick(
        torch.as_tensor(tables[1]), torch.as_tensor(pages[1]), tc, *args,
        num_seg=2)
    for a, b in zip(scened, single):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# SceneCache and the model's halo-table cache
# ---------------------------------------------------------------------------


def test_scene_cache_byte_budget_and_counters():
    c = SceneCache(budget_bytes=100)
    assert c.put("a", 1, nbytes=60) == []
    assert c.put("b", 2, nbytes=60) == [("a", 1)]  # over budget: LRU out
    assert c.get("a") is None and c.get("b") == 2
    assert c.counters()["evicted_bytes"] == 60
    assert c.resident_bytes == 60
    # pinned keys are never stolen, even over budget
    assert c.put("c", 3, nbytes=60, pinned=("b",)) == []
    assert c.resident_bytes == 120  # budget yields to pins
    assert "b" in c and "c" in c
    assert c.peek("b") == 2 and c.hits == 1 and c.misses == 1
    assert c.counters()["hit_rate"] == 0.5 and c.counters()["entries"] == 2


def test_scene_cache_get_or_build_builds_once():
    c = SceneCache(max_entries=2)
    calls = []

    def build(k):
        def _b():
            calls.append(k)
            return k.upper(), 1
        return _b

    assert c.get_or_build("x", build("x")) == "X"
    assert c.get_or_build("x", build("x")) == "X"
    assert calls == ["x"]
    assert c.hits == 1 and c.misses == 1
    c.get_or_build("y", build("y"))
    c.get_or_build("z", build("z"))  # evicts x (LRU, max_entries=2)
    assert len(c) == 2 and "x" not in c


def test_params_token_is_identity():
    a, b = torch.zeros(3), torch.zeros(3)
    assert ParamsToken(a) == ParamsToken(a) and ParamsToken(a) != ParamsToken(b)
    assert len({ParamsToken(a), ParamsToken(a), ParamsToken(b)}) == 2


def test_prepare_streaming_caches_and_passes_stacked_pages_through():
    model, _ = t_models.make_model("dvgo", grid_res=16, channels=4,
                                   decoder="direct", num_samples=8,
                                   backend="streaming")
    pa = model.init_baked(t_scenes.make_scene("chair"), device="cpu")
    pb = model.init_baked(t_scenes.make_scene("drums"), device="cpu")
    # alternating scenes: each halo table is built once
    first = [model.prepare_streaming(p)["mv_table"] for p in (pa, pb)]
    again = [model.prepare_streaming(p)["mv_table"] for p in (pa, pb, pa)]
    assert again[0] is first[0] and again[1] is first[1]
    assert again[2] is first[0]
    assert model._mv_table_cache.misses == 2
    # a stacked page set [K, num_mv, P, C] passes through untouched
    stacked = {"table": torch.stack([pa["table"], pb["table"]]),
               "mv_table": torch.stack(first), "decoder": {}}
    assert model.prepare_streaming(stacked) is stacked
    with pytest.raises(ValueError, match="segment axis"):
        model.query_features(dict(stacked, scene_of_seg=torch.zeros(
            1, dtype=torch.int32)), torch.zeros((4, 3)))
    assert "chair" in t_scenes.SCENE_NAMES and len(t_scenes.SCENE_NAMES) == 8
