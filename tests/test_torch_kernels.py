"""The port's kernels B1 (Gathering Unit) and B2 (fused radiance MLP): their
plain PyTorch versions against the JAX package's Pallas kernels (run in
interpret mode on the CPU), on the same numpy inputs; and the wrappers'
device rule (CPU tensors -> plain version, CUDA -> kernel, else raise).
Also B2's tensor-core arithmetic (the 3xTF32 split and the folded heads,
emulated in plain PyTorch) against the reference; B4's and B5's plain
versions under the segment->page maps the card is checked with; and B1's,
B3's and B5's launch plans, the shared-memory rules of B1, B3, B4 and B5,
and 16-byte realignment."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import streaming as j_streaming
from repro.kernels import fused_nerf_mlp as j_mlp
from repro.kernels import gather_trilerp as j_gt
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.kernels import streaming_pipeline as j_sp
from repro_torch.kernels import fused_nerf_mlp as t_mlp
from repro_torch.kernels import gather_trilerp as t_gt
from repro_torch.kernels import streaming_pipeline as t_sp
from repro_torch.nerf import mlp as t_nerf_mlp

# the reference's own kernel tolerances (tests/test_kernels.py)
F32_TOL = dict(atol=2e-5, rtol=1e-5)
BF16_TOL = dict(atol=3e-2, rtol=3e-2)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _gather_inputs(rng, layout, num_seg, c, cap=64, res=24):
    cfg = j_streaming.StreamingCfg(grid_res=res, capacity=cap, layout=layout)
    table = rng.standard_normal((res**3, c)).astype(np.float32)
    mv_table = np.array(j_streaming.build_mvoxel_table(jnp.asarray(table),
                                                         cfg))
    num_mv, p, _ = mv_table.shape
    return (mv_table,) + _rit_rows(rng, num_seg * num_mv, cap, p)


def _rit_rows(rng, rows, cap, p):
    ids = rng.integers(0, p, size=(rows, cap, 8)).astype(np.int32)
    w = rng.uniform(0.0, 1.0, size=(rows, cap, 8)).astype(np.float32)
    pad = rng.uniform(size=(rows, cap)) < 0.3  # RIT pad rows: id 0, w 0
    ids[pad] = 0
    w[pad] = 0.0
    return ids, w


@pytest.mark.parametrize("num_seg", [1, 3])
@pytest.mark.parametrize("layout", ["identity", "bank_interleaved"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_trilerp_plain_matches_pallas(dtype, layout, num_seg):
    rng = np.random.default_rng(11 + num_seg)
    mv_table, ids, w = _gather_inputs(rng, layout, num_seg, c=8)
    j_tab, t_tab = jnp.asarray(mv_table), torch.as_tensor(mv_table)
    if dtype == "bfloat16":
        j_tab, t_tab = j_tab.astype(jnp.bfloat16), t_tab.to(torch.bfloat16)
    want = j_gt.gather_trilerp_mvoxels_segmented(
        j_tab, jnp.asarray(ids), jnp.asarray(w), num_seg=num_seg,
        interpret=True)
    got = t_gt.gather_trilerp_mvoxels_segmented(
        t_tab, torch.as_tensor(ids), torch.as_tensor(w), num_seg=num_seg)
    assert got.dtype == t_tab.dtype and tuple(got.shape) == want.shape
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, dtype=np.float32), **tol)


def _mlp_inputs(rng, n, cin, hidden):
    feats = rng.standard_normal((n, cin)).astype(np.float32)
    dirs = rng.standard_normal((n, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    x, y, z = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
    enc = np.concatenate([dirs, x * y, y * z, x * z, x * x, y * y, z * z],
                         -1).astype(np.float32)
    shapes = dict(w1=(cin, hidden), b1=(hidden,), w2=(hidden, hidden),
                  b2=(hidden,), w_sigma=(hidden, 1), w_rgb=(hidden + 9, 3),
                  b_rgb=(3,))
    weights = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
               for k, s in shapes.items()}
    return feats, enc, weights


# the shape cases of tests/test_kernels.py::test_fused_mlp_shapes
@pytest.mark.parametrize("n,cin,hidden,block", [
    (1000, 8, 64, 256),
    (555, 16, 32, 128),
    (64, 4, 128, 64),
])
def test_fused_nerf_mlp_plain_matches_pallas(n, cin, hidden, block):
    rng = np.random.default_rng(n)
    feats, enc, wt = _mlp_inputs(rng, n, cin, hidden)
    pad = (-n) % block
    j_args = [jnp.pad(jnp.asarray(feats), ((0, pad), (0, 0))),
              jnp.pad(jnp.asarray(enc), ((0, pad), (0, 0)))]
    j_args += [jnp.asarray(wt[k])[None] if wt[k].ndim == 1
               else jnp.asarray(wt[k]) for k in wt]
    want = np.asarray(j_mlp.fused_nerf_mlp(*j_args, block=block,
                                           interpret=True))[:n]
    got = t_mlp.fused_nerf_mlp(torch.as_tensor(feats), torch.as_tensor(enc),
                               *(torch.as_tensor(wt[k]) for k in wt))
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_wrappers_take_plain_only_for_cpu_tensors():
    """A tensor on any device but the CPU goes to the kernel or raises;
    nothing falls back to the plain version."""
    rng = np.random.default_rng(0)
    mv_table, ids, w = _gather_inputs(rng, "identity", 1, c=4)
    meta = lambda a: torch.as_tensor(a).to("meta")
    with pytest.raises(ValueError, match="no kernel"):
        t_gt.gather_trilerp_mvoxels_segmented(meta(mv_table), meta(ids),
                                              meta(w), num_seg=1)
    feats, enc, wt = _mlp_inputs(rng, 16, 8, 64)
    with pytest.raises(ValueError, match="no kernel"):
        t_mlp.fused_nerf_mlp(meta(feats), meta(enc),
                             *(meta(wt[k]) for k in wt))
    assert t_gt.KERNEL.launches == 0 and t_mlp.KERNEL.launches == 0


# ---------------------------------------------------------------------------
# B2's tensor-core arithmetic: the 3xTF32 split, emulated in plain PyTorch
# (the CUDA kernel runs only on the card; chip_smoke.py holds it there)
# ---------------------------------------------------------------------------


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 (10 mantissa bits), round to nearest, ties away from
    zero, on the bit pattern: ``cvt.rna.tf32.f32``."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b as the kernel's mma3 forms it: a = a_hi + a_lo and b = b_hi +
    b_lo, each part TF32; three products (lo.lo dropped), fp32 sums."""
    a_hi, b_hi = _tf32_rna(a), _tf32_rna(b)
    a_lo, b_lo = _tf32_rna(a - a_hi), _tf32_rna(b - b_hi)
    acc = a_lo @ b_hi
    acc = acc + a_hi @ b_lo
    return acc + a_hi @ b_hi


def _mm_1xtf32(a, b):
    """One TF32 pass: the operands rounded to TF32 once."""
    return _tf32_rna(a) @ _tf32_rna(b)


def _mlp_emulated(feats, enc, w1, b1, w2, b2, w_sigma, w_rgb, b_rgb, mm):
    """B2's function with every product through ``mm`` and the heads as
    one product with the folded weight, as the kernel computes it."""
    h = torch.relu(mm(feats, w1) + b1)
    h = torch.relu(mm(h, w2) + b2)
    heads = t_mlp.fold_heads(w_sigma, w_rgb)
    pad = heads.shape[0] - h.shape[1] - enc.shape[1]
    x = torch.cat([h, torch.nn.functional.pad(enc, (0, pad))], dim=-1)
    out = mm(x, heads)
    return torch.cat([t_nerf_mlp.softplus(out[:, :1]),
                      torch.sigmoid(out[:, 1:4] + b_rgb)], dim=-1)


def _ref_init_inputs(n, cin, hidden, seed=0):
    """Weights at the reference initializer's scales (repro.nerf.mlp
    decoder_init: N(0, 1) / sqrt(fan_in), zero biases), drawn from numpy
    seed ``seed`` in the order chip_smoke.py's arm B draws them; then
    features N(0, 1) and the direction code of random unit directions."""
    rng = np.random.default_rng(seed)
    normal = lambda rows, cols: (rng.standard_normal((rows, cols))
                                 / np.sqrt(rows)).astype(np.float32)
    zeros = lambda k: np.zeros(k, np.float32)
    wt = {"w1": normal(cin, hidden), "b1": zeros(hidden),
          "w2": normal(hidden, hidden), "b2": zeros(hidden),
          "w_sigma": normal(hidden, 1), "w_rgb": normal(hidden + 9, 3),
          "b_rgb": zeros(3)}
    feats = rng.standard_normal((n, cin)).astype(np.float32)
    dirs = rng.standard_normal((n, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    x, y, z = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
    enc = np.concatenate([dirs, x * y, y * z, x * z, x * x, y * y, z * z],
                         -1).astype(np.float32)
    return feats, enc, wt


def _jax_mlp(feats, enc, wt, block):
    """The reference: ops.nerf_mlp through the Pallas kernel in interpret
    mode (as tests/test_kernels.py runs it), and kernels.ref.nerf_mlp_ref."""
    params = {k: jnp.asarray(v) for k, v in wt.items()}
    sig, rgb = j_ops.nerf_mlp(jnp.asarray(feats), jnp.asarray(enc), params,
                              block=block, interpret=True)
    kernel = np.concatenate([np.asarray(sig)[:, None], np.asarray(rgb)], -1)
    ref = np.asarray(j_ref.nerf_mlp_ref(jnp.asarray(feats), jnp.asarray(enc),
                                        *(params[k] for k in wt)))
    return kernel, ref


# the reference's three shapes (tests/test_kernels.py::test_fused_mlp_shapes)
# and arm B's width at one pooled-fill chunk (64 rays x 64 samples)
MLP_SHAPES = [(1000, 8, 64, 256), (555, 16, 32, 128), (64, 4, 128, 64),
              (4096, 8, 64, 256)]


@pytest.mark.parametrize("n,cin,hidden,block", MLP_SHAPES)
def test_mlp_3xtf32_emulation_matches_reference(n, cin, hidden, block):
    feats, enc, wt = _ref_init_inputs(n, cin, hidden)
    kernel, ref = _jax_mlp(feats, enc, wt, block)
    got = _mlp_emulated(torch.as_tensor(feats), torch.as_tensor(enc),
                        *(torch.as_tensor(wt[k]) for k in wt),
                        mm=_mm_3xtf32).numpy()
    np.testing.assert_allclose(got, kernel, **F32_TOL)
    np.testing.assert_allclose(got, ref, **F32_TOL)


@pytest.mark.parametrize("n,cin,hidden,block", MLP_SHAPES)
def test_mlp_one_tf32_pass_fails_tolerance(n, cin, hidden, block):
    """The control: one TF32 pass (what the tensor cores give without the
    split) misses the reference's fp32 tolerance, so the test above can
    fail."""
    feats, enc, wt = _ref_init_inputs(n, cin, hidden)
    kernel, _ = _jax_mlp(feats, enc, wt, block)
    got = _mlp_emulated(torch.as_tensor(feats), torch.as_tensor(enc),
                        *(torch.as_tensor(wt[k]) for k in wt),
                        mm=_mm_1xtf32).numpy()
    assert not np.allclose(got, kernel, **F32_TOL)


def test_tf32_split_keeps_22_bits():
    """hi + lo carries a value to ~2^-22 relative where hi alone keeps
    ~2^-11; both parts are TF32 (their low 13 bits are zero)."""
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(4096)
                        .astype(np.float32))
    hi = _tf32_rna(x)
    lo = _tf32_rna(x - hi)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    rel = lambda y: float(((y - x).abs() / x.abs()).max())
    assert 2.0**-13 < rel(hi) <= 2.0**-11
    assert rel(hi + lo) <= 2.0**-21


@pytest.mark.parametrize("hidden", [32, 64, 128])
def test_fold_heads_gives_reference_sigma_and_rgb(hidden):
    """The folded heads weight [H + 16, 8] over [h, d] zero-padded: column
    0 softplus'd is the reference's sigma, columns 1-3 with b_rgb
    sigmoid'd its rgb; the padding rows and columns 4-7 are zero."""
    feats, enc, wt = _ref_init_inputs(300, 8, hidden, seed=1)
    wt["b1"] = np.full(hidden, 0.1, np.float32)  # the bias path too
    wt["b_rgb"] = np.asarray([0.1, -0.2, 0.3], np.float32)
    heads = t_mlp.fold_heads(torch.as_tensor(wt["w_sigma"]),
                             torch.as_tensor(wt["w_rgb"]))
    assert tuple(heads.shape) == (hidden + 16, 8)
    assert not heads[:, 4:].any() and not heads[hidden:, 0].any()
    assert not heads[hidden + 9:].any()
    got = _mlp_emulated(torch.as_tensor(feats), torch.as_tensor(enc),
                        *(torch.as_tensor(wt[k]) for k in wt),
                        mm=torch.matmul).numpy()
    params = {k: jnp.asarray(v) for k, v in wt.items()}
    want = np.asarray(j_ref.nerf_mlp_ref(jnp.asarray(feats),
                                         jnp.asarray(enc),
                                         *(params[k] for k in wt)))
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_mlp_staging_fits_shared_memory():
    """The wrapper's shared-memory rule follows the kernel's layout: the
    split fragments of W1 (K padded to 8), W2 and the folded heads, 512
    bytes per 8x8 tile, then b1, b2 and b_rgb; every reference width
    fits one H100 block."""
    assert t_mlp.smem_bytes(8, 64, 9) == (8 + 64 + 8 + 2) * 512 + 4 * 131
    assert t_mlp.smem_bytes(4, 64, 9) == t_mlp.smem_bytes(8, 64, 9)
    for cin in (4, 8, 16):
        for hidden in t_mlp.HIDDEN_WIDTHS:
            assert t_mlp.smem_bytes(cin, hidden, 9) <= t_mlp._SMEM_LIMIT
            assert t_mlp.mlp_plan(cin, hidden, 9) == (
                "tensor", hidden, 16, t_mlp.smem_bytes(cin, hidden, 9), 0)
    # the staging limit of fault C5: at H = 128 it fits up to C = 88
    assert t_mlp.smem_bytes(88, 128, 9) <= t_mlp._SMEM_LIMIT
    assert t_mlp.smem_bytes(89, 128, 9) > t_mlp._SMEM_LIMIT


# ---------------------------------------------------------------------------
# C5: B2 at every [C, H] the reference takes (padding and the run-time mode)
# ---------------------------------------------------------------------------


# (C, H, DD) -> (mode, width, tile, shared-memory bytes, scratch floats);
# the run-time mode stages 8,448 B of k chunks beside its hidden tile of
# (H padded to 16) x 68 floats
RT = 4 * (16 * 68 + 16 * 64)
MLP_PLANS = [
    ((8, 64, 9), ("tensor", 64, 16, (8 + 64 + 8 + 2) * 512 + 4 * 131, 0)),
    ((8, 48, 9), ("tensor", 64, 16, (8 + 64 + 8 + 2) * 512 + 4 * 131, 0)),
    ((8, 20, 9), ("tensor", 32, 16, (4 + 16 + 4 + 2) * 512 + 4 * 67, 0)),
    ((8, 96, 9), ("tensor", 128, 16,
                  (16 + 256 + 16 + 2) * 512 + 4 * 259, 0)),
    ((88, 128, 9), ("tensor", 128, 16,
                    (11 * 16 + 256 + 16 + 2) * 512 + 4 * 259, 0)),
    ((89, 128, 9), ("runtime", 128, 64, RT + 4 * 128 * 68, 0)),
    ((96, 128, 9), ("runtime", 128, 64, RT + 4 * 128 * 68, 0)),
    ((96, 100, 9), ("runtime", 100, 64, RT + 4 * 112 * 68, 0)),
    ((8, 160, 9), ("runtime", 160, 64, RT + 4 * 160 * 68, 0)),
    ((8, 600, 9), ("runtime", 600, 64, RT + 4 * 608 * 68, 0)),
    ((8, 816, 9), ("runtime", 816, 64, RT + 4 * 816 * 68, 0)),
    ((8, 817, 9), ("runtime", 817, 64, RT, 832 * 68)),  # tile in scratch
    ((8, 64, 17), ("runtime", 64, 64, RT + 4 * 64 * 68, 0)),  # code over 16
]


@pytest.mark.parametrize("shape,plan", MLP_PLANS,
                         ids=[f"C{c}-H{h}-DD{dd}" for (c, h, dd), _
                              in MLP_PLANS])
def test_mlp_plan_routes_every_width(shape, plan):
    """``mlp_plan``, the one routing rule: H up to 128 pads to the next
    template width where the staged weights fit one block; the rest runs
    the run-time-H mode, its hidden tile in shared memory within the
    limit, else in global scratch."""
    got = t_mlp.mlp_plan(*shape)
    assert tuple(got) == plan
    assert got.smem <= t_mlp._SMEM_LIMIT
    if got.mode == "tensor":
        assert got.width in t_mlp.HIDDEN_WIDTHS and got.width >= shape[1]
        assert got.smem == t_mlp.smem_bytes(shape[0], got.width, shape[2])


def _pallas_mlp(feats, enc, wt, block=128):
    n = feats.shape[0]
    pad = (-n) % block
    args = [jnp.pad(jnp.asarray(feats), ((0, pad), (0, 0))),
            jnp.pad(jnp.asarray(enc), ((0, pad), (0, 0)))]
    args += [jnp.asarray(wt[k])[None] if wt[k].ndim == 1
             else jnp.asarray(wt[k]) for k in wt]
    return np.asarray(j_mlp.fused_nerf_mlp(*args, block=block,
                                           interpret=True))[:n]


@pytest.mark.parametrize("hidden,width", [(48, 64), (96, 128), (20, 32)])
def test_padded_mlp_matches_pallas(hidden, width):
    """The padded weights (``pad_hidden``: zero units, zero rows of
    ``w_rgb`` between its H rows and the direction code) give the
    reference's output at the unpadded width, 2e-5 / 1e-5."""
    rng = np.random.default_rng(hidden)
    feats, enc, wt = _mlp_inputs(rng, 300, 8, hidden)
    wt["b1"] = rng.standard_normal(hidden).astype(np.float32) * 0.1
    wt["b2"] = rng.standard_normal(hidden).astype(np.float32) * 0.1
    wt["b_rgb"] = np.asarray([0.1, -0.2, 0.3], np.float32)
    tw = {k: torch.as_tensor(v) for k, v in wt.items()}
    names = ("w1", "b1", "w2", "b2", "w_sigma", "w_rgb")
    padded = t_mlp.pad_hidden(*(tw[k] for k in names), width)
    assert [tuple(t.shape) for t in padded] == [
        (8, width), (width,), (width, width), (width,), (width, 1),
        (width + 9, 3)]
    assert not padded[5][hidden:width].any()
    got = t_mlp.fused_nerf_mlp_plain(torch.as_tensor(feats),
                                     torch.as_tensor(enc), *padded,
                                     tw["b_rgb"])
    np.testing.assert_allclose(got.numpy(), _pallas_mlp(feats, enc, wt),
                               **F32_TOL)
    # padded once per parameter set: a second lookup is the same tensors
    weights = tuple(tw[k] for k in names)
    first = t_mlp.padded(weights, width)
    assert all(a is b for a, b in zip(first, t_mlp.padded(weights, width)))
    tw["w1"].add_(0.0)  # an in-place update re-pads
    assert t_mlp.padded(weights, width)[0] is not first[0]


def _mlp_runtime_emulated(feats, enc, w1, b1, w2, b2, w_sigma, w_rgb, b_rgb,
                          cols=64, lanes=16):
    """The run-time-H kernel's arithmetic in plain PyTorch, in its order:
    every hidden unit summed over k from zero, bias and relu after; lane t
    of a row group sums the heads over columns ``n0 + 4t + j`` of each
    ``cols``-wide block, the lanes' sums meet in a xor tree (8, 4, 2, 1);
    the direction code last."""
    n, h = feats.shape[0], w1.shape[1]
    hid = feats.new_zeros((n, h))
    for k in range(feats.shape[1]):
        hid = hid + feats[:, k:k + 1] * w1[k]
    hid = torch.relu(hid + b1)
    h2 = feats.new_zeros((n, h))
    for k in range(h):
        h2 = h2 + hid[:, k:k + 1] * w2[k]
    v = torch.relu(h2 + b2)
    parts = []
    for t in range(lanes):
        sig, rgb = feats.new_zeros(n), feats.new_zeros((n, 3))
        for n0 in range(0, h, cols):
            for j in range(4):
                col = n0 + 4 * t + j
                if col < h:
                    sig = sig + v[:, col] * w_sigma[col, 0]
                    rgb = rgb + v[:, col:col + 1] * w_rgb[col]
        parts.append((sig, rgb))
    for off in (8, 4, 2, 1):
        parts = [(parts[t][0] + parts[t ^ off][0],
                  parts[t][1] + parts[t ^ off][1]) for t in range(lanes)]
    sig, rgb = parts[0]
    for k in range(enc.shape[1]):
        rgb = rgb + enc[:, k:k + 1] * w_rgb[h + k]
    return torch.cat([t_nerf_mlp.softplus(sig)[:, None],
                      torch.sigmoid(rgb + b_rgb)], dim=-1)


@pytest.mark.parametrize("cin,hidden", [(8, 160), (96, 128), (4, 50)])
def test_mlp_runtime_arithmetic_matches_pallas(cin, hidden):
    """The run-time-H mode's order of operations (emulated) against the
    reference at shapes the templates cannot take, 2e-5 / 1e-5."""
    rng = np.random.default_rng(cin + hidden)
    feats, enc, wt = _mlp_inputs(rng, 200, cin, hidden)
    wt["b1"] = rng.standard_normal(hidden).astype(np.float32) * 0.1
    wt["b2"] = rng.standard_normal(hidden).astype(np.float32) * 0.1
    got = _mlp_runtime_emulated(torch.as_tensor(feats), torch.as_tensor(enc),
                                *(torch.as_tensor(wt[k]) for k in wt))
    np.testing.assert_allclose(got.numpy(), _pallas_mlp(feats, enc, wt),
                               **F32_TOL)


def test_mlp_hidden_48_streaming_render_matches_reference():
    """``make_model("dvgo", decoder="mlp", mlp_hidden=48)`` on the
    streaming backend (the model fault C5 made raise on the card),
    rendered through the facade against JAX: >= 40 dB, equal stats."""
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

    rng = np.random.default_rng(48)
    feats, enc, dec = _mlp_inputs(rng, 1, 8, 48)
    table = (0.3 * rng.standard_normal((16**3, 8))).astype(np.float32)
    mk = dict(grid_res=16, channels=8, decoder="mlp", mlp_hidden=48,
              num_samples=8, backend="streaming")
    kw = dict(scene="lego", res=24, window=3, grid_res=16, channels=8,
              decoder="mlp", num_samples=8, backend="streaming")
    j_model, _ = j_models.make_model("dvgo", **mk)
    t_model, _ = t_models.make_model("dvgo", **mk)
    j_ren = j_api.make_renderer(
        j_config.RenderConfig(**kw, pallas_interpret=True), model=j_model,
        params={"table": jnp.asarray(table),
                "decoder": {k: jnp.asarray(v) for k, v in dec.items()}})
    t_ren = t_api.make_renderer(
        t_config.RenderConfig(**kw), model=t_model,
        params=params_from_numpy({"table": table, "decoder": dec}, "cpu"),
        device="cpu")
    want = j_ren.render(j_config.RenderRequest(
        poses=tuple(j_pipeline.orbit_trajectory(4, step_deg=3.0))))
    got = t_ren.render(t_config.RenderRequest(
        poses=tuple(t_pipeline.orbit_trajectory(4, step_deg=3.0))))
    for g, w in zip(got.frames, want.frames):
        assert float(psnr(g, torch.as_tensor(np.array(w)))) >= 40.0
    assert got.stats.hole_fractions == want.stats.hole_fractions
    assert got.stats.reference_renders == want.stats.reference_renders


# ---------------------------------------------------------------------------
# B4 and B5 under the segment->page maps chip_smoke.py holds the kernels to
# ---------------------------------------------------------------------------


PER_SEG_MAPS = {"captured": [0, 1, 0, 2], "all_zero": [0, 0, 0, 0],
                "alternating": [0, 1] * 4, "one_segment": [2],
                "minus_one": [0, -1, 1, 2], "past_k": [1, 3, 1, 0]}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(PER_SEG_MAPS))
def test_per_seg_plain_under_chip_maps(name, dtype):
    """Plain B4 and B5 against their Pallas kernels (interpret mode, tables
    picked by the map) where every page is valid, bit for bit against
    plain B1 / B3 on each valid segment's page, and NaN exactly on the
    rows of a segment whose page is outside [0, K) (K = 3)."""
    scn = PER_SEG_MAPS[name]
    ns = len(scn)
    rng = np.random.default_rng(40 + ns)
    cfg = j_streaming.StreamingCfg(grid_res=16, capacity=32)
    tables = rng.standard_normal((3, 16**3, 4)).astype(np.float32)
    pages = np.stack([np.asarray(j_streaming.build_mvoxel_table(
        jnp.asarray(t), cfg)) for t in tables])
    num_mv, p = pages.shape[1:3]
    ids, w = _rit_rows(rng, ns * num_mv, 32, p)
    ids_r, w_r = _rit_rows(rng, ns * num_mv, 64, p)  # B5's reference set
    t_pages = torch.as_tensor(pages)
    j_pages = jnp.asarray(pages)
    if dtype == "bfloat16":
        t_pages, j_pages = t_pages.to(torch.bfloat16), \
            j_pages.astype(jnp.bfloat16)
    t_scn = torch.tensor(scn, dtype=torch.int32)
    sets = [torch.as_tensor(x) for x in (ids, w, ids_r, w_r)]
    got = t_gt.gather_trilerp_mvoxels_per_seg(t_pages, t_scn, *sets[:2],
                                              num_seg=ns)
    got5 = t_sp.fused_gather_dual_per_seg(t_pages, t_scn, *sets, num_seg=ns)
    rows = lambda x, s: x[s * num_mv:(s + 1) * num_mv]
    for s, page in enumerate(scn):
        if 0 <= page < 3:
            assert torch.equal(rows(got, s), t_gt.gather_trilerp_mvoxels(
                t_pages[page], *(rows(x, s) for x in sets[:2])))
            b3 = t_sp.fused_gather_dual(t_pages[page],
                                        *(rows(x, s) for x in sets),
                                        num_seg=1)
            assert all(torch.equal(rows(g, s), o) for g, o in zip(got5, b3))
        else:
            assert torch.isnan(rows(got, s)).all()
            assert all(torch.isnan(rows(g, s)).all() for g in got5)
    if all(0 <= page < 3 for page in scn):
        j_tables = j_pages[jnp.asarray(scn)]
        j_sets = [jnp.asarray(x) for x in (ids, w, ids_r, w_r)]
        want = j_gt.gather_trilerp_mvoxels_per_seg(
            j_tables, *j_sets[:2], num_seg=ns, interpret=True)
        want5 = j_sp.fused_gather_dual_per_seg(j_tables, *j_sets,
                                               num_seg=ns, interpret=True)
        tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
        for g, wt in zip((got,) + tuple(got5), (want,) + tuple(want5)):
            np.testing.assert_allclose(g.float().numpy(),
                                       np.asarray(wt, dtype=np.float32),
                                       **tol)


def test_per_seg_shared_memory_rule():
    """Two halo blocks in the pages' own dtype, each rounded up to 16
    bytes: 2 x 11,664 B at arm E's fp32 [729, 4], 2 x 5,840 B in bf16."""
    assert t_gt.per_seg_smem_bytes(729, 4, 4) == 2 * 11664
    assert t_gt.per_seg_smem_bytes(729, 4, 2) == 2 * 5840
    assert t_gt.per_seg_smem_bytes(729, 8, 4) <= t_gt._SMEM_LIMIT


# ---------------------------------------------------------------------------
# B1's and B5's launch plans: the grid each wrapper hands its kernel, from
# which the kernel derives its rows (CTA (x, m), thread t: set
# columns[x][0], row columns[x][1] + t of MVoxel m, every segment)
# ---------------------------------------------------------------------------


def _coverage(plan, caps, num_seg):
    """How many times the plan's grid computes each (set, segment, MVoxel,
    row): one count array [num_seg, num_mv, cap] per set."""
    num_mv = plan.grid[1]
    counts = [np.zeros((num_seg, num_mv, cap), np.int64) for cap in caps]
    assert len(plan.columns) == plan.grid[0]
    for kind, first in plan.columns:
        for t in range(plan.threads):
            row = first + t
            if row < caps[kind]:  # threads past the set's cap are idle
                counts[kind][:, :, row] += 1  # every MVoxel, every segment
    return counts


# (num_mv, cap, num_seg): arm A's, arm B's and arm E's staged fill shapes,
# then caps that are not multiples of 256 or of 32
GATHER_PLANS = [(216, 512, 1), (512, 512, 1), (216, 512, 4), (27, 64, 1),
                (27, 100, 3), (5, 300, 2), (3, 1, 1), (7, 257, 1)]


@pytest.mark.parametrize("num_mv,cap,num_seg", GATHER_PLANS)
def test_gather_grid_covers_each_row_once(num_mv, cap, num_seg):
    plan = t_gt.gather_grid(num_mv, cap)
    (counts,) = _coverage(plan, [cap], num_seg)
    assert (counts == 1).all()
    assert plan.threads == (256 if cap >= 256 else -(-cap // 32) * 32)
    assert [first for _, first in plan.columns] == [
        x * plan.threads for x in range(plan.grid[0])]


# (num_mv, cap_h, cap_r, num_seg): arm E's fused tick (and one segment),
# then caps that are not multiples of 256 or of 32, and an empty set
DUAL_PLANS = [(216, 512, 1024, 4), (216, 512, 1024, 1), (27, 100, 37, 3),
              (5, 300, 1000, 2), (3, 33, 257, 1), (4, 0, 64, 1),
              (4, 64, 0, 2)]


@pytest.mark.parametrize("num_mv,cap_h,cap_r,num_seg", DUAL_PLANS)
def test_dual_grid_covers_each_row_once(num_mv, cap_h, cap_r, num_seg):
    plan = t_sp.dual_grid(num_mv, cap_h, cap_r)
    counts = _coverage(plan, [cap_h, cap_r], num_seg)
    assert all((c == 1).all() for c in counts)
    assert plan.threads == t_gt.cta_rows(max(cap_h, cap_r))
    # hole columns first: the kernel takes column x < tiles_h as holes,
    # its first row (x - tiles_h * set) * threads
    kinds = [kind for kind, _ in plan.columns]
    tiles_h = kinds.count(0)
    assert kinds == [0] * tiles_h + [1] * (len(kinds) - tiles_h)
    for x, (kind, first) in enumerate(plan.columns):
        assert first == (x - tiles_h * kind) * plan.threads


def test_launch_plans_at_the_arms_shapes():
    """Arm A's B1 launch: 2 CTAs of 256 rows per MVoxel, 432 in all; arm
    B's: 1,024; arm E's B5 launch: 2 hole and 4 reference CTAs per
    MVoxel, 1,296 in all; a reference-shape cap of 64 takes CTAs of 64
    threads."""
    plan = t_gt.gather_grid(216, 512)
    assert plan == t_gt.LaunchPlan((2, 216), 256, ((0, 0), (0, 256)))
    assert t_gt.gather_grid(512, 512).grid == (2, 512)
    plan = t_sp.dual_grid(216, 512, 1024)
    assert plan.grid == (6, 216) and plan.threads == 256
    assert plan.columns == ((0, 0), (0, 256), (1, 0), (1, 256), (1, 512),
                            (1, 768))
    assert t_gt.gather_grid(27, 64) == t_gt.LaunchPlan((1, 27), 64,
                                                       ((0, 0),))


def test_gather_shared_memory_rule():
    """B1 stages one halo block in the table's own dtype: 11,664 B at arm
    A's fp32 [729, 4], half that in bf16, 23,328 B at arm B's [729, 8].
    The reference's edge-16, C = 12 block (4,913 halo rows: 235,824 B in
    fp32) exceeds one H100 block's 232,448 B, so the kernel reads it in
    place (0); its bf16 copy (117,912 B) is staged."""
    assert t_gt.gather_smem_bytes(729, 4, 4) == 11664
    assert t_gt.gather_smem_bytes(729, 4, 2) == 5832
    assert t_gt.gather_smem_bytes(729, 8, 4) == 23328
    halo = j_streaming.StreamingCfg(grid_res=48, mvoxel_edge=16,
                                    capacity=512).halo_rows
    assert halo == 4913
    assert t_gt.gather_smem_bytes(halo, 12, 4) == 0
    assert t_gt.gather_smem_bytes(halo, 12, 2) == 117912


def test_dual_per_seg_shared_memory_rule():
    """B5 stages two halo blocks in the pages' own dtype (B4's rule,
    ``per_seg_smem_bytes``): arm E's fp32 [729, 4] pair takes 23,328 B,
    its bf16 pair 11,680 B; two [4913, 12] blocks do not fit in either
    dtype, and the kernel reads them in place (``per_seg_staging`` is 0
    for them)."""
    assert t_sp.per_seg_smem_bytes is t_gt.per_seg_smem_bytes
    assert t_sp.per_seg_smem_bytes(729, 4, 4) == 23328
    assert t_sp.per_seg_smem_bytes(729, 4, 2) == 11680
    for elem in (4, 2):
        assert t_sp.per_seg_smem_bytes(4913, 12, elem) > t_sp._SMEM_LIMIT


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_aligned16_copies_only_misaligned_tensors(dtype):
    """The gather wrappers' realignment: a view 4 bytes past a 16-byte
    boundary becomes an aligned contiguous copy with the same values; a
    view 16 bytes past one is passed through; a transposed view is made
    contiguous."""
    base = torch.arange(96).to(dtype)
    assert base.data_ptr() % 16 == 0
    off = base[1:65].reshape(8, 8)  # storage offset 1 element: 4 bytes
    assert off.data_ptr() % 16 == 4
    got = t_gt.aligned16(off)
    assert got.data_ptr() % 16 == 0 and got.is_contiguous()
    assert torch.equal(got, off)
    on = base[4:68].reshape(8, 8)  # 16 bytes: already aligned
    assert t_gt.aligned16(on).data_ptr() == on.data_ptr()
    got = t_gt.aligned16(base[:64].reshape(8, 8).t())
    assert got.is_contiguous() and got.data_ptr() % 16 == 0
    assert torch.equal(got, base[:64].reshape(8, 8).t())


# ---------------------------------------------------------------------------
# the shared-memory rules and launch plans behind the C4 repair (B3, B4 and
# B5 take every block and channel count the reference takes) and B3's
# redesign
# ---------------------------------------------------------------------------


def test_per_seg_staging_rule():
    """B4's and B5's wrappers hand their kernels the two buffers' bytes
    where they fit in one H100 block's shared memory, else 0 (each page's
    block is read in place): 23,328 B at arm E's fp32 [729, 4] (its main
    path, unchanged); 0 for fp32 [729, 40] (2 x 116,640 B) and for the
    edge-16, C = 12 block in either dtype; the two bf16 [729, 36] buffers
    (2 x 52,496 B) are staged, with the run-time-C code above 32
    channels."""
    assert t_gt.per_seg_staging(729, 4, 4) == 23328
    assert t_gt.per_seg_staging(729, 40, 4) == 0
    assert t_gt.per_seg_staging(4913, 12, 4) == 0
    assert t_gt.per_seg_staging(4913, 12, 2) == 0
    assert t_gt.per_seg_staging(729, 36, 2) == \
        t_gt.per_seg_smem_bytes(729, 36, 2) == 2 * 52496
    assert t_sp.per_seg_staging is t_gt.per_seg_staging
    assert not hasattr(t_gt, "PER_SEG_MAX_C")


def test_b3_shared_memory_rule():
    """B3 stages one halo block in the table's own dtype (B1's rule,
    ``gather_smem_bytes``): fp32 [729, 80] (233,280 B) exceeds one H100
    block's shared memory and is read in place; its bf16 copy (116,640 B)
    is staged."""
    assert t_sp.gather_smem_bytes is t_gt.gather_smem_bytes
    assert t_sp.gather_smem_bytes(729, 80, 4) == 0
    assert t_sp.gather_smem_bytes(729, 80, 2) == 116640
    assert t_sp.gather_smem_bytes(729, 79, 4) == 729 * 79 * 4


@pytest.mark.parametrize("num_mv", [216, 512])
def test_b3_launch_plan_at_the_fused_arms_shapes(num_mv):
    """B3's grid at arm C's (216 MVoxels) and arm D's (512) fused tick,
    caps 512 / 1024: 2 hole and 4 reference CTAs of 256 threads per
    MVoxel, 1,296 and 3,072 CTAs in all."""
    plan = t_sp.dual_grid(num_mv, 512, 1024)
    assert plan.grid == (6, num_mv) and plan.threads == 256
    assert [kind for kind, _ in plan.columns] == [0, 0, 1, 1, 1, 1]
    assert plan.grid[0] * plan.grid[1] == {216: 1296, 512: 3072}[num_mv]
