"""The port's kernels B1 (Gathering Unit) and B2 (fused radiance MLP): their
plain PyTorch versions against the JAX package's Pallas kernels (run in
interpret mode on the CPU), on the same numpy inputs; and the wrappers'
device rule (CPU tensors -> plain version, CUDA -> kernel, else raise)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import streaming as j_streaming
from repro.kernels import fused_nerf_mlp as j_mlp
from repro.kernels import gather_trilerp as j_gt
from repro_torch.kernels import fused_nerf_mlp as t_mlp
from repro_torch.kernels import gather_trilerp as t_gt

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
    rows = num_seg * num_mv
    ids = rng.integers(0, p, size=(rows, cap, 8)).astype(np.int32)
    w = rng.uniform(0.0, 1.0, size=(rows, cap, 8)).astype(np.float32)
    pad = rng.uniform(size=(rows, cap)) < 0.3  # RIT pad rows: id 0, w 0
    ids[pad] = 0
    w[pad] = 0.0
    return mv_table, ids, w


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
