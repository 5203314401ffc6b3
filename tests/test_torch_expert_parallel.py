"""MoE's expert-parallel branch (the twin of the reference's ``shard_map``,
``src/repro/models/moe.py:119-162``) and the mesh context, against the
JAX package on the same numpy inputs and weights.

moonshot-v1-16b-a3b's ``REDUCED`` config in float32 (8 experts, top-2, the
shared expert) on a (2, 2) (data, model) mesh: four gloo ranks in one
launch (``tests/torch_ranks.py``), the params and ``x`` laid out as
DTensors by the spec trees; the reference's ``moe`` under ``jax.set_mesh``
on 4 forced host devices in one subprocess. Cases, each in both dispatch
modes: ``ep`` (B 4, S 16: the branch is taken), and three where the
reference's condition fails and the fallback runs: ``decode`` (S 1),
``ragged_batch`` (B 3, not a multiple of the 2 data ranks) and
``odd_experts`` (7 experts, not a multiple of the 2 model ranks).

Tolerances: outputs and ``aux`` at ``F32_TOL`` against JAX's under its
mesh and against the port's one-device dispatch; the grads of ``sum(out *
r) + aux`` (x and every leaf) at ``F32_TOL`` plus 1e-5 x the leaf's
largest magnitude (``test_torch_lm_train.py``'s rule). JAX's own
expert-parallel grads equal its one-device grads on these inputs (held
here too), so the reference has no gradient caveat to follow.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from repro.configs import registry as j_registry
from repro.models import moe as j_moe
from repro_torch.configs import registry as t_registry
from repro_torch.models import common, moe

ARCH = "moonshot-v1-16b-a3b"
F32_TOL = dict(atol=2e-5, rtol=1e-5)
MODES = ("einsum", "streaming")
# name -> (batch, seq, experts); only "ep" meets the reference's condition
CASES = {"ep": (4, 16, 8), "decode": (4, 1, 8), "ragged_batch": (3, 16, 8),
         "odd_experts": (4, 16, 7)}
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(experts, mode):
    return (t_registry.get_reduced(ARCH).with_(moe_num_experts=experts,
                                               moe_dispatch=mode),
            j_registry.get_reduced(ARCH).with_(moe_num_experts=experts,
                                               moe_dispatch=mode))


@pytest.fixture(scope="module")
def inputs():
    """name-mode -> (params, x, r, mode): the reference's ``moe_init`` (seed
    0) and seeded normal ``x`` and ``r``, numpy float32."""
    out = {}
    for name, (b, s, e) in CASES.items():
        _, j_cfg = _cfg(e, "einsum")
        params = jax.tree.map(lambda a: np.asarray(a, np.float32),
                              j_moe.moe_init(jax.random.key(0), j_cfg,
                                             jnp.float32))
        rng = np.random.default_rng(len(name))
        x = rng.standard_normal((b, s, j_cfg.d_model)).astype(np.float32)
        r = rng.standard_normal((b, s, j_cfg.d_model)).astype(np.float32)
        for mode in MODES:
            out[f"{name}-{mode}"] = (params, x, r, mode)
    return out


_JAX = """
import os, sys, pickle
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.configs import registry
from repro.models import moe
import repro.models.moe as moe_mod

cases = pickle.load(open(sys.argv[1], "rb"))
mesh = jax.sharding.Mesh(np.asarray(jax.devices()).reshape(2, 2),
                         ("data", "model"))
bodies, real = [0], moe_mod.shard_map_compat
def counted(*a, **k):
    bodies[0] += 1
    return real(*a, **k)
moe_mod.shard_map_compat = counted
out = {}
for key, (params, x, r, mode) in cases.items():
    cfg = registry.get_reduced("%s").with_(
        moe_dispatch=mode, moe_num_experts=params["wg"].shape[0])
    def f(p, x):
        y, aux = moe.moe(p, x, cfg)
        return jnp.sum(y * r) + aux, (y, aux)
    def run():
        (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(params, x)
        leaves = [gp["router"], gp["wg"], gp["wu"], gp["wd"],
                  *(gp["shared"][k] for k in sorted(gp["shared"]))]
        return {"out": np.asarray(y), "aux": float(aux),
                "grads": [np.asarray(gx)] + [np.asarray(g) for g in leaves]}
    one = run()
    bodies[0] = 0
    with jax.set_mesh(mesh):
        res = run()
    res["bodies"] = bodies[0]
    res["one_device"] = one
    out[key] = res
pickle.dump(out, open(sys.argv[2], "wb"))
""" % ARCH


@pytest.fixture(scope="module")
def jax_results(inputs, tmp_path_factory):
    """The reference's ``moe`` and its grads under ``jax.set_mesh`` on a
    (2, 2) mesh of forced host devices, and on one device."""
    import pickle

    d = tmp_path_factory.mktemp("jax_ep")
    src, dst = d / "in.pkl", d / "out.pkl"
    src.write_bytes(pickle.dumps(inputs))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_JAX),
                        str(src), str(dst)], capture_output=True, text=True,
                       env=env, cwd=str(ROOT), timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return pickle.loads(dst.read_bytes())


@pytest.fixture(scope="module")
def rank_results(inputs, tmp_path_factory):
    """Every rank's results of :func:`torch_ranks.moe_mesh_rank`."""
    return torch_ranks.launch(torch_ranks.moe_mesh_rank, 4,
                              tmp_path_factory.mktemp("ranks"),
                              t_registry.get_reduced(ARCH), inputs)


def _one_device(params, x, r, mode):
    e = params["wg"].shape[0]
    t_cfg, _ = _cfg(e, mode)
    p = {k: ({kk: torch.from_numpy(vv).requires_grad_(True)
              for kk, vv in v.items()} if isinstance(v, dict)
             else torch.from_numpy(v).requires_grad_(True))
         for k, v in params.items()}
    leaves = [p["router"], p["wg"], p["wu"], p["wd"],
              *(p["shared"][k] for k in sorted(p["shared"]))]
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.moe(p, xt, t_cfg)
    grads = torch.autograd.grad((y * torch.from_numpy(r)).sum() + aux,
                                [xt, *leaves])
    return {"out": y.detach().numpy(), "aux": float(aux),
            "grads": [g.numpy() for g in grads]}


KEYS = [f"{name}-{mode}" for name in CASES for mode in MODES]


@pytest.mark.parametrize("key", KEYS)
def test_outputs_match_jax_under_its_mesh_and_one_device(
        key, inputs, jax_results, rank_results):
    """out and aux on every rank within F32_TOL of JAX's ``moe`` under
    ``jax.set_mesh`` and of the port's one-device dispatch; the routed
    experts' sum (before the shared expert) a DTensor split over ``data``
    (where the batch divides) and replicated over ``model``."""
    one = _one_device(*inputs[key])
    for rank in rank_results:
        res = rank[key]
        np.testing.assert_allclose(res["out"], jax_results[key]["out"],
                                   **F32_TOL)
        np.testing.assert_allclose(res["out"], one["out"], **F32_TOL)
        np.testing.assert_allclose(res["aux"], jax_results[key]["aux"],
                                   **F32_TOL)
        np.testing.assert_allclose(res["aux"], one["aux"], **F32_TOL)
    b = CASES[key.split("-")[0]][0]
    assert rank_results[0][key]["out_placements"] == (
        "Shard(dim=0)" if b % 2 == 0 else "Replicate()", "Replicate()")


@pytest.mark.parametrize("key", KEYS)
def test_grads_match_jax_under_its_mesh(key, jax_results, rank_results):
    """The grads of ``sum(out * r) + aux`` with respect to x and every
    leaf, gathered whole, against JAX's grads of the same branch under its
    mesh; JAX's own mesh grads against its one-device grads (no reference
    caveat: they agree)."""
    ref = jax_results[key]
    for want, one, got in zip(ref["grads"], ref["one_device"]["grads"],
                              rank_results[0][key]["grads"]):
        tol = dict(atol=F32_TOL["atol"] + 1e-5 * np.abs(want).max(),
                   rtol=F32_TOL["rtol"])
        np.testing.assert_allclose(got, want, **tol)
        np.testing.assert_allclose(one, want, **tol)


@pytest.mark.parametrize("key", KEYS)
def test_branch_taken_exactly_where_the_reference_condition_holds(
        key, jax_results, rank_results):
    """The branch's body runs once on each rank (a spy) for the ``ep``
    cases and never for the others, as the reference's ``shard_map`` is
    entered exactly there."""
    taken = key.startswith("ep-")
    assert jax_results[key]["bodies"] == int(taken)
    for rank in rank_results:
        assert rank[key]["bodies"] == int(taken)


@pytest.mark.parametrize("key", KEYS)
def test_plain_input_under_a_mesh_forward(key, inputs, rank_results):
    """A plain x (the same tensor on every rank) against the experts laid
    out as DTensors over ``model``, forward only: the branch's psum or the
    fallback's gather of each rank's experts gives the one-device
    output."""
    one = _one_device(*inputs[key])
    for rank in rank_results:
        np.testing.assert_allclose(rank[key]["plain_out"], one["out"],
                                   **F32_TOL)
        np.testing.assert_allclose(rank[key]["plain_aux"], one["aux"],
                                   **F32_TOL)


def test_shard_under_the_mesh_context(rank_results):
    """``shard`` redistributes a DTensor to the guarded spec's placements
    under a mesh, passes a plain tensor through, and is the identity
    without a mesh."""
    for rank in rank_results:
        assert rank["shard"] == {"dtensor": ("Shard(dim=0)", "Shard(dim=1)"),
                                 "plain_passes": True, "no_mesh": True}


class _Sizes:
    def __init__(self, **sizes):
        self.axis_names, self.axis_sizes = tuple(sizes), tuple(sizes.values())


@pytest.mark.parametrize("sizes", [dict(data=2, model=2),
                                   dict(pod=2, data=2, model=4),
                                   dict(data=4, model=1),
                                   dict(data=1, model=8)])
def test_condition_is_the_references(sizes):
    """``_ep_taken`` against the reference's ``tp > 1 and e % tp == 0 and
    b % dp == 0 and s > 1`` on a grid of experts, batches and lengths."""
    tp = sizes.get("model", 1)
    dp = sizes.get("pod", 1) * sizes.get("data", 1)
    mesh = _Sizes(**sizes)
    for e in (6, 7, 8, 16):
        cfg = t_registry.get_reduced(ARCH).with_(moe_num_experts=e)
        for b in (1, 2, 3, 4, 8):
            for s in (1, 2, 16):
                want = tp > 1 and e % tp == 0 and b % dp == 0 and s > 1
                assert moe._ep_taken(mesh, cfg, b, s) == want


def test_mesh_context_nests_and_restores():
    """``use_mesh`` sets the mesh ``current_mesh`` returns, nests, and
    leaves none behind, also when its body raises."""
    a, b = _Sizes(data=2, model=2), _Sizes(data=1, model=4)
    assert common.current_mesh() is None
    with common.use_mesh(a):
        assert common.current_mesh() is a
        with pytest.raises(RuntimeError):
            with common.use_mesh(b):
                assert common.current_mesh() is b
                raise RuntimeError("inner")
        assert common.current_mesh() is a
    assert common.current_mesh() is None
