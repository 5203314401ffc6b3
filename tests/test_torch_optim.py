"""The port's optimiser and schedule (``repro_torch.optim``) against the
JAX package's on the same numpy inputs.

Tolerances: the schedule is a few float32 operations and ``cos``, held at
rtol 1e-6 (a float32 ulp is 6e-8; the two libraries' ``cos`` may round
apart). One AdamW step on identical grads repeats the reference's order
of operations in float32; ``b ** t`` and ``sqrt`` may round one ulp
apart, so new params and moments are held at rtol 1e-6 / atol 1e-9 after
each of three chained steps.
"""
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as j_adamw
from repro.optim import schedules as j_schedules
from repro_torch import optim as t_optim
from repro_torch.optim import adamw as t_adamw
from repro_torch.optim import schedules as t_schedules

STEP_TOL = dict(rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("warmup, total, min_ratio",
                         [(20, 400, 0.1), (20, 300, 0.1), (0, 50, 0.1),
                          (10, 5, 0.0), (5, 60, 0.5)])
def test_cosine_warmup_matches_reference(warmup, total, min_ratio):
    for step in range(0, total + 8):
        want = j_schedules.cosine_warmup(step, 5e-3, warmup, total,
                                         min_ratio)
        got = t_schedules.cosine_warmup(step, 5e-3, warmup, total,
                                        min_ratio)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=0, err_msg=f"step {step}")


def _tree(seed, scale=1.0):
    """A NeRF-shaped tree: level tables in a list, a nested decoder, one
    float16 leaf (moments stay float32)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (scale * rng.standard_normal(s)).astype(np.float32)
    return {"tables": [f(64, 2), f(32, 2), f(16, 2)],
            "decoder": {"w1": f(6, 8), "b1": f(8), "w_rgb": f(17, 3)},
            "basis": f(6, 4).astype(np.float16)}


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _assert_tree_close(got, want, what, **tol):
    g_leaves, _ = t_adamw.tree_flatten(got)
    w_leaves = jax.tree.leaves(want)
    assert len(g_leaves) == len(w_leaves)
    for i, (g, w) in enumerate(zip(g_leaves, w_leaves)):
        w = np.asarray(w)
        assert g.dtype == torch.from_numpy(np.zeros(1, w.dtype)).dtype, what
        np.testing.assert_allclose(g.float().numpy(), w.astype(np.float32),
                                   err_msg=f"{what} leaf {i}", **tol)


def test_tree_flatten_follows_the_reference_leaf_order():
    tree = _tree(0)
    leaves, unflatten = t_adamw.tree_flatten(_to_torch(tree))
    for g, w in zip(leaves, jax.tree.leaves(tree)):
        np.testing.assert_array_equal(g.numpy(), w)
    rebuilt = unflatten([2 * x for x in leaves])
    np.testing.assert_array_equal(rebuilt["tables"][1].numpy(),
                                  2 * tree["tables"][1])
    assert isinstance(rebuilt["tables"], list)


def test_global_norm_and_init_match_reference():
    tree = _tree(1)
    np.testing.assert_allclose(
        t_adamw.global_norm(_to_torch(tree)).numpy(),
        np.asarray(j_adamw.global_norm(_to_jax(tree))), rtol=1e-6)
    state = t_optim.adamw_init(_to_torch(tree))
    for leaf in t_adamw.tree_flatten(state)[0]:
        assert leaf.dtype == torch.float32 and not leaf.any()
    want = j_adamw.adamw_init(_to_jax(tree))
    _assert_tree_close(state, want, "init", rtol=0, atol=0)


@pytest.mark.parametrize("cfg_kw", [
    dict(grad_clip_norm=0.0),  # fit_field's
    dict(),  # train_images's: clip 1.0, which these grads exceed
    dict(grad_clip_norm=50.0),  # above the norm: scale 1
    dict(weight_decay=0.1, grad_clip_norm=1.0),
    dict(b1=0.8, b2=0.99, eps=1e-6, weight_decay=0.01, grad_clip_norm=0.0),
], ids=["no-clip", "clip", "clip-inactive", "decay-clip", "other-betas"])
def test_adamw_update_matches_reference(cfg_kw):
    j_cfg = j_adamw.AdamWConfig(**cfg_kw)
    t_cfg = t_adamw.AdamWConfig(**cfg_kw)
    params = _tree(2)
    j_p, t_p = _to_jax(params), _to_torch(params)
    j_s, t_s = j_adamw.adamw_init(j_p), t_adamw.adamw_init(t_p)
    for step in range(3):
        grads = _tree(10 + step, scale=0.5)
        lr = j_schedules.cosine_warmup(step, 5e-3, 2, 10)
        j_p, j_s = j_adamw.adamw_update(_to_jax(grads), j_p, j_s,
                                        jnp.asarray(step), j_cfg, lr)
        t_p, t_s = t_adamw.adamw_update(
            _to_torch(grads), t_p, t_s, step, t_cfg,
            t_schedules.cosine_warmup(step, 5e-3, 2, 10))
        _assert_tree_close(t_p, j_p, f"params after step {step}",
                           **STEP_TOL)
        _assert_tree_close(t_s["m"], j_s["m"], f"m after step {step}",
                           **STEP_TOL)
        _assert_tree_close(t_s["v"], j_s["v"], f"v after step {step}",
                           **STEP_TOL)


def test_adamw_update_is_functional():
    """New tensors every step; the params and state given are untouched
    (identity-keyed caches must never see an old tensor change)."""
    params = _to_torch(_tree(3))
    before = [p.clone() for p in t_adamw.tree_flatten(params)[0]]
    state = t_adamw.adamw_init(params)
    new_p, new_s = t_adamw.adamw_update(_to_torch(_tree(4)), params, state,
                                        0, t_adamw.AdamWConfig(), 1e-2)
    old_leaves = t_adamw.tree_flatten(params)[0]
    for old, new, kept in zip(old_leaves, t_adamw.tree_flatten(new_p)[0],
                              before):
        assert new is not old and new.data_ptr() != old.data_ptr()
        assert torch.equal(old, kept)
        assert not torch.equal(new, kept)
    assert not any(m.any() for m in t_adamw.tree_flatten(state["m"])[0])
    assert all(m.any() for m in t_adamw.tree_flatten(new_s["m"])[0])


def test_adamw_update_frees_its_tensors_without_the_cyclic_collector():
    """A step's params, moments and grads are freed as soon as they are
    dropped: no reference cycle holds them (at full width one step's
    tensors are ~0.8 GB, and a cycle per step kept ~12 GB alive on the
    card between collections)."""
    params = _to_torch(_tree(5))
    state = t_adamw.adamw_init(params)
    gc.collect()
    gc.disable()
    try:
        new_p, new_s = t_adamw.adamw_update(_to_torch(_tree(6)), params,
                                            state, 0, t_adamw.AdamWConfig(),
                                            1e-2)
        refs = [weakref.ref(t) for tree in (new_p, new_s)
                for t in t_adamw.tree_flatten(tree)[0]]
        del new_p, new_s
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
