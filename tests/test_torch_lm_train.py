"""The port's LM training path against the JAX package on the same numpy
inputs and weights: the blocked attention under autograd, the chunked
cross-entropy, ``loss_fn`` and its gradients, ``remat``, one train step,
and the in-place AdamW update against the functional one.

Tolerances: float32 losses at rtol 1e-5 and each grad leaf at rtol 1e-4
plus atol 1e-5 x the leaf's largest magnitude (the same float32 sums in
another order; measured ~2e-6 of the leaf's largest). The bfloat16 case
holds the loss at rtol 2e-3 and each grad leaf at 5e-2 x its largest
magnitude (measured 9e-5 and 1.9e-2: bfloat16 keeps 8 bits, and the two
libraries round the bfloat16 matmuls' outputs and the residual stream at
different points). ``remat``
and the in-place update are held bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.models import attention as j_attn
from repro.models import lm as j_lm
from repro.optim import AdamWConfig as JAdamWConfig
from repro_torch import convert
from repro_torch.configs import registry as t_registry
from repro_torch.models import attention as t_attn
from repro_torch.models import lm as t_lm
from repro_torch.optim import AdamWConfig, adamw as t_adamw
from repro_torch.optim.adamw import tree_flatten

ARCHS = ["minitron-4b", "qwen2.5-32b"]  # qwen2.5 has QKV biases
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-4, 1e-5
BF16_LOSS_RTOL, BF16_GRAD_ATOL_OF_MAX = 2e-3, 5e-2


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    return (t_registry.get_reduced(arch).with_(q_block=16, **kw),
            j_registry.get_reduced(arch).with_(q_block=16, **kw))


def _jax_params(cfg, seed=0):
    """The reference's init, QKV biases drawn non-zero where the config
    has them (so that their gradients are not trivially equal)."""
    params = jax.tree.map(np.asarray, j_lm.init_params(cfg,
                                                       jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    for layer in params["blocks"]:
        for name in ("bq", "bk", "bv"):
            if name in layer["mixer"]:
                b = layer["mixer"][name]
                layer["mixer"][name] = (0.5 * rng.standard_normal(
                    b.shape)).astype(b.dtype)
    return params


def _batch(cfg, b, s, seed, mask=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if mask:
        batch["loss_mask"] = (rng.uniform(size=(b, s)) < 0.7).astype(
            np.float32)
    return batch


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _grad_leaves(t_cfg, j_grads):
    """The reference's grads in the port's layout and leaf order."""
    return tree_flatten(convert.lm_params_from_numpy(
        t_cfg, jax.tree.map(np.asarray, j_grads), device="cpu"))[0]


def _assert_grads_close(got, want, rtol, atol_of_max):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.float().numpy(), w.float().numpy()
        np.testing.assert_allclose(
            g, w, rtol=rtol, atol=atol_of_max * float(np.abs(w).max()),
            err_msg=f"grad leaf {i} {w.shape}")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("s, q_block", [(32, 16), (40, 16), (32, 64)],
                         ids=["divides", "does-not-divide", "larger-than-S"])
@pytest.mark.parametrize("causal", [True, False])
def test_attn_train_matches_jax(arch, s, q_block, causal):
    t_cfg, j_cfg = _cfgs(arch)
    mixer = {k: v[0] for k, v in _jax_params(j_cfg)["blocks"][0]["mixer"]
             .items()}
    x = np.random.default_rng(1).standard_normal(
        (2, s, j_cfg.d_model)).astype(np.float32)
    want = j_attn.attn_train(jax.tree.map(jnp.asarray, mixer),
                             jnp.asarray(x), j_cfg, q_block=q_block,
                             causal=causal)
    got = t_attn.attn_train({k: torch.from_numpy(v.copy()) for k, v in
                             mixer.items()}, torch.from_numpy(x), t_cfg,
                            q_block=q_block, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-5)


def test_attn_train_q_block_comes_from_the_config():
    t_cfg, _ = _cfgs("minitron-4b")
    rng = np.random.default_rng(2)
    mixer = {k: torch.from_numpy(v[0].copy()) for k, v in _jax_params(
        j_registry.get_reduced("minitron-4b"))["blocks"][0]["mixer"].items()}
    x = torch.from_numpy(rng.standard_normal((1, 32, t_cfg.d_model))
                         .astype(np.float32))
    by_cfg = t_attn.attn_train(mixer, x, t_cfg.with_(q_block=8))
    by_arg = t_attn.attn_train(mixer, x, t_cfg, q_block=8)
    assert torch.equal(by_cfg, by_arg)


@pytest.mark.parametrize("mask", ["none", "random", "all-zero"])
@pytest.mark.parametrize("chunk", [8, 12], ids=["divides", "falls-back"])
def test_chunked_ce_matches_jax(mask, chunk):
    rng = np.random.default_rng(3)
    b, s, d, v = 2, 24, 16, 64
    h = rng.standard_normal((b, s, d)).astype(np.float32)
    head = rng.standard_normal((d, v)).astype(np.float32)
    targets = rng.integers(0, v, size=(b, s)).astype(np.int32)
    m = {"none": None,
         "random": (rng.uniform(size=(b, s)) < 0.5).astype(np.float32),
         "all-zero": np.zeros((b, s), np.float32)}[mask]
    want = j_lm.chunked_ce(jnp.asarray(h), jnp.asarray(targets),
                           jnp.asarray(head),
                           None if m is None else jnp.asarray(m), chunk)
    got = t_lm.chunked_ce(torch.from_numpy(h), torch.from_numpy(targets),
                          torch.from_numpy(head),
                          None if m is None else torch.from_numpy(m), chunk)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    if mask == "all-zero":
        assert float(got) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax_value_and_grad(arch):
    t_cfg, j_cfg = _cfgs(arch, loss_chunk=16)
    params = _jax_params(j_cfg, seed=4)
    batch = _batch(j_cfg, 2, 48, seed=5, mask=True)
    (j_loss, j_metrics), j_grads = jax.jit(
        jax.value_and_grad(j_lm.loss_fn, has_aux=True), static_argnums=2)(
        jax.tree.map(jnp.asarray, params), _jax_batch(batch), j_cfg)
    t_params = convert.lm_params_from_numpy(t_cfg, params, device="cpu")
    loss, metrics, grads = t_lm.loss_and_grads(t_params, _torch_batch(batch),
                                               t_cfg)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["ce"]), float(j_metrics["ce"]),
                               rtol=LOSS_RTOL)
    assert float(metrics["aux"]) == float(j_metrics["aux"]) == 0.0
    _assert_grads_close(tree_flatten(grads)[0], _grad_leaves(t_cfg, j_grads),
                        GRAD_RTOL, GRAD_ATOL_OF_MAX)
    # the params are read, never written, and need no grad
    assert all(not p.requires_grad for p in tree_flatten(t_params)[0])


def test_loss_and_grads_match_jax_in_bfloat16():
    t_cfg, j_cfg = _cfgs("minitron-4b", dtype="bfloat16", loss_chunk=16)
    params = _jax_params(j_cfg, seed=6)
    batch = _batch(j_cfg, 2, 32, seed=7)
    (j_loss, _), j_grads = jax.jit(
        jax.value_and_grad(j_lm.loss_fn, has_aux=True), static_argnums=2)(
        jax.tree.map(jnp.asarray, params), _jax_batch(batch), j_cfg)
    t_params = convert.lm_params_from_numpy(t_cfg, params, device="cpu")
    loss, _, grads = t_lm.loss_and_grads(t_params, _torch_batch(batch), t_cfg)
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(j_loss),
                               rtol=BF16_LOSS_RTOL)
    got = tree_flatten(grads)[0]
    for g, p in zip(got, tree_flatten(t_params)[0]):
        assert g.dtype == p.dtype == torch.bfloat16
    _assert_grads_close(got, _grad_leaves(t_cfg, j_grads), 0.0,
                        BF16_GRAD_ATOL_OF_MAX)


def test_cotangents_reach_the_backbone_in_its_dtype():
    """The reference casts the cotangent back to the model's dtype where
    the float32 loss meets the backbone (``_grad_dtype_boundary``);
    torch's autograd does so for every tensor: the hidden states and the
    head receive bfloat16 cotangents from the float32 loss."""
    t_cfg, _ = _cfgs("qwen2.5-32b", dtype="bfloat16")
    params = t_lm.init_params(t_cfg, torch.Generator().manual_seed(0), "cpu")
    batch = _torch_batch(_batch(t_cfg, 1, 16, seed=8))
    seen = {}
    h, _ = t_lm.backbone(params, batch["tokens"], t_cfg)
    h = h.detach().requires_grad_(True)
    head = params["head"].detach().requires_grad_(True)
    h.register_hook(lambda g: seen.update(h=g.dtype))
    head.register_hook(lambda g: seen.update(head=g.dtype))
    t_lm.chunked_ce(h, batch["targets"], head, chunk=8).backward()
    assert seen == {"h": torch.bfloat16, "head": torch.bfloat16}


def test_remat_on_and_off_are_bit_equal():
    t_cfg, _ = _cfgs("qwen2.5-32b")
    params = t_lm.init_params(t_cfg, torch.Generator().manual_seed(1), "cpu")
    batch = _torch_batch(_batch(t_cfg, 2, 32, seed=9))
    runs = [t_lm.loss_and_grads(params, batch, t_cfg.with_(remat=r))
            for r in (True, False)]
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(tree_flatten(runs[0][2])[0], tree_flatten(runs[1][2])[0]):
        assert torch.equal(a, b)


def _random_opt_state(params, seed):
    """A non-zero AdamW state of the reference's layout (float32)."""
    rng = np.random.default_rng(seed)
    return {"m": jax.tree.map(lambda a: (1e-3 * rng.standard_normal(
                a.shape)).astype(np.float32), params),
            "v": jax.tree.map(lambda a: (1e-5 * rng.uniform(
                size=a.shape)).astype(np.float32), params)}


def test_train_step_matches_jax():
    t_cfg, j_cfg = _cfgs("qwen2.5-32b")
    params = _jax_params(j_cfg, seed=10)
    opt = _random_opt_state(params, 11)
    batch = _batch(j_cfg, 2, 32, seed=12)
    kw = dict(base_lr=3e-3, warmup=5, total_steps=50)
    step = 3
    j_params, j_opt, j_metrics = j_lm.make_train_step(
        j_cfg, JAdamWConfig(), **kw)(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, opt),
        _jax_batch(batch), jnp.asarray(step))
    t_params = convert.lm_params_from_numpy(t_cfg, params, device="cpu")
    t_opt = convert.lm_opt_state_from_numpy(t_cfg, opt, device="cpu")
    ids = [id(p) for p in tree_flatten(t_params)[0]]
    new_params, new_opt, metrics = t_lm.make_train_step(
        t_cfg, AdamWConfig(), **kw)(t_params, t_opt, _torch_batch(batch),
                                    step)
    assert new_params is t_params and new_opt is t_opt  # updated in place
    assert [id(p) for p in tree_flatten(new_params)[0]] == ids
    assert set(metrics) == {"loss", "ce", "aux", "lr"}
    for k in ("loss", "ce"):
        np.testing.assert_allclose(float(metrics[k]), float(j_metrics[k]),
                                   rtol=LOSS_RTOL)
    assert float(metrics["aux"]) == float(j_metrics["aux"]) == 0.0
    np.testing.assert_allclose(float(metrics["lr"]), float(j_metrics["lr"]),
                               rtol=1e-6)
    want = tree_flatten(convert.lm_params_from_numpy(
        t_cfg, jax.tree.map(np.asarray, j_params), device="cpu"))[0]
    for i, (g, w) in enumerate(zip(tree_flatten(new_params)[0], want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=f"param leaf {i}")
    want_m = convert.lm_opt_state_from_numpy(
        t_cfg, jax.tree.map(np.asarray, j_opt), device="cpu")["m"]
    _assert_grads_close(tree_flatten(new_opt["m"])[0],
                        tree_flatten(want_m)[0], GRAD_RTOL, GRAD_ATOL_OF_MAX)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip, weight_decay", [(0.0, 0.0), (1.0, 0.0),
                                                (1e-3, 0.1)],
                         ids=["no-clip", "clip", "clipping-decay"])
def test_in_place_update_is_bit_equal_to_adamw_update(dtype, clip,
                                                      weight_decay):
    t_cfg, _ = _cfgs("qwen2.5-32b", dtype=dtype)
    params = t_lm.init_params(t_cfg, torch.Generator().manual_seed(2), "cpu")
    _, _, grads = t_lm.loss_and_grads(
        params, _torch_batch(_batch(t_cfg, 2, 16, seed=13)), t_cfg)
    leaves, unflatten = tree_flatten(params)
    gen = torch.Generator().manual_seed(3)
    state = {"m": unflatten([1e-3 * torch.randn(p.shape, generator=gen)
                             for p in leaves]),
             "v": unflatten([1e-5 * torch.rand(p.shape, generator=gen)
                             for p in leaves])}
    cfg = AdamWConfig(grad_clip_norm=clip, weight_decay=weight_decay)
    lr = torch.tensor(3e-3)
    want_p, want_s = t_adamw.adamw_update(grads, params, state, 7, cfg, lr)
    clone = lambda tree: unflatten([t.clone() for t in tree_flatten(tree)[0]])
    got_p, got_s = clone(params), {k: clone(state[k]) for k in ("m", "v")}
    grads_before = [g.clone() for g in tree_flatten(grads)[0]]
    assert t_adamw.adamw_update_(grads, got_p, got_s, 7, cfg, lr) is None
    for got, want in ((got_p, want_p), (got_s["m"], want_s["m"]),
                      (got_s["v"], want_s["v"])):
        for a, b in zip(tree_flatten(got)[0], tree_flatten(want)[0]):
            assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(tree_flatten(grads)[0], grads_before):
        assert torch.equal(a, b)  # grads are read, never written
