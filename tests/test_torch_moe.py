"""The port's mixture-of-experts family against the JAX package on the
same numpy inputs and weights: the router, the row capacity, the MoE layer
under both dispatch modes (with capacity drops), the two modes against
each other, the configs' prefill and decode logits, ``loss_fn`` with the
router's auxiliary loss and its gradients, and the ``ServeEngine``.

Tolerances: float32 outputs at atol / rtol 1e-5 (1e-4 for logits, as in
``test_torch_lm.py``); the router's expert ids, the capacity drops, token
streams and engine stats equal; the two dispatch modes bit for bit;
bfloat16 at 3e-2 (the reference's bfloat16 kernel tolerance); the loss at
rtol 1e-5 and each grad leaf at rtol 1e-4 + atol 1e-5 x its largest
magnitude (``test_torch_lm_train.py``'s rule).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.models import lm as j_lm
from repro.models import moe as j_moe
from repro.serve import engine as j_engine
from repro_torch import convert
from repro_torch.configs import registry as t_registry
from repro_torch.models import lm as t_lm
from repro_torch.models import moe as t_moe
from repro_torch.optim.adamw import tree_flatten
from repro_torch.serve import Request, ServeEngine

ARCHS = ["moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b"]
TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    return (t_registry.get_reduced(arch).with_(**kw),
            j_registry.get_reduced(arch).with_(**kw))


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32))


def _moe_params(j_cfg, seed=0):
    """The reference's ``moe_init``, as numpy float32."""
    return jax.tree.map(lambda a: np.asarray(a, np.float32),
                        j_moe.moe_init(jax.random.key(seed), j_cfg,
                                       jnp.float32))


def _skewed_x(d, b, s, seed):
    """Tokens that share a component, so that the router favours a few
    experts and some of them overflow their capacity."""
    rng = np.random.default_rng(seed)
    common = rng.standard_normal(d)
    return (rng.standard_normal((b, s, d)) + 1.5 * common).astype(np.float32)


def _dropped_pairs(idx, cfg, s):
    """Pairs past their expert's capacity, counted as the reference's
    ``moe_einsum`` counts them (queue position in (token, k) order)."""
    b = idx.shape[0]
    flat = np.asarray(idx).reshape(b, -1)
    cap = j_moe._row_capacity(cfg, s)
    dropped = 0
    for row in flat:
        seen = np.zeros(cfg.moe_num_experts, np.int64)
        for e in row:
            dropped += int(seen[e] >= cap)
            seen[e] += 1
    return dropped


@pytest.mark.parametrize("s", [1, 7, 64, 100, 1000])
def test_row_capacity_matches_jax(s):
    for arch in ARCHS:
        t_cfg, j_cfg = _cfgs(arch)
        assert t_moe._row_capacity(t_cfg, s) == j_moe._row_capacity(j_cfg, s)


@pytest.mark.parametrize("arch", ARCHS)
def test_router_matches_jax(arch):
    t_cfg, j_cfg = _cfgs(arch)
    p = _moe_params(j_cfg)
    x = _skewed_x(j_cfg.d_model, 2, 64, 1)
    j_idx, j_gate, j_aux = j_moe._router(jax.tree.map(jnp.asarray, p),
                                         jnp.asarray(x), j_cfg)
    t_idx, t_gate, t_aux = t_moe._router(_t(p), torch.from_numpy(x), t_cfg)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(t_gate.numpy(), np.asarray(j_gate), **TOL)
    np.testing.assert_allclose(float(t_aux), float(j_aux), **TOL)
    assert t_gate.dtype == torch.float32 and t_aux.dtype == torch.float32


@pytest.mark.parametrize("dispatch", ["einsum", "streaming"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_matches_jax(arch, dispatch):
    """At S = 64 the skewed tokens overflow some experts' capacity on the
    reference's side, so the drop path is held too."""
    t_cfg, j_cfg = _cfgs(arch, moe_dispatch=dispatch)
    p = _moe_params(j_cfg, seed=2)
    x = _skewed_x(j_cfg.d_model, 2, 64, 3)
    j_idx, _, _ = j_moe._router(jax.tree.map(jnp.asarray, p),
                                jnp.asarray(x), j_cfg)
    assert _dropped_pairs(j_idx, j_cfg, 64) >= 1
    j_out, j_aux = j_moe.moe(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                             j_cfg)
    t_out, t_aux = t_moe.moe(_t(p), torch.from_numpy(x), t_cfg)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(float(t_aux), float(j_aux), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_einsum_and_streaming_dispatch_are_bit_equal(arch):
    t_cfg, _ = _cfgs(arch)
    gen = torch.Generator().manual_seed(4)
    p = t_moe.moe_init(gen, t_cfg, torch.float32)
    x = torch.from_numpy(_skewed_x(t_cfg.d_model, 3, 64, 5))
    a_out, a_aux = t_moe.moe_einsum(p, x, t_cfg)
    b_out, b_aux = t_moe.moe_streaming(p, x, t_cfg)
    assert torch.equal(a_out, b_out) and torch.equal(a_aux, b_aux)


def test_moe_layer_bfloat16_matches_jax():
    t_cfg, j_cfg = _cfgs("moonshot-v1-16b-a3b", dtype="bfloat16")
    p32 = _moe_params(j_cfg, seed=6)
    jp = {k: (jnp.asarray(v) if k == "router" else
              jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), v))
          for k, v in p32.items()}
    tp = convert.params_from_numpy(jax.tree.map(
        lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32)), jp),
        device="cpu")
    tp = {k: (v if k == "router" else
              {n: t.bfloat16() for n, t in v.items()} if isinstance(v, dict)
              else v.bfloat16()) for k, v in tp.items()}
    x = jnp.asarray(_skewed_x(j_cfg.d_model, 2, 32, 7)).astype(jnp.bfloat16)
    j_out, j_aux = j_moe.moe(jp, x, j_cfg)
    t_out, t_aux = t_moe.moe(tp, torch.from_numpy(
        np.array(x.astype(jnp.float32))).bfloat16(), t_cfg)
    assert t_out.dtype == torch.bfloat16 and tp["router"].dtype == \
        torch.float32
    np.testing.assert_allclose(t_out.float().numpy(),
                               np.asarray(j_out.astype(jnp.float32)),
                               atol=3e-2, rtol=3e-2)
    np.testing.assert_allclose(float(t_aux), float(j_aux), rtol=3e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_layout_and_param_count(arch):
    t_cfg, j_cfg = _cfgs(arch)
    tp = t_lm.init_params(t_cfg.with_(dtype="bfloat16"),
                          torch.Generator().manual_seed(0), "cpu")
    assert sum(t.numel() for t in tree_flatten(tp)[0]) == \
        t_cfg.param_count()
    jp = jax.tree.map(np.asarray, j_lm.init_params(j_cfg, jax.random.key(0)))
    got = convert.lm_params_from_numpy(t_cfg.with_(dtype="bfloat16"), jp,
                                       device="cpu")
    for i, layer in enumerate(tp["layers"]):
        spec = t_cfg.layer_pattern[i % t_cfg.period]
        assert set(layer["ffn"]) == set(got["layers"][i]["ffn"])
        for name, leaf in layer["ffn"].items():
            conv = got["layers"][i]["ffn"][name]
            if isinstance(leaf, dict):
                assert {n: t.shape for n, t in leaf.items()} == \
                    {n: t.shape for n, t in conv.items()}
                continue
            assert leaf.shape == conv.shape and leaf.dtype == conv.dtype
            if name == "router":
                assert spec.ffn == "moe" and leaf.dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_jax(arch):
    """Prompts longer than llama4-reduced's window of 8 and decoding past
    it; the caches row for row."""
    t_cfg, j_cfg = _cfgs(arch)
    params = jax.tree.map(np.asarray, j_lm.init_params(j_cfg,
                                                       jax.random.key(7)))
    tparams = convert.lm_params_from_numpy(t_cfg, params, device="cpu")
    jparams = jax.tree.map(jnp.asarray, params)
    rng = np.random.default_rng(8)
    b, s, cache_len = 2, 11, 20
    tokens = rng.integers(0, j_cfg.vocab_size, size=(b, s)).astype(np.int32)
    j_logits, j_caches = j_lm.make_prefill_step(j_cfg, cache_len)(
        jparams, {"tokens": jnp.asarray(tokens)})
    t_logits, t_caches = t_lm.make_prefill_step(t_cfg, cache_len)(
        tparams, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               **LOGIT_TOL)
    j_decode, t_decode = (j_lm.make_decode_step(j_cfg),
                          t_lm.make_decode_step(t_cfg))
    for index in range(s, s + 4):
        tok = rng.integers(0, j_cfg.vocab_size, size=(b, 1)).astype(np.int32)
        j_logits, j_caches = j_decode(jparams, j_caches, jnp.asarray(tok),
                                      jnp.asarray(index, jnp.int32))
        t_logits, t_caches = t_decode(tparams, t_caches,
                                      torch.from_numpy(tok), index)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                                   **LOGIT_TOL)
    for i, c in enumerate(t_caches):
        j_c = j_caches[i % t_cfg.period]
        p = i // t_cfg.period
        np.testing.assert_allclose(c.k.numpy(), np.asarray(j_c.k[p]),
                                   **LOGIT_TOL)
        np.testing.assert_allclose(c.v.numpy(), np.asarray(j_c.v[p]),
                                   **LOGIT_TOL)


def test_loss_fn_and_grads_match_jax():
    """moonshot-reduced: ce, aux and the loss, and every grad leaf (the
    router's, through the gates and the aux loss, included)."""
    t_cfg, j_cfg = _cfgs("moonshot-v1-16b-a3b", q_block=16)
    params = jax.tree.map(np.asarray, j_lm.init_params(j_cfg,
                                                       jax.random.key(9)))
    rng = np.random.default_rng(10)
    toks = rng.integers(0, j_cfg.vocab_size, size=(2, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    (j_loss, j_m), j_grads = jax.value_and_grad(j_lm.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()}, j_cfg)
    tparams = convert.lm_params_from_numpy(t_cfg, params, device="cpu")
    t_loss, t_m, t_grads = t_lm.loss_and_grads(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()}, t_cfg)
    assert float(j_m["aux"]) > 0
    for got, want in ((t_loss, j_loss), (t_m["ce"], j_m["ce"]),
                      (t_m["aux"], j_m["aux"])):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    want = tree_flatten(convert.lm_params_from_numpy(
        t_cfg, jax.tree.map(np.asarray, j_grads), device="cpu"))[0]
    got = tree_flatten(t_grads)[0]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), w.numpy()
        np.testing.assert_allclose(
            g, w, rtol=1e-4, atol=1e-5 * float(np.abs(w).max()),
            err_msg=f"grad leaf {i} {w.shape}")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_matches_jax(arch):
    """Both engines on the same weights and prompts, some longer than
    llama4-reduced's window of 8, decoding past it, slots reused at
    unequal positions: equal token streams and stats."""
    t_cfg, j_cfg = _cfgs(arch)
    params = jax.tree.map(np.asarray, j_lm.init_params(j_cfg,
                                                       jax.random.key(11)))
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, j_cfg.vocab_size, size=n).astype(np.int32)
               for n in (13, 5, 9, 3)]
    j_reqs = [j_engine.Request(rid=i, prompt=p, max_new=8)
              for i, p in enumerate(prompts)]
    j_stats = j_engine.ServeEngine(j_cfg, jax.tree.map(jnp.asarray, params),
                                   num_slots=2, max_len=32).run(j_reqs)
    t_reqs = [Request(rid=i, prompt=p, max_new=8)
              for i, p in enumerate(prompts)]
    eng = ServeEngine(t_cfg, convert.lm_params_from_numpy(
        t_cfg, params, device="cpu"), num_slots=2, max_len=32, device="cpu")
    t_stats = eng.run(t_reqs)
    assert t_stats == j_stats
    assert [r.out for r in t_reqs] == [r.out for r in j_reqs]
    assert all(r.done and len(r.out) == 8 for r in t_reqs)
    widths = {c.k.shape[2] for c in eng.caches}
    assert widths == ({8, 32} if arch.startswith("llama4") else {32})
