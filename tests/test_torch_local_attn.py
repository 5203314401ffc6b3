"""The port's local (chunked-window) attention and logit soft-capping
against the JAX package on the same numpy inputs and weights, at
llama4-maverick's REDUCED widths (window 8): ``attn_train`` and its
gradients below, around and past the window (the banded key slice
included), prefill output and cache, decode steps past the window with
the caches row for row (the reference clamps the write to the last row
and never takes its ring branch), softcap 30 through train, prefill and
decode, and kernel B6's plain version with a window and a softcap against
a masked float64 reference.

Tolerances: float32 at atol 2e-5 / rtol 1e-5 (outputs and caches) and
grads at rtol 1e-4 + atol 1e-5 x each leaf's largest magnitude, as in
``test_torch_lm_train.py``; B6's plain version at the attention tolerance
of ``test_torch_attention.py`` (atol 2e-5 / rtol 1e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.models import attention as j_attn
from repro.models import lm as j_lm
from repro_torch.configs import registry as t_registry
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.models import attention as t_attn

ARCH = "llama4-maverick-400b-a17b"
TOL = dict(atol=2e-5, rtol=1e-5)
ATTN_TOL = dict(atol=2e-5, rtol=1e-4)
GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    t_cfg, j_cfg = t_registry.get_reduced(ARCH), j_registry.get_reduced(ARCH)
    assert t_cfg.local_window == j_cfg.local_window == 8
    return t_cfg.with_(**kw), j_cfg.with_(**kw)


@pytest.fixture(scope="module")
def mixer():
    """Layer 0's attention weights of the reference's init (a local
    layer), as numpy."""
    _, j_cfg = _cfgs()
    params = jax.tree.map(np.asarray, j_lm.init_params(j_cfg,
                                                       jax.random.key(0)))
    return {k: v[0] for k, v in params["blocks"][0]["mixer"].items()}


def _x(b, s, d, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(
        (b, s, d))).astype(np.float32)


def _both(mixer):
    return (jax.tree.map(jnp.asarray, mixer),
            {k: torch.from_numpy(v.copy()) for k, v in mixer.items()})


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("s", [5, 9, 13, 40])
def test_attn_train_and_grads_match_jax(mixer, s, softcap):
    """q_block 4: S = 40 takes the banded branch (window + 4 < 40); 5, 9
    and 13 are not multiples of 4, so their one block reads every key
    under the window mask (S = 5 is all inside the window)."""
    t_cfg, j_cfg = _cfgs(logit_softcap=softcap)
    jp, tp = _both(mixer)
    x = _x(2, s, j_cfg.d_model, s, scale=2.0)
    w = np.random.default_rng(s + 1).standard_normal(
        (2, s, j_cfg.d_model)).astype(np.float32)

    def j_loss(p, x):
        out = j_attn.attn_train(p, x, j_cfg, local=True, q_block=4)
        return jnp.sum(out * w), out

    (_, j_out), j_grads = jax.value_and_grad(j_loss, argnums=(0, 1),
                                             has_aux=True)(jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    t_out = t_attn.attn_train(tp, tx, t_cfg, local=True, q_block=4)
    (t_out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out),
                               **TOL)
    pairs = [(tp[k].grad, j_grads[0][k]) for k in sorted(tp)]
    for got, want in pairs + [(tx.grad, j_grads[1])]:
        want = np.asarray(want)
        np.testing.assert_allclose(
            got.numpy(), want, rtol=GRAD_RTOL,
            atol=GRAD_ATOL_OF_MAX * float(np.abs(want).max()))


def test_window_and_softcap_change_the_output(mixer):
    """The mask and the cap bite at these inputs: without them the outputs
    differ well beyond the tolerance."""
    t_cfg, _ = _cfgs()
    _, tp = _both(mixer)
    x = torch.from_numpy(_x(1, 40, t_cfg.d_model, 3, scale=2.0))
    local = t_attn.attn_train(tp, x, t_cfg, local=True, q_block=4)
    full = t_attn.attn_train(tp, x, t_cfg, local=False, q_block=4)
    capped = t_attn.attn_train(tp, x, t_cfg.with_(logit_softcap=30.0),
                               local=True, q_block=4)
    assert float((local - full).abs().max()) > 1e-2
    assert float((local - capped).abs().max()) > 1e-3


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("s, cache_len", [(5, 24), (9, 24), (13, 24),
                                          (40, 48), (5, 6)],
                         ids=["5-in-window", "9", "13", "40", "5-cache-6"])
def test_prefill_then_decode_past_the_window_matches_jax(mixer, s, cache_len,
                                                         softcap):
    """Prefill output and cache (the last 8 keys, zero-padded to 8, when
    the window is shorter than the cache; else the padded cache), then 6
    decode steps from index s (past the window for every s but 5, which
    crosses it), the caches row for row after each step. With cache_len 6
    the window covers the cache, so the layer keeps the full-width
    cache and its decode clamps at row 5."""
    t_cfg, j_cfg = _cfgs(logit_softcap=softcap)
    jp, tp = _both(mixer)
    x = _x(2, s, j_cfg.d_model, 20 + s, scale=2.0)
    j_out, j_cache = j_attn.attn_prefill(jp, jnp.asarray(x), j_cfg,
                                         cache_len, local=True)
    t_out, t_cache = t_attn.attn_prefill(tp, torch.from_numpy(x), t_cfg,
                                         cache_len, local=True)
    width = min(8, cache_len)
    assert tuple(t_cache.k.shape) == tuple(j_cache.k.shape) == \
        (2, t_cfg.num_kv_heads, width, t_cfg.head_dim)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(t_cache.k.numpy(), np.asarray(j_cache.k),
                               **TOL)
    np.testing.assert_allclose(t_cache.v.numpy(), np.asarray(j_cache.v),
                               **TOL)
    rng = np.random.default_rng(s)
    for index in range(s, s + 6):
        xd = (2.0 * rng.standard_normal((2, 1, j_cfg.d_model))).astype(
            np.float32)
        j_out, j_cache = j_attn.attn_decode(jp, jnp.asarray(xd), j_cfg,
                                            j_cache, jnp.asarray(index),
                                            local=True)
        t_out, t_cache = t_attn.attn_decode(tp, torch.from_numpy(xd), t_cfg,
                                            t_cache, index, local=True)
        np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **TOL)
        np.testing.assert_allclose(t_cache.k.numpy(), np.asarray(j_cache.k),
                                   **TOL)
        np.testing.assert_allclose(t_cache.v.numpy(), np.asarray(j_cache.v),
                                   **TOL)


def test_decode_past_the_window_overwrites_the_last_row(mixer):
    """What the reference runs (ROADMAP.md, reference caveat 4): past the
    window a local layer's decode writes the cache's last row, never row
    ``index % width``, and the other rows stay as the prefill left them."""
    t_cfg, _ = _cfgs()
    _, tp = _both(mixer)
    x = torch.from_numpy(_x(1, 13, t_cfg.d_model, 5))
    _, cache = t_attn.attn_prefill(tp, x, t_cfg, 24, local=True)
    before = cache.k.clone()
    for index in (13, 14, 15):
        xd = torch.from_numpy(_x(1, 1, t_cfg.d_model, index))
        _, cache = t_attn.attn_decode(tp, xd, t_cfg, cache, index, local=True)
        assert torch.equal(cache.k[:, :, :7], before[:, :, :7])
        assert not torch.equal(cache.k[:, :, 7], before[:, :, 7])


def test_local_cache_width_and_a_wider_cache_raises(mixer):
    t_cfg, _ = _cfgs()
    _, tp = _both(mixer)
    assert t_attn.kv_cache_init(t_cfg, 2, 24, torch.float32, "cpu",
                                local=True).k.shape[2] == 8
    assert t_attn.kv_cache_init(t_cfg, 2, 6, torch.float32, "cpu",
                                local=True).k.shape[2] == 6
    wide = t_attn.kv_cache_init(t_cfg, 1, 24, torch.float32, "cpu")
    xd = torch.from_numpy(_x(1, 1, t_cfg.d_model, 0))
    with pytest.raises(ValueError, match="ring branch"):
        t_attn.attn_decode(tp, xd, t_cfg, wide, 3, local=True)


def _masked_f64(q, k, v, causal, kv_len, window, softcap):
    """B6's function in float64 with an explicit [Sq, Sk] mask."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    heads = np.arange(h) // (h // kvh)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64),
                  k[:, heads].astype(np.float64)) * d**-0.5
    if softcap > 0:
        s = softcap * np.tanh(s / softcap)
    qpos, kpos = np.arange(sq)[:, None], np.arange(sk)[None, :]
    valid = (kpos < kv_len) & np.ones((sq, 1), bool)
    if causal:
        valid &= qpos >= kpos
    if window:
        valid &= qpos - kpos < window
    s = np.where(valid, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bhkd->bhqd", p, v[:, heads].astype(np.float64))


@pytest.mark.parametrize("sq, sk, causal, kv_len, window, softcap", [
    (40, 40, True, 40, 8, 0.0),
    (65, 65, True, 65, 64, 0.0),  # window + 1
    (129, 129, True, 129, 64, 0.0),  # window + a 64-row query block + 1
    (40, 40, True, 40, 8, 30.0),
    (40, 40, True, 40, 0, 3.0),
    (1, 48, False, 30, 0, 30.0),  # a decode with softcap
    (24, 48, False, 40, 16, 0.0),
])
def test_plain_b6_window_and_softcap_match_a_masked_float64_reference(
        sq, sk, causal, kv_len, window, softcap):
    rng = np.random.default_rng(sq + sk)
    q = rng.standard_normal((2, 4, sq, 64)).astype(np.float32)
    k = (2 * rng.standard_normal((2, 2, sk, 64))).astype(np.float32)
    v = rng.standard_normal((2, 2, sk, 64)).astype(np.float32)
    got = t_fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal,
                               kv_len=kv_len, window=window, softcap=softcap)
    want = _masked_f64(q, k, v, causal, kv_len, window, softcap)
    np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)


def test_plain_b6_decode_partials_take_the_softcap():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((2, 4, 1, 64)).astype(np.float32))
    k, v = (torch.from_numpy((2 * rng.standard_normal((2, 2, 200, 64)))
                             .astype(np.float32)) for _ in range(2))
    parts = t_fa.decode_partials_plain(q, k, v, kv_len=150, splits=4,
                                       split_len=64, softcap=5.0)
    got = t_fa.decode_combine_plain(*parts, torch.float32)
    want = t_fa.flash_attention_plain(q, k, v, causal=False, kv_len=150,
                                      softcap=5.0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **ATTN_TOL)


def test_a_window_that_leaves_a_query_no_key_raises():
    q = torch.zeros((1, 2, 20, 64))
    k = v = torch.zeros((1, 2, 20, 64))
    with pytest.raises(ValueError, match="no key"):
        t_fa.flash_attention(q, k, v, causal=False, kv_len=10, window=10)
    with pytest.raises(ValueError, match=">= 0"):
        t_fa.flash_attention(q, k, v, window=-1)
    t_fa.flash_attention(q, k, v, causal=False, kv_len=11, window=10)
