"""The port's Mamba mixer and jamba (the hybrid family) against the JAX
package on the same numpy inputs and weights: ``mamba_chunked`` (output
and state) at chunks of 4, 16 and the whole sequence, with S = 16 and
S = 15 (which the reference runs as one chunk), a chunked prefix carried
into ``mamba_decode`` steps, a decay that underflows to 0 (the
reference's ``log(max(decay, 1e-30))`` clamp), the products' order
(no intermediate larger than a chunk's weights or the layer's
projections), jamba-reduced's prefill logits and every cache leaf,
``ServeEngine`` streams and stats, ``loss_fn`` and every grad leaf, the
leaf dtypes of a bfloat16 model, the configs' accounting and the CUDA
engine's head-dim rule.

Tolerances: the layer at rtol / atol 1e-5 (float32 sums in another
order); logits and caches at 1e-4 (``test_torch_lm.py``'s); streams and
stats equal; the loss at rtol 1e-5 (``test_torch_lm_train.py``'s) and
each grad leaf at its rule, rtol 1e-4 + atol 1e-5 x its largest
magnitude, but a Mamba mixer's leaves at atol 3e-5 x its largest and
their per-head ``a_log``, ``dt_bias`` and ``d_skip`` at 2e-4 x its
largest. Those gradients run through the SSM's exp / cumsum / log chain,
whose sums over every position cancel where float32 rounding does not:
the two packages sit up to ~1.4e-5 of a leaf's largest apart there on
this test's inputs (~7.6e-5 for the per-head leaves, each of whose 4
entries sums over every position), and within 7.9e-6 everywhere else.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import registry as j_registry
from repro.models import lm as j_lm
from repro.models import mamba as j_mamba
from repro.serve import engine as j_engine
from repro_torch import convert
from repro_torch.configs import registry as t_registry
from repro_torch.models import lm as t_lm
from repro_torch.models import mamba as t_mamba
from repro_torch.optim.adamw import tree_flatten
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve import engine as t_engine

ARCH = "jamba-1.5-large-398b"
TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_opt_einsum():
    """torch.einsum contracting left to right, as where opt_einsum is
    missing; restored after the test."""
    was = torch.backends.opt_einsum.enabled
    torch.backends.opt_einsum.enabled = False
    yield
    torch.backends.opt_einsum.enabled = was


def _cfgs(**kw):
    return (t_registry.get_reduced(ARCH).with_(**kw),
            j_registry.get_reduced(ARCH).with_(**kw))


def _mixer(j_cfg, seed=0, **override):
    """The reference's ``mamba_init`` (float32) as numpy, and the port's
    copy through ``convert``."""
    p = jax.tree.map(np.asarray, j_mamba.mamba_init(jax.random.key(seed),
                                                    j_cfg, jnp.float32))
    p.update({k: np.full_like(p[k], v) for k, v in override.items()})
    return p, convert.params_from_numpy(p, device="cpu")


def _x(b, s, d, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(
        (b, s, d))).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def _close_state(got, want, **tol):
    assert type(got).__name__ == type(want).__name__
    for g, w in zip(got, want):
        _close(g, w, **tol)


@pytest.mark.parametrize("s", [16, 15])
@pytest.mark.parametrize("chunk", [4, 16, "whole"])
def test_mamba_chunked_matches_jax(s, chunk):
    t_cfg, j_cfg = _cfgs()
    jp, tp = _mixer(j_cfg, seed=1)
    x = _x(2, s, j_cfg.d_model, 2)
    c = s if chunk == "whole" else chunk
    j_out, j_st = j_mamba.mamba_chunked(jp, jnp.asarray(x), j_cfg, chunk=c)
    t_out, t_st = t_mamba.mamba_chunked(tp, torch.from_numpy(x), t_cfg,
                                        chunk=c)
    _close(t_out, j_out)
    _close_state(t_st, j_st)
    assert t_st.ssm.dtype == torch.float32


def test_mamba_prefix_then_decode_matches_jax():
    """A chunked prefix of 12 positions (chunk 4), then a chunked
    continuation of 4 from its state, then 5 decode steps."""
    t_cfg, j_cfg = _cfgs()
    jp, tp = _mixer(j_cfg, seed=3)
    x = _x(2, 21, j_cfg.d_model, 4)
    j_out, j_st = j_mamba.mamba_chunked(jp, jnp.asarray(x[:, :12]), j_cfg,
                                        chunk=4)
    t_out, t_st = t_mamba.mamba_chunked(tp, torch.from_numpy(x[:, :12]),
                                        t_cfg, chunk=4)
    _close(t_out, j_out)
    j_out, j_st = j_mamba.mamba_chunked(jp, jnp.asarray(x[:, 12:16]), j_cfg,
                                        chunk=4, state=j_st)
    t_out, t_st = t_mamba.mamba_chunked(tp, torch.from_numpy(x[:, 12:16]),
                                        t_cfg, chunk=4, state=t_st)
    _close(t_out, j_out)
    _close_state(t_st, j_st)
    for t in range(16, 21):
        j_out, j_st = j_mamba.mamba_decode(jp, jnp.asarray(x[:, t:t + 1]),
                                           j_cfg, j_st)
        t_out, t_st = t_mamba.mamba_decode(tp, torch.from_numpy(
            x[:, t:t + 1]), t_cfg, t_st)
        _close(t_out, j_out)
        _close_state(t_st, j_st)


def test_mamba_decay_underflow_is_clamped_as_jax_clamps():
    """dt_bias 12 makes dt ~ 12, so exp(dt * a) underflows to 0 in float32
    for the heads with a <= -7.3: log(0) would be -inf without the
    reference's 1e-30 clamp."""
    t_cfg, j_cfg = _cfgs()
    jp, tp = _mixer(j_cfg, seed=5, dt_bias=12.0)
    x = _x(2, 16, j_cfg.d_model, 6)
    decay = j_mamba._gates(jp, jnp.asarray(x), j_cfg, None)[5]
    assert float(jnp.min(decay)) == 0.0 and float(jnp.max(decay)) > 0.0
    for chunk in (4, 16):
        j_out, j_st = j_mamba.mamba_chunked(jp, jnp.asarray(x), j_cfg,
                                            chunk=chunk)
        t_out, t_st = t_mamba.mamba_chunked(tp, torch.from_numpy(x), t_cfg,
                                            chunk=chunk)
        assert torch.isfinite(t_out).all()
        _close(t_out, j_out)
        _close_state(t_st, j_st)


class _Sizes(TorchDispatchMode):
    """Records every op's output shapes."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.shapes.append((str(func), tuple(t.shape)))
        return out


@pytest.mark.parametrize("s, chunk", [(64, 16), (64, 64), (48, 64)],
                         ids=["chunks", "whole", "whole-not-a-multiple"])
def test_mamba_products_never_build_a_5d_intermediate(no_opt_einsum, s,
                                                      chunk):
    """With ``torch.einsum`` contracting left to right, no op's output
    has more elements than a chunk's [B, L, S, H] weights or the layer's
    in_proj output [B, S, 2 * d_inner] (its x and z: twice the [B, S, H,
    P] input); the reference's four-operand einsum, contracted so, would
    build [B, L, S, H, P]."""
    t_cfg, j_cfg = _cfgs()
    _, tp = _mixer(j_cfg)
    b, h = 2, t_cfg.num_heads
    d_inner = t_cfg.mamba_expand * t_cfg.d_model
    x = torch.from_numpy(_x(b, s, t_cfg.d_model, 7))
    rec = _Sizes()
    with rec:
        t_mamba.mamba_chunked(tp, x, t_cfg, chunk=chunk)
    l = chunk if s % chunk == 0 else s
    bound = max(b * l * l * h, b * s * 2 * d_inner)
    big = [(f, sh) for f, sh in rec.shapes if int(np.prod(sh)) > bound]
    assert not big, (bound, big)
    assert any(len(sh) == 4 and sh == (b, l, l, h) for _, sh in rec.shapes)


def _lm_params(j_cfg, seed):
    return jax.tree.map(np.asarray, j_lm.init_params(j_cfg,
                                                     jax.random.key(seed)))


def test_jamba_prefill_decode_logits_and_caches_match_jax():
    """Prompt 11 (not a multiple of the 256-chunk: one chunk), then 4
    decode steps; logits and every cache leaf of every layer."""
    t_cfg, j_cfg = _cfgs()
    params = _lm_params(j_cfg, 7)
    tparams = convert.lm_params_from_numpy(t_cfg, params, device="cpu")
    jparams = jax.tree.map(jnp.asarray, params)
    rng = np.random.default_rng(8)
    b, s, cache_len = 2, 11, 20
    tokens = rng.integers(0, j_cfg.vocab_size, size=(b, s)).astype(np.int32)
    j_logits, j_caches = j_lm.make_prefill_step(j_cfg, cache_len)(
        jparams, {"tokens": jnp.asarray(tokens)})
    t_logits, t_caches = t_lm.make_prefill_step(t_cfg, cache_len)(
        tparams, {"tokens": torch.from_numpy(tokens)})
    _close(t_logits, j_logits, **LOGIT_TOL)

    def caches_close():
        for i, c in enumerate(t_caches):
            j_c = j_caches[i % t_cfg.period]
            _close_state(c, type(j_c)(*(leaf[i // t_cfg.period]
                                        for leaf in j_c)), **LOGIT_TOL)

    caches_close()
    decode = t_lm.make_decode_step(t_cfg)
    for index in range(s, s + 4):
        tok = rng.integers(0, j_cfg.vocab_size, size=(b, 1)).astype(np.int32)
        j_logits, j_caches = j_lm.make_decode_step(j_cfg)(
            jparams, j_caches, jnp.asarray(tok), jnp.asarray(index, jnp.int32))
        t_logits, t_caches = decode(tparams, t_caches, torch.from_numpy(tok),
                                    index)
        _close(t_logits, j_logits, **LOGIT_TOL)
    caches_close()


def test_jamba_serve_engine_matches_jax():
    """Both engines on the same weights and prompts, slots reused at
    unequal positions: equal token streams and stats."""
    t_cfg, j_cfg = _cfgs()
    params = _lm_params(j_cfg, 11)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, j_cfg.vocab_size, size=n).astype(np.int32)
               for n in (13, 5, 9)]
    j_reqs = [j_engine.Request(rid=i, prompt=p, max_new=6)
              for i, p in enumerate(prompts)]
    j_stats = j_engine.ServeEngine(j_cfg, jax.tree.map(jnp.asarray, params),
                                   num_slots=2, max_len=24).run(j_reqs)
    t_reqs = [Request(rid=i, prompt=p, max_new=6)
              for i, p in enumerate(prompts)]
    eng = ServeEngine(t_cfg, convert.lm_params_from_numpy(
        t_cfg, params, device="cpu"), num_slots=2, max_len=24, device="cpu")
    t_stats = eng.run(t_reqs)
    assert t_stats == j_stats
    assert [r.out for r in t_reqs] == [r.out for r in j_reqs]
    assert all(r.done and len(r.out) == 6 for r in t_reqs)
    assert {type(c).__name__ for c in eng.caches} == {"KVCache",
                                                       "MambaState"}


def test_jamba_loss_fn_and_grads_match_jax():
    """jamba-reduced on 2 x 32 tokens (one Mamba chunk); ce, aux, the
    loss and every grad leaf, the Mamba and MoE leaves included."""
    t_cfg, j_cfg = _cfgs(q_block=16)
    params = _lm_params(j_cfg, 9)
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
    want = _leaves(convert.lm_params_from_numpy(
        t_cfg, jax.tree.map(np.asarray, j_grads), device="cpu"))
    got = _leaves(t_grads)
    assert sorted(got) == sorted(want)
    assert len(got) == len(tree_flatten(t_grads)[0])
    for path, g in got.items():
        w = want[path].numpy()
        parts = path.split("/")
        in_mamba = (parts[1] == "layers" and parts[3] == "mixer"
                    and t_cfg.layer_pattern[int(parts[2]) % t_cfg.period]
                    .mixer == "mamba")
        atol = (1e-5 if not in_mamba else
                2e-4 if parts[4] in t_mamba.FLOAT32_LEAVES else 3e-5)
        np.testing.assert_allclose(
            g.numpy(), w, rtol=1e-4, atol=atol * float(np.abs(w).max()),
            err_msg=f"grad leaf {path}")


def _leaves(tree, prefix=""):
    """{"/layers/3/mixer/a_log": tensor, ...} of a nested dict / list."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_leaves(v, f"{prefix}/{k}"))
    return out


def _dtypes(tree):
    return {k: str(v.dtype).replace("torch.", "")
            for k, v in _leaves(tree).items()}


def test_jamba_bfloat16_leaves_keep_the_reference_dtypes():
    """A bfloat16 jamba: each converted leaf has the reference init's
    dtype (the Mamba's dt_bias / a_log / d_skip and the router float32),
    and the port's own init makes the same dtypes."""
    t_cfg, j_cfg = _cfgs(dtype="bfloat16")
    params = _lm_params(j_cfg, 0)
    got = convert.lm_params_from_numpy(t_cfg, params, device="cpu")
    init = t_lm.init_params(t_cfg, torch.Generator().manual_seed(0), "cpu")
    want = {}
    for i in range(t_cfg.num_layers):
        layer = jax.tree.map(lambda a: a[i // t_cfg.period],
                             params["blocks"][i % t_cfg.period])
        want.update({f"/layers/{i}{k}": v for k, v in _dtypes(
            jax.tree.map(lambda a: torch.empty(0, dtype=getattr(
                torch, str(a.dtype))), layer)).items()})
    got_layers = {k: v for k, v in _dtypes(got).items()
                  if k.startswith("/layers")}
    assert got_layers == want
    assert _dtypes(init) == _dtypes(got)
    mamba = got["layers"][1]["mixer"]
    assert {n for n, t in mamba.items() if t.dtype == torch.float32} == \
        set(t_mamba.FLOAT32_LEAVES)
    assert got["layers"][1]["ffn"]["router"].dtype == torch.float32
    assert got["layers"][0]["mixer"]["wo"].dtype == torch.bfloat16


def test_cuda_engine_checks_head_dim_only_with_an_attention_layer(
        monkeypatch):
    """On a CUDA device the engine refuses a head_dim B6 does not take
    when the model has an attention layer (jamba-reduced at head_dim 16),
    and does not check it for an attention-free model (xlstm-reduced,
    whose head_dim is the config's 256), whose engine goes on to its next
    rule."""
    monkeypatch.setattr(t_engine, "resolve_device",
                        lambda device: torch.device("cuda"))
    for cfg, msg in ((t_registry.get_reduced(ARCH).with_(head_dim=16),
                      "head_dim 16"),
                     (t_registry.get_reduced("xlstm-350m"), "params on")):
        params = {"embed": torch.zeros(cfg.vocab_size, cfg.d_model)}
        with pytest.raises(ValueError, match=msg):
            ServeEngine(cfg, params, num_slots=1, max_len=8)
