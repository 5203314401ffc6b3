"""The port's xLSTM mixers and xlstm-350m (the SSM family) against the JAX
package on the same numpy inputs and weights: ``mlstm_chunked`` (output
and state) at chunks of 4, 16 and the whole sequence, with S = 16 and
S = 15 (which the reference runs as one chunk); ``mlstm_scan`` from a
fresh and a given state; a chunked prefill handing its ``m_carry``-
stabilized state to scan decode steps; ``slstm_scan``; the products'
order (no intermediate larger than a chunk's weights or the layer's
[B, S, D] projections); xlstm-reduced's prefill logits and every state
leaf, ``ServeEngine`` streams and stats, ``loss_fn`` and every grad leaf;
and the leaf dtypes of a bfloat16 model (sLSTM's ``wo`` float32, where
attention's ``wo`` is in the model's dtype).

Tolerances: the layers at rtol / atol 1e-5 (float32 sums in another
order); logits and states at 1e-4 (``test_torch_lm.py``'s); streams and
stats equal; the loss at rtol 1e-5 and each grad leaf at rtol 1e-4 +
atol 1e-5 x its largest magnitude (``test_torch_lm_train.py``'s rule),
with two exceptions. The mLSTM's per-head ``bi`` and ``bf`` are held at
atol 1e-4 x their largest: each of their 4 entries sums a gradient over
every position, where float32 rounding does not cancel as the sum does,
and the two packages sit ~2e-5 of the leaf's largest apart on this
test's inputs. The sLSTM's ``bi`` has a
gradient of exactly 0 (a shift of every input gate moves the stabilizer
``m`` with it and changes nothing), so both packages' values, float32
rounding noise, must lie within 1e-6 of the layer's ``wi`` / ``wz``
gradients' largest magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import registry as j_registry
from repro.models import lm as j_lm
from repro.models import xlstm as j_xlstm
from repro.serve import engine as j_engine
from repro_torch import convert
from repro_torch.configs import registry as t_registry
from repro_torch.models import lm as t_lm
from repro_torch.models import xlstm as t_xlstm
from repro_torch.optim.adamw import tree_flatten
from repro_torch.serve import Request, ServeEngine

ARCH = "xlstm-350m"
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


def _mixer(init, j_cfg, seed=0):
    """A reference init (float32) as numpy, and the port's copy through
    ``convert``."""
    p = jax.tree.map(np.asarray, init(jax.random.key(seed), j_cfg,
                                      jnp.float32))
    return p, convert.params_from_numpy(p, device="cpu")


def _x(b, s, d, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, d)).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def _close_state(got, want, **tol):
    assert type(got).__name__ == type(want).__name__
    for g, w in zip(got, want):
        _close(g, w, **tol)


@pytest.mark.parametrize("s", [16, 15])
@pytest.mark.parametrize("chunk", [4, 16, "whole"])
def test_mlstm_chunked_matches_jax(s, chunk):
    t_cfg, j_cfg = _cfgs()
    jp, tp = _mixer(j_xlstm.mlstm_init, j_cfg, seed=1)
    x = _x(2, s, j_cfg.d_model, 2)
    c = s if chunk == "whole" else chunk
    j_out, j_st = j_xlstm.mlstm_chunked(jp, jnp.asarray(x), j_cfg, chunk=c)
    t_out, t_st = t_xlstm.mlstm_chunked(tp, torch.from_numpy(x), t_cfg,
                                        chunk=c)
    _close(t_out, j_out)
    _close_state(t_st, j_st)


def test_mlstm_scan_matches_jax():
    """From a fresh state, then on from the state it left."""
    t_cfg, j_cfg = _cfgs()
    jp, tp = _mixer(j_xlstm.mlstm_init, j_cfg, seed=3)
    x = _x(2, 14, j_cfg.d_model, 4)
    j_out, j_st = j_xlstm.mlstm_scan(jp, jnp.asarray(x[:, :9]), j_cfg)
    t_out, t_st = t_xlstm.mlstm_scan(tp, torch.from_numpy(x[:, :9]), t_cfg)
    _close(t_out, j_out)
    _close_state(t_st, j_st)
    j_out, j_st = j_xlstm.mlstm_scan(jp, jnp.asarray(x[:, 9:]), j_cfg, j_st)
    t_out, t_st = t_xlstm.mlstm_scan(tp, torch.from_numpy(x[:, 9:]), t_cfg,
                                     t_st)
    _close(t_out, j_out)
    _close_state(t_st, j_st)


def test_mlstm_chunked_prefill_then_scan_decode_matches_jax():
    """The serving path: a chunked prefill of 12 (chunk 4), then 5 scan
    steps of one token from its m_carry-stabilized state; the port's
    outputs also equal its own scan over all 17 positions, and so do its
    states, each scaled by its own stabilizer (at 1e-4)."""
    t_cfg, j_cfg = _cfgs()
    jp, tp = _mixer(j_xlstm.mlstm_init, j_cfg, seed=5)
    x = _x(2, 17, j_cfg.d_model, 6)
    j_out, j_st = j_xlstm.mlstm_chunked(jp, jnp.asarray(x[:, :12]), j_cfg,
                                        chunk=4)
    t_out, t_st = t_xlstm.mlstm_chunked(tp, torch.from_numpy(x[:, :12]),
                                        t_cfg, chunk=4)
    _close(t_out, j_out)
    outs = [t_out]
    for t in range(12, 17):
        j_out, j_st = j_xlstm.mlstm_scan(jp, jnp.asarray(x[:, t:t + 1]),
                                         j_cfg, j_st)
        t_out, t_st = t_xlstm.mlstm_scan(tp, torch.from_numpy(
            x[:, t:t + 1]), t_cfg, t_st)
        _close(t_out, j_out)
        _close_state(t_st, j_st)
        outs.append(t_out)
    scan_out, scan_st = t_xlstm.mlstm_scan(tp, torch.from_numpy(x), t_cfg)
    _close(torch.cat(outs, dim=1), scan_out.numpy())
    # c and n agree once each is scaled by its own stabilizer exp(m)
    for a, b in zip(t_st[:2], scan_st[:2]):
        scale = lambda st, t: torch.exp(st.m).reshape(
            *st.m.shape, *[1] * (t.dim() - 2))
        _close(a * scale(t_st, a), (b * scale(scan_st, b)).numpy(),
               **LOGIT_TOL)


def test_slstm_scan_matches_jax():
    t_cfg, j_cfg = _cfgs()
    jp, tp = _mixer(j_xlstm.slstm_init, j_cfg, seed=7)
    x = _x(2, 13, j_cfg.d_model, 8)
    j_out, j_st = j_xlstm.slstm_scan(jp, jnp.asarray(x[:, :8]), j_cfg)
    t_out, t_st = t_xlstm.slstm_scan(tp, torch.from_numpy(x[:, :8]), t_cfg)
    _close(t_out, j_out)
    _close_state(t_st, j_st)
    j_out, j_st = j_xlstm.slstm_scan(jp, jnp.asarray(x[:, 8:]), j_cfg, j_st)
    t_out, t_st = t_xlstm.slstm_scan(tp, torch.from_numpy(x[:, 8:]), t_cfg,
                                     t_st)
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
def test_mlstm_products_never_build_a_5d_intermediate(no_opt_einsum, s,
                                                      chunk):
    """With ``torch.einsum`` contracting left to right, no op's output
    has more elements than a chunk's [B, L, S, H] weights or the layer's
    [B, S, H, dh] input (its [B, S, D] projections)."""
    t_cfg, j_cfg = _cfgs()
    _, tp = _mixer(j_xlstm.mlstm_init, j_cfg)
    b, h, d = 2, t_cfg.xlstm_heads, t_cfg.d_model
    x = torch.from_numpy(_x(b, s, d, 9))
    rec = _Sizes()
    with rec:
        t_xlstm.mlstm_chunked(tp, x, t_cfg, chunk=chunk)
    l = chunk if s % chunk == 0 else s
    bound = max(b * l * l * h, b * s * d)
    big = [(f, sh) for f, sh in rec.shapes if int(np.prod(sh)) > bound]
    assert not big, (bound, big)
    assert any(sh == (b, l, l, h) for _, sh in rec.shapes)


def _lm_params(j_cfg, seed):
    return jax.tree.map(np.asarray, j_lm.init_params(j_cfg,
                                                     jax.random.key(seed)))


def test_xlstm_prefill_decode_logits_and_states_match_jax():
    """Prompt 11 (not a multiple of the 128-chunk: one chunk), then 4
    decode steps; logits and every state leaf of every layer (tied
    embeddings: no head)."""
    t_cfg, j_cfg = _cfgs()
    params = _lm_params(j_cfg, 7)
    assert "head" not in params and t_cfg.tie_embeddings
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

    def states_close():
        for i, c in enumerate(t_caches):
            j_c = j_caches[i % t_cfg.period]
            _close_state(c, type(j_c)(*(leaf[i // t_cfg.period]
                                        for leaf in j_c)), **LOGIT_TOL)

    states_close()
    decode = t_lm.make_decode_step(t_cfg)
    for index in range(s, s + 4):
        tok = rng.integers(0, j_cfg.vocab_size, size=(b, 1)).astype(np.int32)
        j_logits, j_caches = j_lm.make_decode_step(j_cfg)(
            jparams, j_caches, jnp.asarray(tok), jnp.asarray(index, jnp.int32))
        t_logits, t_caches = decode(tparams, t_caches, torch.from_numpy(tok),
                                    index)
        _close(t_logits, j_logits, **LOGIT_TOL)
    states_close()


def test_xlstm_serve_engine_matches_jax():
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
    assert {type(c).__name__ for c in eng.caches} == {"MlstmState",
                                                       "SlstmState"}


def _leaves(tree, prefix=""):
    """{"/layers/7/mixer/wo": tensor, ...} of a nested dict / list."""
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


def test_xlstm_loss_fn_and_grads_match_jax():
    """xlstm-reduced on 2 x 32 tokens: ce, aux (0: no MoE), the loss and
    every grad leaf, the tied embedding's included."""
    t_cfg, j_cfg = _cfgs()
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
    assert float(t_m["aux"]) == float(j_m["aux"]) == 0.0
    for got, want in ((t_loss, j_loss), (t_m["ce"], j_m["ce"])):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    want = _leaves(convert.lm_params_from_numpy(
        t_cfg, jax.tree.map(np.asarray, j_grads), device="cpu"))
    got = _leaves(t_grads)
    assert sorted(got) == sorted(want)
    assert len(got) == len(tree_flatten(t_grads)[0])
    for path, g in got.items():
        g, w = g.numpy(), want[path].numpy()
        parts = path.split("/")  # "", "layers", i, "mixer", name
        mixer = (t_cfg.layer_pattern[int(parts[2]) % t_cfg.period].mixer
                 if parts[1] == "layers" and parts[3] == "mixer" else None)
        if mixer == "slstm" and parts[4] == "bi":
            # 0 in exact arithmetic: both packages give rounding noise
            scale = max(float(np.abs(want[f"/layers/{parts[2]}/mixer/{n}"]
                                     .numpy()).max()) for n in ("wi", "wz"))
            assert max(np.abs(g).max(), np.abs(w).max()) <= 1e-6 * scale
            continue
        per_head = mixer == "mlstm" and parts[4] in ("bi", "bf")
        np.testing.assert_allclose(
            g, w, rtol=1e-4,
            atol=(1e-4 if per_head else 1e-5) * float(np.abs(w).max()),
            err_msg=f"grad leaf {path}")




def test_xlstm_bfloat16_leaves_keep_the_reference_dtypes():
    """A bfloat16 xlstm: each converted leaf has the reference init's
    dtype (the mLSTM's gates and every sLSTM leaf but w_out float32), the
    port's own init makes the same dtypes, and no layer has an FFN."""
    t_cfg, j_cfg = _cfgs(dtype="bfloat16")
    params = _lm_params(j_cfg, 0)
    got = convert.lm_params_from_numpy(t_cfg, params, device="cpu")
    init = t_lm.init_params(t_cfg, torch.Generator().manual_seed(0), "cpu")
    want = {}
    for i in range(t_cfg.num_layers):
        layer = params["blocks"][i % t_cfg.period]
        want.update({f"/layers/{i}{k}": v.replace("torch.", "")
                     for k, v in _dtypes(jax.tree.map(
                         lambda a: torch.empty(0, dtype=getattr(
                             torch, str(a.dtype))), layer)).items()})
    assert {k: v for k, v in _dtypes(got).items()
            if k.startswith("/layers")} == want
    assert _dtypes(init) == _dtypes(got)
    assert set(got) == {"embed", "layers", "final_norm"}
    slstm, mlstm = got["layers"][7]["mixer"], got["layers"][0]["mixer"]
    assert slstm["wo"].dtype == torch.float32
    assert slstm["w_out"].dtype == torch.bfloat16
    assert {n for n, t in slstm.items() if t.dtype == torch.float32} == \
        set(t_xlstm.SLSTM_FLOAT32_LEAVES)
    assert {n for n, t in mlstm.items() if t.dtype == torch.float32} == \
        set(t_xlstm.MLSTM_FLOAT32_LEAVES)
    assert all(set(layer) == {"norm1", "mixer"} for layer in got["layers"])
