"""The port's LM substrate against the JAX package on the same numpy
inputs and weights: RoPE, RMSNorm, the SwiGLU FFN, attention prefill (and
its padded cache) and decode, prefill and decode logits of the four ported
architectures' REDUCED configs, the weight conversion, the configs value
for value, the parameter accounting and the registry's cell accounting."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.models import attention as j_attn
from repro.models import common as j_common
from repro.models import ffn as j_ffn
from repro.models import lm as j_lm
from repro_torch import convert
from repro_torch.configs import registry as t_registry
from repro_torch.models import attention as t_attn
from repro_torch.models import common as t_common
from repro_torch.models import ffn as t_ffn
from repro_torch.models import lm as t_lm

ARCHS = ["qwen2.5-32b", "minitron-4b", "deepseek-coder-33b", "command-r-35b"]
MOE_ARCHS = ["moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b"]
TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def _cfg(arch):
    return t_registry.get_reduced(arch), j_registry.get_reduced(arch)


def _jax_params(cfg, seed=0):
    """The reference's init, with QKV biases (where the config has them)
    drawn non-zero, so that the bias path is exercised."""
    params = _np(j_lm.init_params(cfg, jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    for layer in params["blocks"]:
        mixer = layer["mixer"]
        for name in ("bq", "bk", "bv"):
            if name in mixer:
                mixer[name] = (0.5 * rng.standard_normal(
                    mixer[name].shape)).astype(np.float32)
    return params


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_rope_matches_jax(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 3000, size=(2, 7))
    want = j_attn.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = t_attn.rope(torch.as_tensor(x), torch.as_tensor(pos), theta)
    _close(got, want, atol=1e-5, rtol=1e-4)


def test_rmsnorm_and_ffn_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, size=48).astype(np.float32)
    _close(t_common.rmsnorm({"scale": torch.as_tensor(scale)},
                            torch.as_tensor(x), 1e-5),
           j_common.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                            1e-5))
    p = _np(j_ffn.ffn_init(jax.random.key(3), 48, 96, jnp.float32))
    _close(t_ffn.ffn(_t(p), torch.as_tensor(x)),
           j_ffn.ffn(jax.tree.map(jnp.asarray, p), jnp.asarray(x)))


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "deepseek-coder-33b"])
def test_attention_prefill_and_decode_match_jax(arch):
    tcfg, jcfg = _cfg(arch)
    mixer = _jax_params(jcfg)["blocks"][0]["mixer"]
    mixer = {k: v[0] for k, v in mixer.items()}  # layer 0 of the stack
    jp, tp = jax.tree.map(jnp.asarray, mixer), _t(mixer)
    rng = np.random.default_rng(4)
    b, s, cache_len = 2, 9, 16
    x = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    j_out, j_cache = j_attn.attn_prefill(jp, jnp.asarray(x), jcfg, cache_len)
    t_out, t_cache = t_attn.attn_prefill(tp, torch.as_tensor(x), tcfg,
                                         cache_len)
    _close(t_out, j_out)
    _close(t_cache.k, j_cache.k)
    _close(t_cache.v, j_cache.v)
    assert tuple(t_cache.k.shape) == (b, tcfg.num_kv_heads, cache_len,
                                      tcfg.head_dim)
    for index in (s, s + 3):  # the next position, and one past a gap
        xd = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
        j_out, j_cache = j_attn.attn_decode(jp, jnp.asarray(xd), jcfg,
                                            j_cache, jnp.asarray(index))
        t_out, t_cache = t_attn.attn_decode(tp, torch.as_tensor(xd), tcfg,
                                            t_cache, index)
        _close(t_out, j_out)
        _close(t_cache.k, j_cache.k)
        _close(t_cache.v, j_cache.v)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_jax(arch):
    tcfg, jcfg = _cfg(arch)
    params = _jax_params(jcfg, seed=7)
    if arch == "command-r-35b":
        assert "head" not in params and tcfg.tie_embeddings
    tparams = convert.lm_params_from_numpy(tcfg, params, device="cpu")
    jparams = jax.tree.map(jnp.asarray, params)
    rng = np.random.default_rng(8)
    b, s, cache_len = 2, 11, 20
    tokens = rng.integers(0, jcfg.vocab_size, size=(b, s)).astype(np.int32)
    j_logits, j_caches = j_lm.make_prefill_step(jcfg, cache_len)(
        jparams, {"tokens": jnp.asarray(tokens)})
    t_logits, t_caches = t_lm.make_prefill_step(tcfg, cache_len)(
        tparams, {"tokens": torch.as_tensor(tokens)})
    _close(t_logits, j_logits, **LOGIT_TOL)
    assert t_logits.dtype == torch.float32
    j_decode, t_decode = j_lm.make_decode_step(jcfg), \
        t_lm.make_decode_step(tcfg)
    for index in range(s, s + 3):
        tok = rng.integers(0, jcfg.vocab_size, size=(b, 1)).astype(np.int32)
        j_logits, j_caches = j_decode(jparams, j_caches, jnp.asarray(tok),
                                      jnp.asarray(index, jnp.int32))
        t_logits, t_caches = t_decode(tparams, t_caches,
                                      torch.as_tensor(tok), index)
        _close(t_logits, j_logits, **LOGIT_TOL)
    # the caches: the reference's [periods, ...] stack vs one per layer
    for i, c in enumerate(t_caches):
        _close(c.k, j_caches[0].k[i], **LOGIT_TOL)
        _close(c.v, j_caches[0].v[i], **LOGIT_TOL)


def test_lm_params_from_numpy_unstacks_the_period_axis():
    tcfg, jcfg = _cfg("qwen2.5-32b")
    tcfg, jcfg = tcfg.with_(num_layers=3), jcfg.with_(num_layers=3)
    params = _jax_params(jcfg, seed=3)
    got = convert.lm_params_from_numpy(tcfg, params, device="cpu")
    assert len(got["layers"]) == 3 and set(got) == {"embed", "layers",
                                                     "final_norm", "head"}
    for i, layer in enumerate(got["layers"]):
        want = jax.tree.map(lambda a: a[i], params["blocks"][0])
        flat_want = jax.tree_util.tree_leaves_with_path(want)
        for path, leaf in flat_want:
            node = layer
            for key in path:
                node = node[key.key]
            assert node.dtype == torch.float32
            np.testing.assert_array_equal(node.numpy(), leaf)
    np.testing.assert_array_equal(got["embed"].numpy(), params["embed"])
    # bfloat16 leaves come across bit for bit
    bf = convert.lm_params_from_numpy(
        tcfg.with_(dtype="bfloat16"),
        _np(jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16),
                         params)), device="cpu")
    assert bf["head"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        bf["head"].float().numpy(),
        np.asarray(jnp.asarray(params["head"]).astype(jnp.bfloat16)
                   .astype(jnp.float32)))


@pytest.mark.parametrize("arch", ARCHS + MOE_ARCHS + [
    "jamba-1.5-large-398b", "xlstm-350m", "whisper-small", "internvl2-1b"])
def test_configs_and_param_counts_match_jax(arch):
    """Every field of the port's config equals the reference's field of
    that name; the reference's fields the port does not have (its
    sharded-run knobs) are at their defaults in these configs."""
    for t_cfg, j_cfg in ((t_registry.get(arch), j_registry.get(arch)),
                         _cfg(arch)):
        t_fields, j_fields = (dataclasses.asdict(t_cfg),
                              dataclasses.asdict(j_cfg))
        assert t_fields == {k: j_fields[k] for k in t_fields}
        dropped = {f.name: f.default for f in dataclasses.fields(j_cfg)
                   if f.name not in t_fields}
        assert dropped and all(j_fields[k] == d for k, d in dropped.items())
        for knob in ("q_block", "remat", "loss_chunk"):  # read in training
            assert getattr(t_cfg, knob) == getattr(j_cfg, knob), knob
        assert t_cfg.param_count() == j_cfg.param_count()
        assert t_cfg.active_param_count() == j_cfg.active_param_count()


def test_port_init_matches_the_reference_layout_and_scales():
    cfg = t_registry.get_reduced("qwen2.5-32b").with_(d_model=256, d_ff=512)
    p = t_lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    n = sum(t.numel() for t in jax.tree.leaves(p))
    assert n == cfg.param_count()
    assert abs(float(p["embed"].std()) - 0.02) < 2e-3
    wq = p["layers"][0]["mixer"]["wq"]
    assert abs(float(wq.std()) - 256**-0.5) < 0.1 * 256**-0.5
    assert float(p["layers"][1]["mixer"]["bk"].abs().max()) == 0.0


def test_registry_and_its_cell_accounting_match_jax():
    """All ten archs in the reference's order; the dry-run cells and the
    skipped ones; the LM shape suite field for field."""
    from repro.configs import base as j_base
    from repro_torch.configs import base as t_base

    assert t_registry.list_archs() == j_registry.list_archs()
    assert len(t_registry.list_archs()) == 10
    assert t_registry.runnable_cells() == j_registry.runnable_cells()
    assert t_registry.skipped_cells() == j_registry.skipped_cells()
    assert {k: dataclasses.asdict(v) for k, v in t_base.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in j_base.SHAPES.items()}
    with pytest.raises(KeyError, match="unknown arch"):
        t_registry.get("whisper-large")


@pytest.mark.parametrize("past", [0, 2])
def test_attention_decode_at_and_past_the_cache_end_matches_jax(past):
    """At index >= S_max the reference clamps the K/V write to the last
    row (``dynamic_update_slice_in_dim``) and counts every key valid; RoPE
    stays at ``index``. The port does the same."""
    tcfg, jcfg = _cfg("qwen2.5-32b")
    mixer = _jax_params(jcfg)["blocks"][0]["mixer"]
    mixer = {k: v[0] for k, v in mixer.items()}
    jp, tp = jax.tree.map(jnp.asarray, mixer), _t(mixer)
    rng = np.random.default_rng(5)
    b, s = 2, 8
    x = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    _, j_cache = j_attn.attn_prefill(jp, jnp.asarray(x), jcfg, s)
    _, t_cache = t_attn.attn_prefill(tp, torch.as_tensor(x), tcfg, s)
    xd = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
    j_out, j_cache = j_attn.attn_decode(jp, jnp.asarray(xd), jcfg, j_cache,
                                        jnp.asarray(s + past))
    t_out, t_cache = t_attn.attn_decode(tp, torch.as_tensor(xd), tcfg,
                                        t_cache, s + past)
    _close(t_out, j_out)
    _close(t_cache.k, j_cache.k)
    _close(t_cache.v, j_cache.v)
