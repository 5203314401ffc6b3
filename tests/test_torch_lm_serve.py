"""The port's LM ``ServeEngine`` against the JAX package's at
qwen2.5-reduced in float32, on the same weights and prompts: equal token
streams and equal stats dicts (``ticks``, ``tokens_computed``,
``reuse_ratio``) for three fleets. With equal prompt lengths the streams
also equal each prompt's direct greedy generation; with unequal lengths
the reference decodes every slot at the longest slot's position
(``engine.py:84``), and the port reproduces that, so both depart from
direct generation in the same way."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.models import lm as j_lm
from repro.serve import engine as j_engine
from repro_torch import convert
from repro_torch.configs import registry as t_registry
from repro_torch.models import lm as t_lm
from repro_torch.serve import Request, ServeEngine

ARCH = "qwen2.5-32b"


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    tcfg, jcfg = t_registry.get_reduced(ARCH), j_registry.get_reduced(ARCH)
    params = jax.tree.map(np.asarray, j_lm.init_params(jcfg,
                                                       jax.random.key(0)))
    rng = np.random.default_rng(0)
    for name in ("bq", "bk", "bv"):  # the bias path, drawn non-zero
        mixer = params["blocks"][0]["mixer"]
        mixer[name] = (0.5 * rng.standard_normal(mixer[name].shape)
                       ).astype(np.float32)
    return (tcfg, convert.lm_params_from_numpy(tcfg, params, device="cpu"),
            jcfg, jax.tree.map(jnp.asarray, params))


def _direct(model, prompt, n_new):
    """The port's single-request greedy generation (no shared index)."""
    tcfg, tparams = model[:2]
    logits, caches = t_lm.make_prefill_step(tcfg, len(prompt) + n_new + 2)(
        tparams, {"tokens": torch.as_tensor(prompt[None].astype(np.int64))})
    decode = t_lm.make_decode_step(tcfg)
    out = [int(torch.argmax(logits[0]))]
    for pos in range(len(prompt), len(prompt) + n_new - 1):
        logits, caches = decode(tparams, caches,
                                torch.as_tensor([[out[-1]]]), pos)
        out.append(int(torch.argmax(logits[0])))
    return out


def _serve_both(model, prompts, max_new, num_slots, max_len):
    tcfg, tparams, jcfg, jparams = model
    j_reqs = [j_engine.Request(rid=i, prompt=p, max_new=max_new)
              for i, p in enumerate(prompts)]
    j_stats = j_engine.ServeEngine(jcfg, jparams, num_slots=num_slots,
                                   max_len=max_len).run(j_reqs)
    t_reqs = [Request(rid=i, prompt=p, max_new=max_new)
              for i, p in enumerate(prompts)]
    t_stats = ServeEngine(tcfg, tparams, num_slots=num_slots,
                          max_len=max_len, device="cpu").run(t_reqs)
    assert t_stats == j_stats
    assert [r.out for r in t_reqs] == [r.out for r in j_reqs]
    assert all(r.done for r in t_reqs)
    return t_reqs, t_stats


def _prompts(seed, lengths, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lengths]


def test_equal_prompts_match_jax_and_direct_generation(model):
    prompts = _prompts(1, [8, 8])
    reqs, stats = _serve_both(model, prompts, max_new=6, num_slots=2,
                              max_len=32)
    for r, p in zip(reqs, prompts):
        assert r.out == _direct(model, p, 6)
    assert stats["reuse_ratio"] > 0.5


def test_unequal_prompts_reproduce_the_shared_index(model):
    prompts = _prompts(2, [5, 11])
    reqs, _ = _serve_both(model, prompts, max_new=8, num_slots=2, max_len=40)
    # the 11-token prompt sets the index: its stream is direct generation;
    # the 5-token prompt decodes at positions 11.. over zero rows 5..10
    assert reqs[1].out == _direct(model, prompts[1], 8)
    assert reqs[0].out != _direct(model, prompts[0], 8)
    assert reqs[0].out[0] == _direct(model, prompts[0], 8)[0]  # prefill


def test_more_requests_than_slots(model):
    prompts = _prompts(3, [6, 9, 4, 7, 5])
    reqs, stats = _serve_both(model, prompts, max_new=4, num_slots=2,
                              max_len=24)
    assert all(len(r.out) == 4 for r in reqs)
    assert stats["ticks"] >= 3 * 3  # three waves of three decode ticks


def test_prompt_of_max_len_tokens_matches_jax(model):
    """A prompt of exactly max_len tokens: the first decode runs at index
    max_len, past the cache; both engines clamp its K/V write to the last
    row and serve it."""
    prompts = _prompts(4, [16, 16])
    reqs, stats = _serve_both(model, prompts, max_new=4, num_slots=2,
                              max_len=16)
    assert all(len(r.out) == 2 for r in reqs)  # the prefill's and one decode
    assert stats["ticks"] == 1


def test_cuda_engine_rejects_head_dims_the_kernels_do_not_take():
    """B6's kernels take head_dim 64 and 128; a CUDA engine says so when
    it is built, not at its first launch (no card is needed to see it)."""
    cfg = t_registry.get_reduced(ARCH)
    assert cfg.head_dim == 128  # REDUCED keeps the full width's head_dim
    odd = cfg.with_(head_dim=16)
    params = t_lm.init_params(odd, device="cpu")
    with pytest.raises(ValueError, match="head_dim 16"):
        ServeEngine(odd, params, num_slots=1, max_len=8, device="cuda")
    ServeEngine(odd, params, num_slots=1, max_len=8, device="cpu")
    # a supported head_dim passes the check and meets the next one
    with pytest.raises(ValueError, match="params on cpu"):
        ServeEngine(cfg, t_lm.init_params(cfg, device="cpu"), num_slots=1,
                    max_len=8, device="cuda")
