"""The port's VLM (internvl2-1b: a prefix of stub patch embeddings before
the text, tied embeddings) against the JAX package on the same numpy
inputs and weights: internvl2-reduced's prefill with the image prefix
(logits and every cache leaf; the prefix at RoPE positions 0..P-1, the
text after it), 8 greedy decode steps from index P + S, ``loss_fn`` on
the text positions and every grad leaf, the weight conversion, the init's
element count, both ``ServeEngine``s serving it text-only, a 6-step
``Trainer`` run of each package on the pipeline's image stubs, and a
bfloat16 model.

Tolerances as ``test_torch_whisper.py``'s: logits and caches at 1e-4,
greedy tokens, streams and stats equal, the loss at rtol 1e-5 and each
grad leaf at rtol 1e-4 + atol 1e-5 x its largest magnitude, the
Trainers' losses at rtol 1e-5, bfloat16 logits at 2e-2 of their largest
magnitude, the conversion bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.data import pipeline as j_pipeline
from repro.models import lm as j_lm
from repro.serve import engine as j_engine
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch import convert
from repro_torch.configs import registry as t_registry
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.models import lm as t_lm
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw import tree_flatten
from repro_torch.serve import Request, ServeEngine
from repro_torch.train.trainer import Trainer, TrainerConfig

ARCH = "internvl2-1b"
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-5, 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    return (t_registry.get_reduced(ARCH).with_(**kw),
            j_registry.get_reduced(ARCH).with_(**kw))


def _lm_params(j_cfg, seed):
    return jax.tree.map(np.asarray, j_lm.init_params(j_cfg,
                                                     jax.random.key(seed)))


def _close(got, want, of_max=None, **tol):
    """allclose at ``tol``; with ``of_max``, at atol ``of_max`` x the
    largest magnitude of ``want`` instead."""
    want = np.asarray(want, np.float32)
    if of_max is not None:
        tol = dict(atol=of_max * float(np.abs(want).max()), rtol=0)
    np.testing.assert_allclose(got.detach().float().numpy(), want, **tol)


def _batch(j_cfg, b, s, seed):
    """make_batch's stubs at the config's widths: tokens, targets and
    image embeddings [b, num_image_tokens, D] (float32)."""
    return make_batch(DataConfig(
        vocab_size=j_cfg.vocab_size, seq_len=s, global_batch=b, seed=seed,
        num_image_tokens=j_cfg.num_image_tokens, d_model=j_cfg.d_model), 0)


def _greedy_run(t_cfg, j_cfg, params, batch, cache_len, steps, tol):
    """Prefill ``batch`` (tokens and image embeddings) in both packages,
    then ``steps`` greedy decode steps from index P + S: every step's
    logits within ``tol`` and tokens equal; every cache leaf after the
    prefill and at the end. Returns the port's tokens."""
    tparams = convert.lm_params_from_numpy(t_cfg, params, device="cpu")
    jparams = jax.tree.map(jnp.asarray, params)
    keys = ("tokens", "image_embeds")
    j_logits, j_caches = j_lm.make_prefill_step(j_cfg, cache_len)(
        jparams, {k: jnp.asarray(batch[k]) for k in keys})
    t_logits, t_caches = t_lm.make_prefill_step(t_cfg, cache_len)(
        tparams, {k: torch.from_numpy(batch[k]) for k in keys})
    _close(t_logits, j_logits, **tol)

    def caches_close():
        for i, c in enumerate(t_caches):
            _close(c.k, j_caches[0].k[i], **tol)
            _close(c.v, j_caches[0].v[i], **tol)

    caches_close()
    j_decode, t_decode = j_lm.make_decode_step(j_cfg), \
        t_lm.make_decode_step(t_cfg)
    start = t_cfg.num_image_tokens + batch["tokens"].shape[1]
    tokens = []
    for index in range(start, start + steps):
        j_tok = np.asarray(jnp.argmax(j_logits, -1))[:, None].astype(
            np.int32)
        t_tok = torch.argmax(t_logits, -1)[:, None]
        assert np.array_equal(t_tok.numpy(), j_tok)
        tokens.append(t_tok)
        j_logits, j_caches = j_decode(jparams, j_caches, jnp.asarray(j_tok),
                                      jnp.asarray(index, jnp.int32))
        t_logits, t_caches = t_decode(tparams, t_caches, t_tok, index)
        _close(t_logits, j_logits, **tol)
    caches_close()
    return tokens


def test_image_prefix_prefill_and_greedy_decode_match_jax():
    """8 stub patch embeddings + 11 tokens, cache_len 32: prefill logits
    and every cache leaf (the prefix's rows first), 8 greedy decode steps
    from index 19."""
    t_cfg, j_cfg = _cfgs()
    params = _lm_params(j_cfg, 1)
    assert "head" not in params and t_cfg.tie_embeddings
    batch = _batch(j_cfg, 2, 11, 2)
    assert batch["image_embeds"].shape == (2, 8, j_cfg.d_model)
    tokens = _greedy_run(t_cfg, j_cfg, params, batch, 32, 8, LOGIT_TOL)
    assert len(tokens) == 8


def test_bfloat16_model_with_an_image_prefix_matches_jax():
    """A bfloat16 internvl2-reduced (the float32 image stubs cast to
    bfloat16 before the text, as the reference casts them): prefill and 3
    decode steps, logits and cache leaves within 2e-2 of their largest
    magnitude and greedy tokens equal."""
    t_cfg, j_cfg = _cfgs(dtype="bfloat16")
    params = _lm_params(j_cfg, 3)
    batch = _batch(j_cfg, 2, 9, 4)
    _greedy_run(t_cfg, j_cfg, params, batch, 24, 3, dict(of_max=2e-2))


def test_loss_fn_on_text_positions_and_grads_match_jax():
    """2 x (8 image + 24 text) positions: the loss reads the text
    positions only; ce, the loss and every grad leaf (the tied
    embedding's gradient from both its uses)."""
    t_cfg, j_cfg = _cfgs(q_block=16, loss_chunk=8)
    params = _lm_params(j_cfg, 5)
    batch = _batch(j_cfg, 2, 24, 6)
    (j_loss, j_m), j_grads = jax.value_and_grad(j_lm.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()}, j_cfg)
    tparams = convert.lm_params_from_numpy(t_cfg, params, device="cpu")
    t_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    t_loss, t_m, t_grads = t_lm.loss_and_grads(tparams, t_batch, t_cfg)
    for got, want in ((t_loss, j_loss), (t_m["ce"], j_m["ce"])):
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    want = tree_flatten(convert.lm_params_from_numpy(
        t_cfg, jax.tree.map(np.asarray, j_grads), device="cpu"))[0]
    got = tree_flatten(t_grads)[0]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        w = w.numpy()
        np.testing.assert_allclose(
            g.numpy(), w, rtol=GRAD_RTOL,
            atol=GRAD_ATOL_OF_MAX * float(np.abs(w).max()),
            err_msg=f"grad leaf {i} {w.shape}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_carries_every_leaf_bit_for_bit(dtype):
    """Every leaf of the converted params equals the reference's leaf of
    that layer, bit for bit; the tied model has no head; the port's init
    makes the reference init's element count and leaf dtypes."""
    t_cfg, j_cfg = _cfgs(dtype=dtype, num_layers=4)
    params = _lm_params(j_cfg, 7)
    got = convert.lm_params_from_numpy(t_cfg, params, device="cpu")
    assert set(got) == {"embed", "layers", "final_norm"}
    bits = {torch.float32: (torch.int32, np.int32),
            torch.bfloat16: (torch.int16, np.int16)}
    for i, layer in enumerate(got["layers"]):
        want = jax.tree.map(lambda a: np.asarray(a)[i],
                            params["blocks"][0])
        for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                                tree_flatten(layer)[0]):
            t_bits, n_bits = bits[g.dtype]
            np.testing.assert_array_equal(g.view(t_bits).numpy(),
                                          np.asarray(w).view(n_bits),
                                          err_msg=str(path))
    init = t_lm.init_params(t_cfg, torch.Generator().manual_seed(0), "cpu")
    assert sum(t.numel() for t in tree_flatten(init)[0]) == sum(
        a.size for a in jax.tree.leaves(params)) == t_cfg.param_count()
    assert {t.dtype for t in tree_flatten(init)[0]} == {
        t.dtype for t in tree_flatten(got)[0]}


def test_serve_engine_text_only_matches_jax():
    """Both engines on the same weights and prompts (no image prefix: the
    engines' requests carry tokens only), slots reused at unequal
    positions: equal token streams and stats."""
    t_cfg, j_cfg = _cfgs()
    params = _lm_params(j_cfg, 9)
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, j_cfg.vocab_size, size=n).astype(np.int32)
               for n in (13, 5, 9)]
    j_reqs = [j_engine.Request(rid=i, prompt=p, max_new=6)
              for i, p in enumerate(prompts)]
    j_stats = j_engine.ServeEngine(j_cfg, jax.tree.map(jnp.asarray, params),
                                   num_slots=2, max_len=24).run(j_reqs)
    t_reqs = [Request(rid=i, prompt=p, max_new=6)
              for i, p in enumerate(prompts)]
    t_stats = ServeEngine(t_cfg, convert.lm_params_from_numpy(
        t_cfg, params, device="cpu"), num_slots=2, max_len=24,
        device="cpu").run(t_reqs)
    assert t_stats == j_stats
    assert [r.out for r in t_reqs] == [r.out for r in j_reqs]
    assert all(r.done and len(r.out) == 6 for r in t_reqs)


class _FromReferenceInit(Trainer):
    """Starts from the reference's initial params (converted)."""

    np_params = None

    def init_state(self, seed: int = 0):
        params = convert.lm_params_from_numpy(self.cfg, self.np_params,
                                              device=self.device)
        return params, adamw_init(params)


def test_trainer_matches_the_reference_trainer(tmp_path):
    """6 steps of each package's Trainer on the pipeline's batches with
    their image stubs, from the same initial params: the losses within
    rtol 1e-5."""
    t_cfg, j_cfg = _cfgs()
    stubs = dict(num_image_tokens=j_cfg.num_image_tokens,
                 d_model=j_cfg.d_model)
    kw = dict(ckpt_every=100, base_lr=1e-3, warmup=2, total_steps=20)
    j_out = JTrainer(j_cfg, j_pipeline.DataConfig(j_cfg.vocab_size, 16, 4,
                                                  **stubs),
                     JTrainerConfig(ckpt_dir=str(tmp_path / "j"), **kw)).run(
        steps=6, resume=False)
    _FromReferenceInit.np_params = _lm_params(j_cfg, 0)
    t_out = _FromReferenceInit(
        t_cfg, DataConfig(t_cfg.vocab_size, 16, 4, **stubs),
        TrainerConfig(ckpt_dir=str(tmp_path / "t"), **kw),
        device="cpu").run(steps=6, resume=False)
    assert t_out["final_step"] == j_out["final_step"] == 6
    np.testing.assert_allclose(t_out["losses"], j_out["losses"],
                               rtol=LOSS_RTOL)
