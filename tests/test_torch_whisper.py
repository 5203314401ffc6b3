"""The port's encoder-decoder (the audio family, whisper-small) against the
JAX package on the same numpy inputs and weights: ``cross_attn`` (kernel
route and training route) and ``encode_cross_kv``, the encoder as
training runs it (``encode``) and as a prefill runs it
(``encode_prefill``), whisper-reduced's prefill logits and every cache
leaf (self K/V and cross K/V), 8 greedy decode steps, ``loss_fn`` and
every grad leaf, the weight and AdamW-state conversion, the init's
element count against the reference's (the accounting's gap, ROADMAP.md
caveat 6), the caches' layout, a bfloat16 model on the pipeline's float32
stub frames (the reference's dtype promotion), a 6-step ``Trainer`` run of
each package and the ``ServeEngine``'s refusal where the reference's
engine raises.

Tolerances: the layers at atol / rtol 1e-5 (float32 sums in another
order); logits and caches at 1e-4 (``test_torch_lm.py``'s); greedy tokens
equal; the loss at rtol 1e-5 and each grad leaf at rtol 1e-4 + atol
1e-5 x its largest magnitude (``test_torch_lm_train.py``'s); the bfloat16
logits at 2e-2 of their largest magnitude (a few bfloat16 steps); the
Trainers' losses at rtol 1e-5 (``test_torch_trainer.py``'s); the
conversion bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.data import pipeline as j_pipeline
from repro.models import attention as j_attn
from repro.models import lm as j_lm
from repro.optim import adamw_init as j_adamw_init
from repro.serve import engine as j_engine
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch import convert
from repro_torch.configs import registry as t_registry
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.models import attention as t_attn
from repro_torch.models import lm as t_lm
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw import tree_flatten
from repro_torch.serve import Request, ServeEngine
from repro_torch.train.trainer import Trainer, TrainerConfig

ARCH = "whisper-small"
TOL = dict(atol=1e-5, rtol=1e-5)
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


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def _batch(j_cfg, b, s, seed):
    """make_batch's stubs at the config's widths: tokens, targets and
    frame embeddings [b, enc_seq_len, D] (float32)."""
    return make_batch(DataConfig(
        vocab_size=j_cfg.vocab_size, seq_len=s, global_batch=b, seed=seed,
        enc_seq_len=j_cfg.enc_seq_len, d_model=j_cfg.d_model), 0)


def _cross_layer(params):
    """Decoder layer 0's cross-attention params, numpy."""
    return {k: v[0] for k, v in params["blocks"][0]["cross"].items()}


@pytest.mark.parametrize("flash", [True, False],
                         ids=["kernel-route", "training-route"])
def test_cross_attn_and_encode_cross_kv_match_jax(flash):
    """The cross K/V of encoder states [2, 16, D], then cross-attention of
    9 decoder rows over them; the kernel route (B6's plain version here)
    and the training route (``_sdpa``) alike."""
    t_cfg, j_cfg = _cfgs()
    cross = _cross_layer(_lm_params(j_cfg, 1))
    assert set(cross) == {"wq", "wk", "wv", "wo"}  # no QKV bias
    rng = np.random.default_rng(2)
    enc = rng.standard_normal((2, j_cfg.enc_seq_len, j_cfg.d_model)) \
        .astype(np.float32)
    x = rng.standard_normal((2, 9, j_cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, cross)
    tp = {k: torch.from_numpy(v.copy()) for k, v in cross.items()}
    j_kv = j_attn.encode_cross_kv(jp, jnp.asarray(enc), j_cfg)
    t_kv = t_attn.encode_cross_kv(tp, torch.from_numpy(enc), t_cfg)
    assert tuple(t_kv.k.shape) == (2, t_cfg.num_kv_heads, t_cfg.enc_seq_len,
                                   t_cfg.head_dim)
    _close(t_kv.k, j_kv.k)
    _close(t_kv.v, j_kv.v)
    _close(t_attn.cross_attn(tp, torch.from_numpy(x), t_kv, t_cfg,
                             flash=flash),
           j_attn.cross_attn(jp, jnp.asarray(x), j_kv, j_cfg))


@pytest.mark.parametrize("form", ["encode", "encode_prefill"])
def test_encoder_matches_jax(form):
    """Both of the port's encoders (training's blocked attention, the
    prefill's B6) against the reference's ``encode`` on make_batch's stub
    frames."""
    t_cfg, j_cfg = _cfgs()
    params = _lm_params(j_cfg, 3)
    frames = _batch(j_cfg, 2, 8, 4)["frame_embeds"]
    want = j_lm.encode(jax.tree.map(jnp.asarray, params),
                       jnp.asarray(frames), j_cfg)
    got = getattr(t_lm, form)(
        convert.lm_params_from_numpy(t_cfg, params, device="cpu"),
        torch.from_numpy(frames), t_cfg)
    assert got.shape == (2, t_cfg.enc_seq_len, t_cfg.d_model)
    _close(got, want)


def _caches_close(t_caches, j_caches, tol):
    """Every layer's (self K/V, cross K/V) against the reference's
    [periods, ...] stack."""
    (j_self, j_cross), = j_caches
    for i, (self_kv, cross_kv) in enumerate(t_caches):
        for got, want in ((self_kv, j_self), (cross_kv, j_cross)):
            _close(got.k, want.k[i], **tol)
            _close(got.v, want.v[i], **tol)


def test_prefill_caches_and_greedy_decode_match_jax():
    """Prompt 11 with 16 stub frames, cache_len 24: prefill logits and
    every cache leaf, then 8 greedy decode steps (each step's token the
    argmax of the last logits), every step's logits and token, and the
    caches after."""
    t_cfg, j_cfg = _cfgs()
    params = _lm_params(j_cfg, 5)
    tparams = convert.lm_params_from_numpy(t_cfg, params, device="cpu")
    jparams = jax.tree.map(jnp.asarray, params)
    batch = _batch(j_cfg, 2, 11, 6)
    b, s, cache_len = 2, 11, 24
    j_logits, j_caches = j_lm.make_prefill_step(j_cfg, cache_len)(
        jparams, {k: jnp.asarray(batch[k]) for k in ("tokens",
                                                     "frame_embeds")})
    t_logits, t_caches = t_lm.make_prefill_step(t_cfg, cache_len)(
        tparams, {k: torch.from_numpy(batch[k]) for k in ("tokens",
                                                          "frame_embeds")})
    _close(t_logits, j_logits, **LOGIT_TOL)
    assert tuple(t_caches[0][0].k.shape) == (b, t_cfg.num_kv_heads,
                                             cache_len, t_cfg.head_dim)
    _caches_close(t_caches, j_caches, LOGIT_TOL)
    cross_before = [c[1].k.clone() for c in t_caches]
    j_decode, t_decode = j_lm.make_decode_step(j_cfg), \
        t_lm.make_decode_step(t_cfg)
    j_tok = np.asarray(jnp.argmax(j_logits, -1))[:, None].astype(np.int32)
    t_tok = torch.argmax(t_logits, -1)[:, None]
    for index in range(s, s + 8):
        assert np.array_equal(t_tok.numpy(), j_tok)
        j_logits, j_caches = j_decode(jparams, j_caches, jnp.asarray(j_tok),
                                      jnp.asarray(index, jnp.int32))
        t_logits, t_caches = t_decode(tparams, t_caches, t_tok, index)
        _close(t_logits, j_logits, **LOGIT_TOL)
        j_tok = np.asarray(jnp.argmax(j_logits, -1))[:, None].astype(
            np.int32)
        t_tok = torch.argmax(t_logits, -1)[:, None]
    assert np.array_equal(t_tok.numpy(), j_tok)
    _caches_close(t_caches, j_caches, LOGIT_TOL)
    # the cross K/V are read, never written, by the decode steps
    assert all(torch.equal(c[1].k, k) for c, k in zip(t_caches,
                                                      cross_before))


def test_loss_fn_and_grads_match_jax():
    """2 x 24 tokens over 16 stub frames: ce, the loss and every grad leaf
    (the encoder's, each decoder layer's cross-attention and norm_x)."""
    t_cfg, j_cfg = _cfgs(q_block=8, loss_chunk=8)
    params = _lm_params(j_cfg, 7)
    batch = _batch(j_cfg, 2, 24, 8)
    (j_loss, j_m), j_grads = jax.value_and_grad(j_lm.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()}, j_cfg)
    tparams = convert.lm_params_from_numpy(t_cfg, params, device="cpu")
    t_loss, t_m, t_grads = t_lm.loss_and_grads(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()}, t_cfg)
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
    enc_grads = t_grads["encoder"]["layers"][0]["mixer"]["wq"]
    assert float(enc_grads.abs().max()) > 0  # the encoder is trained


def _paths(tree, prefix=()):
    """{path: leaf} of a nested dict / list / tuple."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_paths(v, (*prefix, k)))
    return out


def _reference_path(path, period):
    """A port leaf's path -> the reference's path and stack index."""
    if path[0] == "layers":
        return ("blocks", path[1] % period, *path[2:]), path[1] // period
    if path[0] == "encoder" and path[1] == "layers":
        return ("encoder", "blocks", 0, *path[3:]), path[2]
    return path, None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_carries_every_leaf_bit_for_bit(dtype):
    """lm_params_from_numpy and lm_opt_state_from_numpy: every leaf of the
    port's tree (the encoder's layers and final norm, each decoder
    layer's cross and norm_x included) equals the reference's leaf at its
    path, bit for bit, and no reference leaf is left over."""
    t_cfg, j_cfg = _cfgs(dtype=dtype, num_layers=3, encoder_layers=2)
    params = jax.tree.map(np.asarray, j_lm.init_params(j_cfg,
                                                       jax.random.key(9)))
    opt = jax.tree.map(lambda a: np.asarray(a) + 1.0,
                       j_adamw_init(params))
    for tree, got in ((params, convert.lm_params_from_numpy(
            t_cfg, params, device="cpu")),) + tuple(
            (opt[k], convert.lm_opt_state_from_numpy(
                t_cfg, opt, device="cpu")[k]) for k in ("m", "v")):
        leaves = _paths(got)
        stacked = (jax.tree.leaves(tree["blocks"])
                   + jax.tree.leaves(tree["encoder"]["blocks"]))
        assert len(leaves) == len(jax.tree.leaves(tree)) - len(stacked) \
            + sum(a.shape[0] for a in stacked)
        assert any(p[0] == "encoder" for p in leaves)
        assert any("cross" in p for p in leaves)
        for path, leaf in leaves.items():
            ref_path, idx = _reference_path(path, t_cfg.period)
            want = tree
            for k in ref_path:
                want = want[k]
            want = want if idx is None else want[idx]
            want = np.asarray(want)
            if want.dtype.name == "bfloat16":
                assert leaf.dtype == torch.bfloat16
                np.testing.assert_array_equal(
                    leaf.view(torch.int16).numpy(),
                    want.view(np.int16))
            else:
                assert leaf.dtype == torch.float32
                np.testing.assert_array_equal(leaf.numpy(), want)


def test_init_element_count_is_the_references_with_the_accountings_gap():
    """The port's init makes as many elements as the reference's (the full
    config by ``jax.eval_shape``, the reduced one drawn); both exceed
    ``param_count()`` by each decoder layer's norm_x and the encoder's
    final norm, (num_layers + 1) x d_model: 9,984 at full width."""
    for t_cfg, j_cfg in ((t_registry.get(ARCH), j_registry.get(ARCH)),
                         _cfgs()):
        shapes = jax.eval_shape(lambda: j_lm.init_params(j_cfg,
                                                         jax.random.key(0)))
        j_n = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
        assert j_n - j_cfg.param_count() == (j_cfg.num_layers + 1) \
            * j_cfg.d_model
        assert t_cfg.param_count() == j_cfg.param_count()
        if t_cfg.name == ARCH:
            assert j_n == 334_516_224 and j_n - t_cfg.param_count() == 9_984
            continue
        p = t_lm.init_params(t_cfg, torch.Generator().manual_seed(0), "cpu")
        assert sum(t.numel() for t in tree_flatten(p)[0]) == j_n
        assert abs(float(p["encoder"]["layers"][0]["mixer"]["wq"].std())
                   - t_cfg.d_model**-0.5) < 0.15 * t_cfg.d_model**-0.5


def test_cache_init_pairs_each_layer_with_zero_cross_kv():
    """``cache_init``: each layer's (self K/V, cross K/V), shaped as the
    reference's (cross rows ``enc_seq_len``; 1 when the config has
    none), zeros."""
    for kw in ({}, dict(enc_seq_len=0)):
        t_cfg, j_cfg = _cfgs(**kw)
        (j_self, j_cross), = j_lm.cache_init(j_cfg, 3, 20)
        caches = t_lm.cache_init(t_cfg, 3, 20, device="cpu")
        assert len(caches) == t_cfg.num_layers
        for self_kv, cross_kv in caches:
            assert tuple(self_kv.k.shape) == j_self.k.shape[1:]
            assert tuple(cross_kv.v.shape) == j_cross.v.shape[1:]
            assert not any(bool(t.any()) for t in (*self_kv, *cross_kv))


def test_bfloat16_model_on_float32_stub_frames_matches_jax():
    """A bfloat16 whisper-reduced on make_batch's float32 frames: the
    reference promotes the encoder to float32 (float32 activations against
    bfloat16 weights) and keeps the decoder in bfloat16; so does the port.
    Prefill logits and two decode steps' within 2e-2 of their largest
    magnitude; the cross K/V come out float32, the self K/V bfloat16."""
    t_cfg, j_cfg = _cfgs(dtype="bfloat16")
    params = _lm_params(j_cfg, 10)
    tparams = convert.lm_params_from_numpy(t_cfg, params, device="cpu")
    jparams = jax.tree.map(jnp.asarray, params)
    batch = _batch(j_cfg, 2, 9, 11)
    j_logits, j_caches = j_lm.make_prefill_step(j_cfg, 16)(
        jparams, {k: jnp.asarray(batch[k]) for k in ("tokens",
                                                     "frame_embeds")})
    t_logits, t_caches = t_lm.make_prefill_step(t_cfg, 16)(
        tparams, {k: torch.from_numpy(batch[k]) for k in ("tokens",
                                                          "frame_embeds")})
    assert t_caches[0][0].k.dtype == torch.bfloat16
    assert t_caches[0][1].k.dtype == torch.float32 == \
        getattr(torch, str(j_caches[0][1].k.dtype))
    scale = float(np.abs(np.asarray(j_logits)).max())
    _close(t_logits, j_logits, atol=2e-2 * scale, rtol=0)
    tok = np.array([[1], [2]], np.int32)
    for index in (9, 10):
        j_logits, j_caches = j_lm.make_decode_step(j_cfg)(
            jparams, j_caches, jnp.asarray(tok), jnp.asarray(index,
                                                             jnp.int32))
        t_logits, t_caches = t_lm.make_decode_step(t_cfg)(
            tparams, t_caches, torch.from_numpy(tok), index)
        _close(t_logits, j_logits, atol=2e-2 * scale, rtol=0)


class _FromReferenceInit(Trainer):
    """Starts from the reference's initial params (converted), not the
    port's own draw."""

    np_params = None

    def init_state(self, seed: int = 0):
        params = convert.lm_params_from_numpy(self.cfg, self.np_params,
                                              device=self.device)
        return params, adamw_init(params)


def test_trainer_matches_the_reference_trainer(tmp_path):
    """6 steps of each package's Trainer on the pipeline's batches with
    their frame stubs (as ``examples/train_lm.py`` builds the data config),
    from the same initial params: the losses within rtol 1e-5."""
    t_cfg, j_cfg = _cfgs()
    stubs = dict(enc_seq_len=j_cfg.enc_seq_len, d_model=j_cfg.d_model)
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


def test_serve_engine_refuses_an_encoder_decoder_the_reference_cannot_serve():
    """The reference's engine builds for whisper and raises KeyError at
    its first admission (its requests carry no frame embeddings); the
    port's refuses the config at construction and says why."""
    t_cfg, j_cfg = _cfgs()
    params = _lm_params(j_cfg, 12)
    prompt = np.arange(5, dtype=np.int32)
    j_eng = j_engine.ServeEngine(j_cfg, jax.tree.map(jnp.asarray, params),
                                 num_slots=1, max_len=16)
    with pytest.raises(KeyError, match="frame_embeds"):
        j_eng.run([j_engine.Request(rid=0, prompt=prompt, max_new=2)])
    with pytest.raises(ValueError, match="frame_embeds"):
        ServeEngine(t_cfg, convert.lm_params_from_numpy(
            t_cfg, params, device="cpu"), num_slots=1, max_len=16,
            device="cpu")
