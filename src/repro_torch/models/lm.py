"""Top-level LM (port of ``repro.models.lm``): parameters, the training
loss and train step, and the serving entry points (prefill and decode
steps, KV caches).

Parameters are a dict ``{"embed" [V, D], "layers": [one dict per layer],
"final_norm", "head" [D, V] (absent when the embeddings are tied)}``; an
encoder-decoder (``cfg.encoder_layers > 0``, the audio family) also has
``"encoder": {"layers", "final_norm"}``, and each of its decoder layers a
cross-attention (``"norm_x"``, ``"cross"``). The caches are one per layer,
each its mixer's (:data:`blocks.Cache`): an attention layer's KV cache or
a recurrent layer's state; an encoder-decoder's paired with the layer's
encoder K/V.

The frontends are the reference's stubs: an encoder-decoder reads
precomputed frame embeddings ``batch["frame_embeds"] [B, T, D]``
(:func:`encode`), a VLM (``cfg.num_image_tokens > 0``) takes precomputed
patch embeddings ``batch["image_embeds"] [B, P, D]`` as a prefix before
the text (RoPE positions ``0..P-1``, the text after them; the loss reads
the text positions only). The encoder runs in the wider of the frame
embeddings' dtype and the model's, as the reference's promotes.

Training: :func:`loss_fn` is the backbone (:func:`blocks.stack_train`)
and the chunked cross-entropy (:func:`chunked_ce`: the head matmul and
``logsumexp`` one sequence chunk at a time, never all ``[B, S, V]``
logits at once); :func:`make_train_step` takes its gradients with
autograd and updates the params and the AdamW moments in place
(:func:`repro_torch.optim.adamw_update_`), the reference's donated jitted
step. The reference casts the cotangent back to the model's dtype where
the float32 loss meets the backbone (``_grad_dtype_boundary``); torch's
autograd casts every cotangent to its tensor's dtype already, so the
port needs no such boundary. ``loss_fn`` adds ``aux_coef`` times the sum
of the MoE layers' router losses.

A prefill runs every attention through kernel B6 (the encoder's
bidirectional attention, the decoder's causal self-attention and its
cross-attention), training runs plain PyTorch under autograd.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import blocks
from repro_torch.models.common import DP, META, TP, P, dtype_of, ninit, \
    is_dtensor, rmsnorm, rmsnorm_init, rmsnorm_specs, shard
from repro_torch.optim import AdamWConfig, adamw_update_, cosine_warmup
from repro_torch.optim.adamw import tree_flatten
from repro_torch.utils import DeviceLike, resolve_device


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> dict:
    """Random parameters at the reference's scales (``lm.init_params``):
    embeddings N(0, 0.02), projections N(0, fan_in^-1/2), norms 1, QKV
    biases 0, each recurrent mixer's own initializers; every leaf in the
    dtype the reference's init gives it (``cfg.dtype``, or float32 for an
    MoE router and the leaves of ``blocks.FLOAT32_LEAVES``). Drawn from ``generator`` (default: seed 0) on ``device``
    (default: the CUDA card; raises without one)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, params on {dev}")
    return _init(cfg, generator)


def param_shapes(cfg: ModelConfig) -> dict:
    """:func:`init_params`'s tree on the meta device: every leaf's shape
    and dtype and no memory (the twin of ``jax.eval_shape`` of the
    reference's init), so a 400B config costs nothing to lay out."""
    return _init(cfg, META)


def _init(cfg: ModelConfig, generator) -> dict:
    dtype = dtype_of(cfg.dtype)
    cross = cfg.encoder_layers > 0
    p = {"embed": ninit(generator, (cfg.vocab_size, cfg.d_model), 0.02,
                        dtype),
         "layers": [blocks.layer_init(generator, cfg,
                                      blocks.layer_spec(cfg, i), dtype,
                                      cross=cross)
                    for i in range(cfg.num_layers)],
         "final_norm": rmsnorm_init(cfg.d_model, dtype, generator.device)}
    if not cfg.tie_embeddings:
        p["head"] = ninit(generator, (cfg.d_model, cfg.vocab_size),
                          cfg.d_model**-0.5, dtype)
    if cross:
        enc_cfg = _encoder_cfg(cfg)
        p["encoder"] = {
            "layers": [blocks.layer_init(generator, enc_cfg,
                                         enc_cfg.layer_pattern[0], dtype)
                       for _ in range(enc_cfg.num_layers)],
            "final_norm": rmsnorm_init(cfg.d_model, dtype, generator.device)}
    return p


def _encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    """The encoder's own config: ``encoder_layers`` attention layers with a
    dense FFN at the model's widths."""
    return cfg.with_(num_layers=cfg.encoder_layers,
                     layer_pattern=(LayerSpec(mixer="attn", ffn="dense"),),
                     encoder_layers=0)


def param_specs(cfg: ModelConfig) -> dict:
    """The spec tree of :func:`init_params`'s tree: the vocabulary over the
    model axis, one spec tree per layer (:func:`blocks.stack_specs`)."""
    cross = cfg.encoder_layers > 0
    p = {"embed": P(TP, None),
         "layers": blocks.stack_specs(cfg, cross=cross),
         "final_norm": rmsnorm_specs()}
    if not cfg.tie_embeddings:
        p["head"] = P(None, TP)
    if cross:
        p["encoder"] = {"layers": blocks.stack_specs(_encoder_cfg(cfg)),
                        "final_norm": rmsnorm_specs()}
    return p


def opt_specs(cfg: ModelConfig) -> dict:
    """The AdamW moments' specs: each moment laid out as its param."""
    specs = param_specs(cfg)
    return {"m": specs, "v": specs}


def _embed(params, tokens: torch.Tensor) -> torch.Tensor:
    """The token embeddings (the batch constrained over DP). A DTensor
    table is read through ``embedding``, the same rows, whose DTensor rule
    and backward serve a vocabulary split (an index's backward,
    ``index_put``, has none that torch 2.11 can run)."""
    table, ids = params["embed"], tokens.long()
    if is_dtensor(table):
        return shard(torch.nn.functional.embedding(ids, table),
                     P(DP, None, None))
    return shard(table[ids], P(DP, None, None))


def _head(params, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["head"]


def _logits(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Last position's logits: in the model's dtype, then float32 (the
    norm is per position, so only the last one is normed)."""
    x = rmsnorm(params["final_norm"], x[:, -1], cfg.norm_eps)
    return (x @ _head(params, cfg)).float()


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _encoder_params(params, frame_embeds: torch.Tensor, cfg: ModelConfig):
    """The encoder's params, cast to the dtype it runs in: the wider of the
    frame embeddings' and the model's (jnp's promotion of the reference's
    float32 stub frames against bfloat16 weights), and that dtype."""
    dt = torch.promote_types(frame_embeds.dtype, dtype_of(cfg.dtype))
    enc = params["encoder"]
    if dt != dtype_of(cfg.dtype):
        leaves, unflatten = tree_flatten(enc)
        enc = unflatten([t.to(dt) for t in leaves])
    return enc, dt


def encode(params, frame_embeds: torch.Tensor, cfg: ModelConfig
           ) -> torch.Tensor:
    """The encoder over stub frame embeddings [B, T, D] as training runs
    it (bidirectional blocked attention, plain PyTorch under autograd) ->
    normed states [B, T, D]."""
    enc, dt = _encoder_params(params, frame_embeds, cfg)
    x, _ = blocks.stack_train(enc["layers"], frame_embeds.to(dt),
                              _encoder_cfg(cfg), causal=False)
    return rmsnorm(enc["final_norm"], x, cfg.norm_eps)


def encode_prefill(params, frame_embeds: torch.Tensor, cfg: ModelConfig
                   ) -> torch.Tensor:
    """:func:`encode` as a prefill runs it: every layer's attention
    through kernel B6 (``causal=False``)."""
    enc, dt = _encoder_params(params, frame_embeds, cfg)
    x = blocks.stack_encode(enc["layers"], frame_embeds.to(dt),
                            _encoder_cfg(cfg))
    return rmsnorm(enc["final_norm"], x, cfg.norm_eps)


def _embed_with_prefix(params, tokens: torch.Tensor,
                       extra_embeds: Optional[torch.Tensor]) -> torch.Tensor:
    """The token embeddings, after ``extra_embeds`` [B, P, D] (cast to the
    model's dtype) where given."""
    x = _embed(params, tokens)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    return x


def backbone(params, tokens: torch.Tensor, cfg: ModelConfig, *,
             extra_embeds: Optional[torch.Tensor] = None,
             enc_out: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] (after an optional prefix of embeddings [B, P, D]),
    cross-attending to ``enc_out`` where given -> (normed hidden [B, P + S,
    D], auxiliary loss)."""
    x = _embed_with_prefix(params, tokens, extra_embeds)
    x, aux = blocks.stack_train(params["layers"], x, cfg, enc_out=enc_out)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), aux


def chunked_ce(h: torch.Tensor, targets: torch.Tensor, head: torch.Tensor,
               mask: Optional[torch.Tensor] = None, chunk: int = 512
               ) -> torch.Tensor:
    """Mean token cross-entropy, float32, the head matmul and
    ``logsumexp`` one chunk of ``min(chunk, S)`` positions at a time (S
    when that does not divide S). With ``mask`` [B, S] the mean is over
    its weights, the denominator at least 1. DTensor logits split over the
    vocabulary take :func:`_vocab_parallel_nll`."""
    b, s, _ = h.shape
    c = min(chunk, s)
    if s % c != 0:
        c = s
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for start in range(0, s, c):
        # the chunk whole over ``model`` before the vocabulary-split head,
        # where the reference's GSPMD gathers the sequence-split carry
        hc = shard(h[:, start:start + c], P(DP, None, None))
        logits = shard((hc @ head).float(), P(DP, None, TP))
        tx = targets[:, start:start + c].long()
        if _vocab_split(logits):
            nll = _vocab_parallel_nll(logits, tx)
        else:
            lse = torch.logsumexp(logits, dim=-1)
            true = torch.gather(logits, -1, tx[..., None])[..., 0]
            nll = lse - true
        if mask is not None:
            nll = nll * mask[:, start:start + c]
        total = total + nll.sum()
    denom = (mask.sum().float() if mask is not None
             else torch.tensor(float(b * s), dtype=torch.float32))
    return total / torch.clamp(denom, min=1.0)


def _vocab_split(logits: torch.Tensor) -> bool:
    return is_dtensor(logits) and any(p.is_shard(logits.dim() - 1)
                                      for p in logits.placements)


def _vocab_parallel_nll(logits, targets: torch.Tensor) -> torch.Tensor:
    """``logsumexp(logits) - logits[target]`` per position for DTensor
    logits [B, C, V] split over the vocabulary, each rank on its block:
    the row max, the sum of the exponentials and the target's logit (on
    the rank whose block holds it) reduced over the split, the partitioned
    reduction the reference's GSPMD runs. DTensor's own ``logsumexp`` and
    ``gather`` would gather the whole vocabulary on every rank, forward
    and backward. The same arithmetic as ``torch.logsumexp``, its float32
    sums in another order. Returns a DTensor [B, C] whole over the
    vocabulary's axes."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    mesh, pl = logits.device_mesh, list(logits.placements)
    vocab = logits.dim() - 1
    rows = [Replicate() if p.is_shard(vocab) else p for p in pl]

    def reduced(t, op):  # the local [B_l, C] partials summed (or maxed)
        part = [Partial(op) if p.is_shard(vocab) else r
                for p, r in zip(pl, rows)]
        return DTensor.from_local(t, mesh, part, run_check=False).redistribute(
            mesh, rows).to_local()

    if not is_dtensor(targets):  # a plain tensor is every rank's whole
        targets = DTensor.from_local(targets, mesh,
                                     [Replicate()] * mesh.ndim,
                                     run_check=False)
    local = logits.to_local()
    _, off = compute_local_shape_and_global_offset(logits.shape, mesh, pl)
    tx = targets.redistribute(mesh, rows).to_local() - off[vocab]
    mine = (tx >= 0) & (tx < local.shape[-1])
    m = reduced(local.amax(-1).detach(), "max")
    lse = m + torch.log(reduced(torch.exp(local - m[..., None]).sum(-1),
                                "sum"))
    true = torch.gather(local, -1, torch.clamp(tx, 0, local.shape[-1] - 1)
                        [..., None])[..., 0]
    true = reduced(torch.where(mine, true, 0.0), "sum")
    return DTensor.from_local(lse - true, mesh, rows, run_check=False,
                              shape=logits.shape[:-1],
                              stride=(logits.shape[1], 1))


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            aux_coef: float = 0.01) -> Tuple[torch.Tensor, Dict]:
    """(loss, {"ce", "aux"}): the chunked cross-entropy of ``batch
    ["targets"]`` given ``batch["tokens"]`` (weighted by
    ``batch["loss_mask"]`` when present) plus ``aux_coef`` x aux. An
    encoder-decoder encodes ``batch["frame_embeds"]`` first; a batch's
    ``image_embeds`` are a prefix whose positions the loss skips when
    ``cfg.num_image_tokens > 0``."""
    enc_out = None
    if cfg.encoder_layers > 0:
        enc_out = encode(params, batch["frame_embeds"], cfg)
    h, aux = backbone(params, batch["tokens"], cfg,
                      extra_embeds=batch.get("image_embeds"),
                      enc_out=enc_out)
    if cfg.num_image_tokens > 0:
        h = h[:, cfg.num_image_tokens:]  # loss on text positions only
    ce = chunked_ce(h, batch["targets"], _head(params, cfg),
                    mask=batch.get("loss_mask"), chunk=cfg.loss_chunk)
    return ce + aux_coef * aux, {"ce": ce, "aux": aux}


def loss_and_grads(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                   aux_coef: float = 0.01) -> Tuple[torch.Tensor, Dict,
                                                     dict]:
    """(loss, metrics, grads): :func:`loss_fn` and its gradient with
    respect to every leaf of ``params``, in the params' structure and
    dtypes (``jax.value_and_grad(loss_fn, has_aux=True)``). The params are
    not modified and need not require grad."""
    leaves, unflatten = tree_flatten(params)
    with torch.enable_grad():
        xs = [p.detach().requires_grad_(True) for p in leaves]
        loss, metrics = loss_fn(unflatten(xs), batch, cfg, aux_coef)
        grads = torch.autograd.grad(loss, xs)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, unflatten(list(grads))


def make_train_step(cfg: ModelConfig, opt_cfg: Optional[AdamWConfig] = None,
                    base_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10000):
    """``train_step(params, opt_state, batch, step) -> (params, opt_state,
    metrics)``: :func:`loss_and_grads`, the learning rate of
    ``cosine_warmup`` at ``step`` (0-based), then AdamW written into
    ``params`` and ``opt_state`` themselves, which are returned (the
    reference donates them to its jitted step). ``metrics``: ``loss``,
    ``ce``, ``aux`` and ``lr``, as tensors."""
    opt_cfg = opt_cfg or AdamWConfig()

    def train_step(params, opt_state, batch, step):
        loss, metrics, grads = loss_and_grads(params, batch, cfg)
        lr = cosine_warmup(step, base_lr, warmup, total_steps)
        adamw_update_(grads, params, opt_state, step, opt_cfg, lr)
        return params, opt_state, dict(metrics, loss=loss, lr=lr)

    return train_step


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def make_prefill_step(cfg: ModelConfig, cache_len: int):

    def prefill_step(params, batch: Dict[str, torch.Tensor]
                     ) -> Tuple[torch.Tensor, List[blocks.Cache]]:
        """batch["tokens"] [B, S] -> (logits [B, V] float32, caches). An
        encoder-decoder encodes ``batch["frame_embeds"]`` (kernel B6) and
        caches each layer's encoder K/V; a VLM puts ``batch
        ["image_embeds"]`` (where given) before the text, so the next
        decode index is ``P + S``."""
        enc_out = None
        if cfg.encoder_layers > 0:
            enc_out = encode_prefill(params, batch["frame_embeds"], cfg)
        image = batch.get("image_embeds")
        x = _embed_with_prefix(params, batch["tokens"],
                               image if cfg.num_image_tokens > 0 else None)
        x, caches = blocks.stack_prefill(params["layers"], x, cfg, cache_len,
                                         enc_out=enc_out)
        return _logits(params, x, cfg), caches

    return prefill_step


def make_decode_step(cfg: ModelConfig):

    def decode_step(params, caches: List[blocks.Cache], token: torch.Tensor,
                    index: int) -> Tuple[torch.Tensor, List[blocks.Cache]]:
        """token [B, 1]; ``index`` the position decoded (a host int). The
        caches are updated in place and returned."""
        x = _embed(params, token)
        x, caches = blocks.stack_decode(params["layers"], x, cfg, caches,
                                        index)
        return _logits(params, x, cfg), caches

    return decode_step


def cache_init(cfg: ModelConfig, batch: int, s_max: int,
               device: DeviceLike = None) -> List[blocks.Cache]:
    """Zero caches of ``batch`` rows (an encoder-decoder's each paired with
    zero encoder K/V of ``enc_seq_len`` rows) on ``device`` (default: the
    CUDA card; raises without one)."""
    dev = resolve_device(device)
    return blocks.stack_cache_init(cfg, batch, s_max, dtype_of(cfg.dtype),
                                   dev, cross=cfg.encoder_layers > 0)


def cache_specs(cfg: ModelConfig, shard_seq: bool = False) -> list:
    """The spec tree of :func:`cache_init`'s caches, one per layer."""
    return blocks.stack_cache_specs(cfg, cross=cfg.encoder_layers > 0,
                                    shard_seq=shard_seq)
