"""LM serving engine: fixed-slot continuous batching with prefill on
admission and one batched decode step per tick (port of
``repro.serve.engine``, line for line in its semantics).

Each tick fills the free slots (one prefill per request, its greedy token
taken from the prefill's logits), then decodes every slot at ONE shared
position, ``index = max(slot_pos[active])``. That is the reference's rule,
kept here: a slot whose prompt is shorter than the longest active one
writes its new K/V and takes its RoPE position at that index, and attends
to the zero rows in between, so its tokens can differ from the same
prompt's direct greedy generation (``ROADMAP.md``, reference caveats).
A request is done at ``max_new`` tokens or when its slot reaches
``max_len - 1``.

A request carries tokens only, as the reference's does: a VLM is served
text-only (no image prefix), and an encoder-decoder, whose prefill needs
frame embeddings, is refused at construction (the reference's engine
builds and then fails at its first admission); its entry points are
``lm.make_prefill_step`` and ``lm.make_decode_step``.

The caches are per layer, from ``lm.cache_init``: an attention layer's
KV cache ``[num_slots, KVH, width, D]`` (width ``max_len``, or
``min(local_window, max_len)`` for a local-attention layer), or a
recurrent layer's state (Mamba, mLSTM, sLSTM) with ``num_slots`` rows.
They are written in place on the current stream: a prefill's cache or
state (one row, its layer's width) is copied into its slot's row, a
decode writes its K/V row or copies each new state into its tensors.
Inactive slots decode token 0 at the shared index, as the reference's
do; their recurrent state is overwritten at their next admission. ``reuse_ratio`` is the share of
attention context served from the cache rather than recomputed.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import lm
from repro_torch.utils import DeviceLike, resolve_device


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [P] int32
    max_new: int = 16
    out: List[int] = field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Fixed-slot continuous batching (decode batch = num_slots). Runs on
    ``device`` (default: the CUDA card; raises without one), where
    ``params`` must lie. On a CUDA device a model with an attention layer
    must have ``cfg.head_dim`` in ``flash_attention.HEAD_DIMS`` (a
    ValueError here, not at the first launch); an attention-free model
    (xlstm) launches no kernel and has no such rule."""

    def __init__(self, cfg: ModelConfig, params, num_slots: int = 4,
                 max_len: int = 256, device: DeviceLike = None):
        if cfg.encoder_layers > 0:
            raise ValueError(
                f"{cfg.name}: an encoder-decoder's prefill reads "
                "batch['frame_embeds'], which the engine's requests do not "
                "carry (the reference's engine raises KeyError at its first "
                "admission); serve it with lm.make_prefill_step and "
                "make_decode_step")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and any(
                spec.mixer == "attn" for spec in cfg.layer_pattern):
            fa.check_head_dim(cfg.head_dim)  # B6's kernels take these
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params on {params['embed'].device}, engine "
                             f"on {self.device}")
        self.cfg = cfg
        self.params = params
        self.num_slots = num_slots
        self.max_len = max_len
        self.prefill = lm.make_prefill_step(cfg, cache_len=max_len)
        self.decode = lm.make_decode_step(cfg)
        self.caches = lm.cache_init(cfg, num_slots, max_len, self.device)
        self.slot_req: List[Optional[Request]] = [None] * num_slots
        self.slot_pos = np.zeros(num_slots, np.int32)
        self.queue: List[Request] = []
        self.tokens_computed = 0  # fresh token positions run through the model
        self.tokens_served_from_cache = 0  # context positions reused per step

    def _assign(self, req: Request, slot: int) -> None:
        tokens = torch.as_tensor(np.asarray(req.prompt, np.int64)[None, :],
                                 device=self.device)
        logits, caches = self.prefill(self.params, {"tokens": tokens})
        for dst, src in zip(self.caches, caches):  # each layer's cache
            for d, s in zip(dst, src):  # every tensor, whatever the mixer
                d[slot:slot + 1].copy_(s)
        req.out.append(int(torch.argmax(logits[0])))
        self.slot_req[slot] = req
        self.slot_pos[slot] = len(req.prompt)
        self.tokens_computed += len(req.prompt) + 1

    def submit(self, requests: List[Request]) -> None:
        self.queue = list(requests)

    def step(self) -> bool:
        """One engine tick: fill free slots (prefill), one decode step for
        all active slots. Returns False when no work remains."""
        for slot in range(self.num_slots):
            if self.slot_req[slot] is None and self.queue:
                self._assign(self.queue.pop(0), slot)
        active = [s for s in range(self.num_slots) if self.slot_req[s]]
        if not active:
            return bool(self.queue)

        tokens = np.zeros((self.num_slots, 1), np.int64)
        for s in active:
            tokens[s, 0] = self.slot_req[s].out[-1]
        index = int(self.slot_pos[active].max())
        logits, self.caches = self.decode(
            self.params, self.caches,
            torch.as_tensor(tokens, device=self.device), index)
        nxt = torch.argmax(logits, -1).cpu().numpy()
        for s in active:
            req = self.slot_req[s]
            req.out.append(int(nxt[s]))
            self.slot_pos[s] += 1
            self.tokens_computed += 1
            self.tokens_served_from_cache += int(self.slot_pos[s])
            if len(req.out) >= req.max_new or \
                    self.slot_pos[s] >= self.max_len - 1:
                req.done = True
                self.slot_req[s] = None
        return True

    def run(self, requests: List[Request], max_ticks: int = 1000
            ) -> Dict[str, float]:
        self.submit(requests)
        ticks = 0
        while self.step() or any(self.slot_req):
            ticks += 1
            if ticks > max_ticks:
                break
        total_ctx = self.tokens_served_from_cache + self.tokens_computed
        return {
            "ticks": ticks,
            "tokens_computed": self.tokens_computed,
            "reuse_ratio": self.tokens_served_from_cache / max(total_ctx, 1),
        }
