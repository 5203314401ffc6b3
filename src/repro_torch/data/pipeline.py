"""Deterministic, resumable synthetic token pipeline (port of
``repro.data.pipeline``, numpy only: the same streams, bit for bit).

Every batch is a pure function of (seed, step) — resuming a run at step k
reproduces the exact stream with NO iterator state beyond the step counter
(the checkpoint stores just that integer). Sequences mix three learnable
structures (affine next-token, copy-with-offset, periodic motifs) so small
models show a cleanly decreasing loss in integration tests and examples.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    # frontend stubs
    enc_seq_len: int = 0
    num_image_tokens: int = 0
    d_model: int = 0


def _batch_rng(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))


def make_batch(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """tokens/targets [B, S] int32 (+ stub embeddings when configured)."""
    rng = _batch_rng(cfg, step)
    b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
    kinds = rng.integers(0, 3, size=b)
    toks = np.empty((b, s + 1), np.int64)
    start = rng.integers(0, v, size=b)
    mult = rng.integers(1, 8, size=b)
    add = rng.integers(0, 16, size=b)
    idx = np.arange(s + 1)
    # affine: t_{i+1} = (a * t_i + c) mod v  — closed form via repeated map
    aff = (start[:, None] + np.cumsum(
        np.broadcast_to(add[:, None], (b, s + 1)), axis=1) * mult[:, None])
    toks[:] = aff % v
    # copy task: first half random, second half = first half shifted
    copy_rows = kinds == 1
    if copy_rows.any():
        n = int(copy_rows.sum())
        half = (s + 1) // 2 + 1
        head = rng.integers(0, v, size=(n, half))
        row = np.tile(head, (1, 3))[:, : s + 1]
        toks[copy_rows] = row
    # periodic motif
    per_rows = kinds == 2
    if per_rows.any():
        n = int(per_rows.sum())
        period = rng.integers(3, 9, size=n)
        motif = rng.integers(0, v, size=(n, 8))
        row = np.stack([motif[i, idx % period[i]] for i in range(n)])
        toks[per_rows] = row
    batch = {
        "tokens": toks[:, :-1].astype(np.int32),
        "targets": toks[:, 1:].astype(np.int32),
    }
    if cfg.enc_seq_len and cfg.d_model:
        batch["frame_embeds"] = rng.standard_normal(
            (b, cfg.enc_seq_len, cfg.d_model)).astype(np.float32) * 0.02
    if cfg.num_image_tokens and cfg.d_model:
        batch["image_embeds"] = rng.standard_normal(
            (b, cfg.num_image_tokens, cfg.d_model)).astype(np.float32) * 0.02
    return batch


class DataIterator:
    """Stateful wrapper; its entire checkpointable state is ``step``."""

    def __init__(self, cfg: DataConfig, step: int = 0):
        self.cfg = cfg
        self.step = step

    def __next__(self) -> Dict[str, np.ndarray]:
        batch = make_batch(self.cfg, self.step)
        self.step += 1
        return batch

    def state(self) -> int:
        return self.step

    def restore(self, step: int) -> None:
        self.step = step
