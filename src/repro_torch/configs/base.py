"""Model configs of the LM substrate (port of ``repro.configs.base``).

A model is a stack of ``LayerSpec`` periods; ``num_layers / period``
repeats of the pattern. The port keeps its own copy of the dataclasses so
that it never imports the reference package. It runs dense, full-attention
models only (the MoE, hybrid, SSM, audio and VLM families are ROADMAP.md
A2), so it has only the reference's fields that such a model reads, under
their names: the model's widths, attention and numerics, and the training
knobs ``q_block`` (the blocked attention's query tile), ``loss_chunk``
(the cross-entropy's sequence chunk) and ``remat`` (recompute each period
in the backward pass). It also records the two fields the configs set
that only a sharded run reads (``sharding_strategy``, ``skip_shapes``;
ROADMAP.md A3), so that the configs copy over value for value; the port
runs on one device and reads them nowhere. A layer or family it does not
run raises when the config is built.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class LayerSpec:
    """One layer inside the repeating pattern."""

    mixer: str = "attn"  # attn (the reference's mamba | mlstm | slstm raise)
    attn_kind: str = "full"  # full (local: the model raises)
    ffn: str = "dense"  # dense (the reference's moe | none raise)


_NOT_PORTED = "not ported (ROADMAP.md A2: the LM substrate's other families)"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense (the reference's other families raise)
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    layer_pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    head_dim: Optional[int] = None

    # --- attention ---
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    logit_softcap: float = 0.0  # > 0 is not ported (the model raises)

    # --- training knobs ---
    q_block: int = 1024  # blocked-attention query tile
    loss_chunk: int = 512  # cross-entropy sequence chunk

    # --- the reference's sharding knobs (recorded only) ---
    sharding_strategy: str = "tp"
    skip_shapes: Tuple[str, ...] = ()

    # --- numerics / misc ---
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    remat: bool = True  # recompute each period's forward in the backward

    def __post_init__(self):
        if self.family != "dense":
            raise NotImplementedError(
                f"{self.name}: family {self.family!r} is {_NOT_PORTED}")
        for spec in self.layer_pattern:
            if spec.mixer != "attn" or spec.ffn != "dense":
                raise NotImplementedError(
                    f"{self.name}: layer {spec} is {_NOT_PORTED}")
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_layers % len(self.layer_pattern) != 0:
            raise ValueError(
                f"{self.name}: num_layers={self.num_layers} not divisible by "
                f"pattern period {len(self.layer_pattern)}")

    @property
    def period(self) -> int:
        return len(self.layer_pattern)

    @property
    def num_periods(self) -> int:
        return self.num_layers // self.period

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    # ------------------------------------------------------------------
    # parameter accounting
    # ------------------------------------------------------------------
    def _attn_params(self) -> int:
        hd = self.head_dim
        q = self.d_model * self.num_heads * hd
        kv = 2 * self.d_model * self.num_kv_heads * hd
        o = self.num_heads * hd * self.d_model
        bias = ((self.num_heads + 2 * self.num_kv_heads) * hd
                if self.qkv_bias else 0)
        return q + kv + o + bias

    def _dense_ffn_params(self, d_ff: int) -> int:
        return 3 * self.d_model * d_ff  # SwiGLU: gate, up, down

    def layer_params(self, spec: LayerSpec) -> int:
        """One attention + dense SwiGLU layer with its two norms."""
        return (self._attn_params() + self._dense_ffn_params(self.d_ff)
                + 2 * self.d_model)

    def param_count(self) -> int:
        """Total parameters (embeddings + blocks + head)."""
        total = self.vocab_size * self.d_model  # embed
        if not self.tie_embeddings:
            total += self.vocab_size * self.d_model  # lm head
        total += self.num_periods * sum(self.layer_params(s)
                                        for s in self.layer_pattern)
        total += self.d_model  # final norm
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token: all of them in a dense model."""
        return self.param_count()
