"""Model configs of the LM substrate (port of ``repro.configs.base``).

A model is a stack of ``LayerSpec`` periods; ``num_layers / period``
repeats of the pattern. The port keeps its own copy of the dataclasses so
that it never imports the reference package. It runs every family of the
reference: attention layers, full or local (chunked-window), Mamba layers
and xLSTM's mLSTM and sLSTM layers, each with a dense SwiGLU FFN, a
mixture-of-experts FFN or none; the audio family's encoder-decoder
(``encoder_layers`` layers over ``enc_seq_len`` stub frame embeddings,
cross-attention in every decoder layer) and the VLM family's prefix of
``num_image_tokens`` stub patch embeddings. So it has the reference's
fields that such a model reads, under their names: the model's widths, the
MoE, attention, Mamba, xLSTM, encoder and image fields, numerics, and the
training knobs ``q_block`` (the blocked attention's query tile),
``loss_chunk`` (the cross-entropy's sequence chunk) and ``remat``
(recompute each period in the backward pass). It also records the two
fields the configs set that only a sharded run reads
(``sharding_strategy``, ``skip_shapes``; ROADMAP.md A3b), so that the
configs copy over value for value; the port runs on one device and reads
them nowhere. :data:`SHAPES` is the reference's LM shape suite, which
the registry's cell accounting reads (its ``tokens_per_step`` and the
NeRF shape suite come with the launcher that reads them, ROADMAP.md A3c).

The parameter accounting is the reference's, value for value, where it
differs from what ``init_params`` builds (ROADMAP.md, reference caveats 5
and 6): ``_mamba_params`` leaves out ``a_log`` and ``d_skip``,
``_xlstm_params`` counts an mLSTM of inner width ``2 d`` and an sLSTM
with ``4 d / 3``-wide projections, which no init builds, and the encoder
term leaves out each decoder layer's cross-attention norm (``norm_x``) and
the encoder's final norm.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class LayerSpec:
    """One layer inside the repeating pattern."""

    mixer: str = "attn"  # attn | mamba | mlstm | slstm
    attn_kind: str = "full"  # full | local (chunked windowed attention)
    ffn: str = "dense"  # dense | moe | none


FAMILIES = ("dense", "moe", "hybrid", "ssm", "audio", "vlm")
MIXERS = ("attn", "mamba", "mlstm", "slstm")
FFNS = ("dense", "moe", "none")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    layer_pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    head_dim: Optional[int] = None

    # --- MoE ---
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_shared_expert: bool = False
    moe_dispatch: str = "einsum"  # einsum | streaming  (streaming = RIT-style)
    capacity_factor: float = 1.25

    # --- attention ---
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    local_window: int = 8192  # for attn_kind == "local"
    logit_softcap: float = 0.0

    # --- mamba ---
    mamba_d_state: int = 128
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_n_groups: int = 1

    # --- xlstm ---
    xlstm_heads: int = 4

    # --- encoder-decoder (audio) ---
    encoder_layers: int = 0
    enc_seq_len: int = 0  # stub frontend: number of precomputed frame embeddings

    # --- vlm ---
    num_image_tokens: int = 0  # stub frontend: precomputed patch embeddings

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
        if self.family not in FAMILIES:
            raise ValueError(f"{self.name}: unknown family {self.family!r}")
        for spec in self.layer_pattern:
            if spec.mixer not in MIXERS or spec.ffn not in FFNS:
                raise ValueError(f"{self.name}: unknown layer {spec}")
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

    def _expert_params(self) -> int:
        return self._dense_ffn_params(self.moe_d_ff or self.d_ff)

    def _mamba_params(self) -> int:
        d_inner = self.mamba_expand * self.d_model
        in_proj = self.d_model * 2 * d_inner
        conv = self.mamba_d_conv * d_inner
        x_proj = d_inner * (2 * self.mamba_d_state + self.num_heads)
        dt = self.num_heads
        out = d_inner * self.d_model
        return in_proj + conv + x_proj + dt + out

    def _xlstm_params(self, kind: str) -> int:
        d = self.d_model
        if kind == "mlstm":
            d_inner = 2 * d
            return (d * (2 * d_inner) + 3 * d_inner * d_inner
                    // self.xlstm_heads * self.xlstm_heads + d_inner * d)
        # sLSTM: 4 gates, recurrent + input
        return 8 * d * d + 2 * d * (4 * d // 3)

    def layer_params(self, spec: LayerSpec) -> int:
        """One layer's mixer, its dense or MoE FFN (if any) and its two
        norms (two whatever the FFN, as the reference counts)."""
        p = 0
        if spec.mixer == "attn":
            p += self._attn_params()
        elif spec.mixer == "mamba":
            p += self._mamba_params()
        else:
            p += self._xlstm_params(spec.mixer)
        if spec.ffn == "dense":
            p += self._dense_ffn_params(self.d_ff)
        elif spec.ffn == "moe":
            p += self.moe_num_experts * self._expert_params()
            p += self.d_model * self.moe_num_experts  # router
            if self.moe_shared_expert:
                p += self._expert_params()
        return p + 2 * self.d_model  # norms

    def param_count(self) -> int:
        """Total parameters (embeddings + blocks + head)."""
        total = self.vocab_size * self.d_model  # embed
        if not self.tie_embeddings:
            total += self.vocab_size * self.d_model  # lm head
        total += self.num_periods * sum(self.layer_params(s)
                                        for s in self.layer_pattern)
        if self.encoder_layers:
            enc_spec = LayerSpec(mixer="attn", ffn="dense")
            # encoder layers + each decoder layer's cross-attention (not
            # its norm_x, nor the encoder's final norm: caveat 6)
            total += self.encoder_layers * self.layer_params(enc_spec)
            total += self.num_layers * self._attn_params()
        total += self.d_model  # final norm
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k + shared experts only)."""
        total = self.vocab_size * self.d_model
        if not self.tie_embeddings:
            total += self.vocab_size * self.d_model
        act = 0
        for s in self.layer_pattern:
            p = self.layer_params(s)
            if s.ffn == "moe":
                p -= self.moe_num_experts * self._expert_params()
                p += self.moe_top_k * self._expert_params()
            act += p
        return total + self.num_periods * act + self.d_model


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


# the reference's four LM shape suites
SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", seq_len=4096, global_batch=256,
                            kind="train"),
    "prefill_32k": ShapeConfig("prefill_32k", seq_len=32768,
                               global_batch=32, kind="prefill"),
    "decode_32k": ShapeConfig("decode_32k", seq_len=32768, global_batch=128,
                              kind="decode"),
    "long_500k": ShapeConfig("long_500k", seq_len=524288, global_batch=1,
                             kind="decode"),
}
