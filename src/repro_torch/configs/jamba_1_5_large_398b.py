"""jamba-1.5-large-398b [hybrid] — 72L d=8192 64H (GQA kv=8) d_ff=24576,
vocab=65536, Mamba:attention 7:1 interleave, MoE 16e top-2 every 2nd layer
(arXiv:2403.19887). SSM state ⇒ long_500k RUNS (attention layers use the
sequence-sharded KV decode path).
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

# period of 8: one attention layer + seven mamba layers; MoE on odd slots
_PATTERN = tuple(
    LayerSpec(mixer="attn" if i == 0 else "mamba",
              ffn="moe" if i % 2 == 1 else "dense")
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    moe_d_ff=24576,
    vocab_size=65536,
    layer_pattern=_PATTERN,
    moe_num_experts=16,
    moe_top_k=2,
    moe_dispatch="einsum",
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    rope_theta=10000.0,
    skip_shapes=(),
)

REDUCED = CONFIG.with_(
    name="jamba-reduced",
    num_layers=8,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    moe_d_ff=128,
    moe_num_experts=4,
    moe_top_k=2,
    vocab_size=512,
    mamba_d_state=8,
    dtype="float32",
)
