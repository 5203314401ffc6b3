"""llama4-maverick-400b-a17b [moe] — 48L d=5120 40H (GQA kv=8) vocab=202048,
MoE 128e top-1 with shared expert, MoE every 2nd layer (Maverick interleave),
iRoPE-style chunked-local attention (window 8192, global every 4th layer)
⇒ sub-quadratic for the local layers → long_500k RUNS for this arch.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=16384,  # dense (non-MoE) layers
    moe_d_ff=8192,  # per-expert FFN width (the assigned d_ff)
    vocab_size=202048,
    layer_pattern=(
        LayerSpec(mixer="attn", attn_kind="local", ffn="dense"),
        LayerSpec(mixer="attn", attn_kind="local", ffn="moe"),
        LayerSpec(mixer="attn", attn_kind="local", ffn="dense"),
        LayerSpec(mixer="attn", attn_kind="full", ffn="moe"),
    ),
    moe_num_experts=128,
    moe_top_k=1,
    moe_shared_expert=True,
    moe_dispatch="einsum",
    local_window=8192,
    rope_theta=500000.0,
    skip_shapes=(),
)

REDUCED = CONFIG.with_(
    name="llama4-maverick-reduced",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=192,
    moe_d_ff=96,
    moe_num_experts=8,
    vocab_size=512,
    local_window=8,
    dtype="float32",
)
