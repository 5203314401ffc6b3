"""moonshot-v1-16b-a3b [moe] — 48L d=2048 16H (GQA kv=16 = MHA) d_ff=1408,
vocab=163840, MoE 64e top-6 + shared expert (Moonlight/DeepSeek-V3 style;
Moonlight uses 2 shared experts — we fold them into one of 2× width? No:
one shared expert of the same width, noted in DESIGN.md).
[hf:moonshotai/Moonlight-16B-A3B; hf]
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    moe_d_ff=1408,
    vocab_size=163840,
    layer_pattern=(LayerSpec(mixer="attn", ffn="moe"),),
    moe_num_experts=64,
    moe_top_k=6,
    moe_shared_expert=True,
    moe_dispatch="einsum",
    rope_theta=50000.0,
    skip_shapes=("long_500k",),  # full attention — noted in DESIGN.md §5
)

REDUCED = CONFIG.with_(
    name="moonshot-reduced",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=96,
    moe_d_ff=96,
    moe_num_experts=8,
    moe_top_k=2,
    vocab_size=512,
    dtype="float32",
)
