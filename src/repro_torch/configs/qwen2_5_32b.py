"""qwen2.5-32b [dense] — 64L d=5120 40H (GQA kv=8) d_ff=27648 vocab=152064,
QKV bias. [hf:Qwen/Qwen2.5-0.5B; hf]
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=27648,
    vocab_size=152064,
    layer_pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    qkv_bias=True,
    sharding_strategy="fsdp",
    loss_chunk=4096,
    rope_theta=1000000.0,
    skip_shapes=("long_500k",),  # the reference's skip: pure full attention
)

REDUCED = CONFIG.with_(
    name="qwen2.5-reduced",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=192,
    vocab_size=512,
    dtype="float32",
)
