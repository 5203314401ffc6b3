"""minitron-4b [dense] — 32L d=3072 24H (GQA kv=8) d_ff=9216 vocab=256000,
pruned nemotron (arXiv:2407.14679).
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=9216,
    vocab_size=256000,
    layer_pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    sharding_strategy="fsdp",
    loss_chunk=4096,
    rope_theta=10000.0,
    skip_shapes=("long_500k",),  # the reference's skip: pure full attention
)

REDUCED = CONFIG.with_(
    name="minitron-reduced",
    num_layers=2,
    d_model=48,
    num_heads=4,
    num_kv_heads=2,
    d_ff=96,
    vocab_size=512,
    dtype="float32",
)
