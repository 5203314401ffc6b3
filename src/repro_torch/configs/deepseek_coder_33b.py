"""deepseek-coder-33b [dense] — 62L d=7168 56H (GQA kv=8) d_ff=19200
vocab=32256, llama-arch (arXiv:2401.14196).
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=19200,
    vocab_size=32256,
    layer_pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    sharding_strategy="fsdp",
    loss_chunk=4096,
    rope_theta=100000.0,
    skip_shapes=("long_500k",),  # the reference's skip: pure full attention
)

REDUCED = CONFIG.with_(
    name="deepseek-coder-reduced",
    num_layers=2,
    d_model=64,
    num_heads=8,
    num_kv_heads=2,
    d_ff=160,
    vocab_size=512,
    dtype="float32",
)
