"""command-r-35b [dense] — 40L d=8192 64H (GQA kv=8) d_ff=22528 vocab=256000,
no biases, tied embeddings (Cohere convention).
[hf:CohereForAI/c4ai-command-r-v01; unverified]
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    layer_pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    qkv_bias=False,
    tie_embeddings=True,
    sharding_strategy="fsdp",
    loss_chunk=4096,
    rope_theta=8000000.0,
    skip_shapes=("long_500k",),  # the reference's skip: pure full attention
)

REDUCED = CONFIG.with_(
    name="command-r-reduced",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=192,
    vocab_size=512,
    dtype="float32",
)
