"""internvl2-1b [vlm] — InternLM2-1B backbone: 24L d=896 14H (GQA kv=2)
d_ff=4864 vocab=151655 (arXiv:2404.16821). InternViT frontend is a STUB:
input_specs provides 256 precomputed patch embeddings prepended to the text.
long_500k skipped (full attention).
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    layer_pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    num_image_tokens=256,
    tie_embeddings=True,
    rope_theta=1000000.0,
    skip_shapes=("long_500k",),  # full attention — DESIGN.md §5
)

REDUCED = CONFIG.with_(
    name="internvl2-reduced",
    num_layers=2,
    d_model=56,
    num_heads=4,
    num_kv_heads=2,
    head_dim=14,
    d_ff=112,
    vocab_size=512,
    num_image_tokens=8,
    dtype="float32",
)
