"""whisper-small [audio] — enc-dec, 12L decoder d=768 12H d_ff=3072
vocab=51865, 12L encoder over the conv-frontend STUB (input_specs provides
precomputed frame embeddings [B, 1500, 768]; arXiv:2212.04356). The shape
suite's seq_len applies to the decoder/text side (DESIGN.md §5).
long_500k skipped (full attention).
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    layer_pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    encoder_layers=12,
    enc_seq_len=1500,
    rope_theta=10000.0,
    skip_shapes=("long_500k",),  # full attention — DESIGN.md §5
)

REDUCED = CONFIG.with_(
    name="whisper-reduced",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    encoder_layers=2,
    enc_seq_len=16,
    dtype="float32",
)
