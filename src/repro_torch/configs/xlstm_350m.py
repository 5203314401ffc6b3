"""xlstm-350m [ssm] — 24L d=1024 4H d_ff=0 vocab=50304 (arXiv:2405.04517).
xLSTM[7:1]: seven mLSTM blocks per sLSTM block; blocks carry their own
projections (d_ff=0 ⇒ ffn='none'). Recurrent state ⇒ long_500k RUNS.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

_PATTERN = tuple(
    LayerSpec(mixer="slstm" if i == 7 else "mlstm", ffn="none")
    for i in range(8)
)

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    layer_pattern=_PATTERN,
    xlstm_heads=4,
    tie_embeddings=True,
    skip_shapes=(),
)

REDUCED = CONFIG.with_(
    name="xlstm-reduced",
    num_layers=8,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    vocab_size=512,
    dtype="float32",
)
