"""recurrentgemma-2b [hybrid] — RG-LRU + local attention 1:2
(arXiv:2402.19427, Griffin).

26L d_model=2560 10H (kv=1, MQA) d_ff=7680 vocab=256000, head_dim=256,
lru_width=2560, window=2048.  Pattern (rglru, rglru, local)*8 + 2
trailing rglru layers.  Constant-state + windowed cache => long_500k runs.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
    vocab=256000,
    pattern=("rglru", "rglru", "local"), head_dim=256, window=2048,
    rnn_width=2560, conv_width=4,
    embed_scale=True, act="gelu",
)

SMOKE = ModelConfig(
    name="recurrentgemma-2b-smoke", family="hybrid",
    n_layers=5, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128, vocab=256,
    pattern=("rglru", "rglru", "local"), head_dim=32, window=16,
    rnn_width=64, conv_width=4, embed_scale=True, act="gelu",
)
