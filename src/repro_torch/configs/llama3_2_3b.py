"""llama3.2-3b [dense] — small llama3 (hf:meta-llama/Llama-3.2 family).

28L d_model=3072 24H (kv=8) d_ff=8192 vocab=128256, head_dim=128.
long_500k SKIPPED (pure full attention).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b", family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8, d_ff=8192,
    vocab=128256,
    pattern=("attn",), head_dim=128, rope_theta=500000.0,
)

SMOKE = ModelConfig(
    name="llama3.2-3b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    pattern=("attn",), head_dim=32, rope_theta=500000.0,
)
