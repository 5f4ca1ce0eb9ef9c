"""llama-3.2-vision-11b [vlm] — cross-attn image layers
(hf:meta-llama/Llama-3.2-11B-Vision).

40L d_model=4096 32H (kv=8) d_ff=14336 vocab=128256.  Every 5th layer is
a gated cross-attention layer consuming precomputed patch embeddings
(frontend STUB per assignment; 1601 patch tokens).
long_500k SKIPPED (full attention).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=128256,
    pattern=("attn", "attn", "attn", "attn", "cross"),
    head_dim=128, rope_theta=500000.0,
    cross_kind="interleaved", encoder_seq=1601,
)

SMOKE = ModelConfig(
    name="llama-3.2-vision-11b-smoke", family="vlm",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    pattern=("attn", "attn", "attn", "attn", "cross"),
    head_dim=32, cross_kind="interleaved", encoder_seq=16,
)
