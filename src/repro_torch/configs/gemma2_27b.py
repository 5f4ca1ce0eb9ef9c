"""gemma2-27b [dense] — local+global alternating, logit softcaps
(arXiv:2408.00118).

46L d_model=4608 32H (kv=16) d_ff=36864 vocab=256000, head_dim=128,
window=4096, attn softcap 50, final softcap 30, sandwich norms, GeGLU.
long_500k SKIPPED: the global layers are full attention.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, d_ff=36864,
    vocab=256000,
    pattern=("local", "attn"), head_dim=128, window=4096,
    attn_softcap=50.0, final_softcap=30.0,
    post_norm=True, embed_scale=True, act="gelu",
)

SMOKE = ModelConfig(
    name="gemma2-27b-smoke", family="dense",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    pattern=("local", "attn"), head_dim=32, window=16,
    attn_softcap=50.0, final_softcap=30.0,
    post_norm=True, embed_scale=True, act="gelu",
)
