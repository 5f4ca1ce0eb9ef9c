"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512, 2 shared + 64 routed
top-6 (arXiv:2405.04434).

27L d_model=2048 16H moe_d_ff=1408 vocab=102400.  First layer is dense
(d_ff=10944).  MLA dims per paper: qk_nope=128, qk_rope=64, v_head=128
(no q compression in the lite model).  long_500k SKIPPED (full attention).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab=102400,
    pattern=("mla",),
    kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    n_experts=64, n_shared_experts=2, top_k=6, moe_d_ff=1408,
    first_dense=1, dense_d_ff=10944,
)

SMOKE = ModelConfig(
    name="deepseek-v2-lite-16b-smoke", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=64, vocab=256,
    pattern=("mla",),
    kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
    n_experts=8, n_shared_experts=2, top_k=2, moe_d_ff=64,
    first_dense=1, dense_d_ff=128,
    capacity_factor=4.0,   # = E/k -> C = N: dropless (exact decode checks)
)
