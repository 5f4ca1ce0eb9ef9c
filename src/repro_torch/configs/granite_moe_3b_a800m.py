"""granite-moe-3b-a800m [moe] — 40 experts top-8
(assignment config; hf:ibm-granite/granite-3.0 family).

32L d_model=1536 24H (kv=8) moe_d_ff=512 vocab=49155, 40e top-8.
On one card the experts are not padded (``models.moe.init(pad_to=...)``
pads them for expert parallelism, the router masking the dummies).
long_500k SKIPPED (full attention).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_ff=512,
    vocab=49155,
    pattern=("attn",), head_dim=64,
    n_experts=40, top_k=8, moe_d_ff=512,
)

SMOKE = ModelConfig(
    name="granite-moe-3b-a800m-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=64, vocab=256,
    pattern=("attn",), head_dim=32,
    n_experts=8, top_k=2, moe_d_ff=64,
    capacity_factor=4.0,   # = E/k -> C = N: dropless (exact decode checks)
)
