"""minicpm3-4b [dense] — MLA (hf:openbmb/MiniCPM3-4B).

62L d_model=2560 40H (kv=40 on latents) d_ff=6400 vocab=73448.
MLA dims from the HF config: q_lora=768, kv_lora=256, qk_nope=64,
qk_rope=32, v_head=64.  Depth-scaled residuals (mup-style).
"""

import numpy as np

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b", family="dense",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40, d_ff=6400,
    vocab=73448,
    pattern=("mla",),
    q_lora_rank=768, kv_lora_rank=256, qk_nope_dim=64, qk_rope_dim=32,
    v_head_dim=64,
    residual_scale=float(1.4 / np.sqrt(62)),
)

SMOKE = ModelConfig(
    name="minicpm3-4b-smoke", family="dense",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
    pattern=("mla",),
    q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8,
    v_head_dim=16,
    residual_scale=float(1.4 / np.sqrt(3)),
)
