"""whisper-tiny [audio] — enc-dec, conv frontend STUB (arXiv:2212.04356).

4L enc + 4L dec, d_model=384 6H d_ff=1536 vocab=51865.  The conv/mel
frontend is stubbed: ``models.frontends.synthetic_frontend`` gives
precomputed 1500-frame embeddings.  Decoder layers: self-attn + cross-attn
+ (ungated) GELU MLP.  Prompts past Whisper's native 448-token decoder
context run mechanically: the backbone is shape-polymorphic.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, d_ff=1536,
    vocab=51865,
    pattern=("attn",), head_dim=64, act="gelu", gated_mlp=False,
    encoder_layers=4, encoder_seq=1500, cross_kind="decoder",
)

SMOKE = ModelConfig(
    name="whisper-tiny-smoke", family="audio",
    n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128, vocab=256,
    pattern=("attn",), head_dim=32, act="gelu", gated_mlp=False,
    encoder_layers=2, encoder_seq=16, cross_kind="decoder",
)
