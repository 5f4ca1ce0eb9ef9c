"""xlstm-350m [ssm] — sLSTM + mLSTM blocks (arXiv:2405.04517).

24L d_model=1024 4H d_ff=0 vocab=50304.  xLSTM[7:1] ratio: every 8th
block is sLSTM, the rest mLSTM; blocks carry their own up/down
projections (d_ff=0 in the assignment), the mLSTM's inner width 2048
(proj_factor 2), so 4 heads of dim 512.  Constant-size recurrent state.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab=50304,
    pattern=("mlstm",) * 7 + ("slstm",),
    rnn_heads=4, proj_factor=2.0, conv_width=4,
    act="gelu",
)

SMOKE = ModelConfig(
    name="xlstm-350m-smoke", family="ssm",
    n_layers=8, d_model=64, n_heads=2, n_kv_heads=2, d_ff=0, vocab=256,
    pattern=("mlstm",) * 7 + ("slstm",),
    rnn_heads=2, proj_factor=2.0, conv_width=4, act="gelu",
)
