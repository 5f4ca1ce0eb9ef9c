"""Model configuration: one dataclass covers all 10 families of the JAX
package (``repro/models/config.py``), field for field.  ``cdtype`` is a
``torch.dtype``; the parameter counts go through the port's
``transformer.param_count``."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | ssm | hybrid | moe | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    # layer pattern: tuple of layer-kind strings, tiled over n_layers.
    # kinds: attn, local, mla, cross, mlstm, slstm, rglru  (+ffn flavour
    # is chosen by `ffn(layer_idx)`).
    pattern: tuple[str, ...] = ("attn",)

    head_dim: int | None = None
    qk_norm: bool = False
    attn_softcap: float | None = None
    final_softcap: float | None = None
    window: int | None = None          # sliding window for `local` layers
    rope_theta: float = 10000.0
    act: str = "silu"
    gated_mlp: bool = True
    norm_eps: float = 1e-6
    post_norm: bool = False            # gemma2 sandwich norms
    embed_scale: bool = False          # gemma: scale embeddings by sqrt(d)
    residual_scale: float = 1.0        # minicpm depth-scaled residuals
    tie_embeddings: bool = True

    # MLA
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    dense_d_ff: int = 0                # d_ff of leading dense layers
    first_dense: int = 0               # deepseek: first k layers use dense FFN
    capacity_factor: float = 1.25

    # recurrent
    rnn_width: int = 0                 # RG-LRU lru_width / xLSTM inner dim
    rnn_heads: int = 0
    conv_width: int = 4
    proj_factor: float = 2.0           # mLSTM up-projection factor

    # encoder / multimodal
    encoder_layers: int = 0            # whisper encoder depth
    encoder_seq: int = 0               # frames (whisper) / patches (vlm)
    cross_kind: str = "none"           # none | interleaved (vlm) | decoder (whisper)

    compute_dtype: str = "bfloat16"

    # -- derived -----------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def layer_kinds(self) -> tuple[str, ...]:
        """Kind of each of the n_layers decoder layers."""
        reps = -(-self.n_layers // len(self.pattern))
        return (self.pattern * reps)[: self.n_layers]

    def ffn_kind(self, layer_idx: int) -> str:
        """none | mlp | moe for each layer."""
        k = self.layer_kinds()[layer_idx]
        if k in ("mlstm", "slstm"):
            return "none"              # xLSTM blocks carry their own proj
        if self.n_experts and layer_idx >= self.first_dense:
            return "moe"
        return "mlp"

    @property
    def is_subquadratic(self) -> bool:
        """True if no layer does unbounded full attention (long_500k gate)."""
        kinds = set(self.layer_kinds())
        return not (("attn" in kinds) or ("mla" in kinds)
                    or ("cross" in kinds))

    @property
    def has_decoder(self) -> bool:
        return True                    # all assigned archs have a decode path

    def total_params(self) -> int:
        """Exact parameter count, derived from the real init pytree."""
        from . import transformer
        return transformer.param_count(self)

    def active_params(self) -> int:
        """Params touched per token (MoE: top_k of n_experts routed)."""
        from . import transformer
        return transformer.param_count(self, active_only=True)
