from .ops import (FEATURE_CASES, ROUTES, chunked_attention,
                  decode_attention, flash_attention, live_pairs)
from .ref import attention_ref

__all__ = ["flash_attention", "chunked_attention", "decode_attention",
           "live_pairs", "FEATURE_CASES", "ROUTES", "attention_ref"]
