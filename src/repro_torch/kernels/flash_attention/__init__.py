from .ops import (DV_CASES, FEATURE_CASES, MLA_CASES, MLA_SEQ, ROUTES,
                  chunked_attention, decode_attention, decode_partial,
                  flash_attention, live_pairs, merge_partials)
from .ref import attention_ref

__all__ = ["flash_attention", "chunked_attention", "decode_attention",
           "decode_partial", "merge_partials", "live_pairs", "FEATURE_CASES",
           "DV_CASES", "MLA_CASES", "MLA_SEQ", "ROUTES", "attention_ref"]
