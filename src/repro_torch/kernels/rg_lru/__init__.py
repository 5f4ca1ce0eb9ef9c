from .ops import FEATURE_CASES, rg_lru_scan, rg_lru_scan_plain, rg_lru_step
from .ref import rg_lru_ref

__all__ = ["rg_lru_scan", "rg_lru_scan_plain", "rg_lru_step",
           "FEATURE_CASES", "rg_lru_ref"]
