from .ops import masked_psum_crop, masked_sum
from .ref import masked_sum_ref

__all__ = ["masked_sum", "masked_psum_crop", "masked_sum_ref"]
