from .ops import (FEATURE_CASES, chunk_flops, gated_inputs, mlstm_chunkwise,
                  mlstm_scan, mlstm_step)
from .ref import init_state, mlstm_ref

__all__ = ["mlstm_scan", "mlstm_chunkwise", "mlstm_step", "chunk_flops",
           "gated_inputs", "FEATURE_CASES", "mlstm_ref", "init_state"]
