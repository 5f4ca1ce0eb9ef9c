from .config import ModelConfig
from . import attention, frontends, layers, recurrent, transformer
from .transformer import (Transformer, apply, init_cache, init_params,
                          layer_groups, param_count)

__all__ = ["ModelConfig", "Transformer", "apply", "init_cache",
           "init_params", "layer_groups", "param_count", "attention",
           "frontends", "layers", "recurrent", "transformer"]
