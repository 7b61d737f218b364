"""The LM side-stack's models (port of ``repro/models``): the dense
decoder's decode path — ``init_params``, ``init_cache``, ``decode_step``
— and the port's own copy of ``ModelConfig``."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (DecoderLM, decode_step, init_cache,
                                      init_params, segment_plan)

__all__ = ["DecoderLM", "ModelConfig", "decode_step", "init_cache",
           "init_params", "segment_plan"]
