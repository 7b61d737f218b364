"""Serving (port of ``repro/serving``): the LM decode loop with the
Gumbel-max token sampler (K8).  The walk service is not ported yet."""
from repro_torch.serving.engine import (GenerateConfig, generate,
                                        make_serve_step, sample_tokens)

__all__ = ["GenerateConfig", "generate", "make_serve_step", "sample_tokens"]
