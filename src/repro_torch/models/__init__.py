from repro_torch.models import lm
from repro_torch.models.lm import (
    decode_step,
    forward,
    init_cache,
    init_params,
    prefill,
)

__all__ = ["lm", "decode_step", "forward", "init_cache", "init_params", "prefill"]
