from repro_torch.optim import adamw, schedule
from repro_torch.optim.adamw import AdamWConfig

__all__ = ["adamw", "schedule", "AdamWConfig"]
