from repro_torch.serve.engine import (
    DeltaStore,
    Engine,
    Tenant,
    mask_after_stop,
)
from repro_torch.serve.scheduler import tenant_segments

__all__ = ["DeltaStore", "Engine", "Tenant", "mask_after_stop", "tenant_segments"]
