from repro_torch.serve.engine import (
    ContinuousEngine,
    DeltaStore,
    Engine,
    Tenant,
    mask_after_stop,
)
from repro_torch.serve.kv import SlotKVCache
from repro_torch.serve.metrics import Metrics, TenantStats
from repro_torch.serve.scheduler import VirtualClock, tenant_segments

__all__ = ["ContinuousEngine", "DeltaStore", "Engine", "Metrics", "SlotKVCache",
           "Tenant", "TenantStats", "VirtualClock", "mask_after_stop",
           "tenant_segments"]
