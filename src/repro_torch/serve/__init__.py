from repro_torch.serve.engine import (
    ContinuousEngine,
    DeltaResidency,
    DeltaStore,
    Engine,
    Tenant,
    TenantTable,
    mask_after_stop,
    residency_bytes_from_mb,
)
from repro_torch.serve.kv import SlotKVCache
from repro_torch.serve.metrics import Metrics, TenantStats
from repro_torch.serve.registry import DeltaRegistry, TenantRecord
from repro_torch.serve.scheduler import VirtualClock, tenant_segments

__all__ = ["ContinuousEngine", "DeltaRegistry", "DeltaResidency", "DeltaStore",
           "Engine", "Metrics",
           "SlotKVCache", "Tenant", "TenantRecord", "TenantStats", "TenantTable",
           "VirtualClock", "mask_after_stop", "residency_bytes_from_mb",
           "tenant_segments"]
