from repro_torch.roofline.analysis import (
    HBM_BW,
    HBM_BYTES,
    LINK_BW,
    PEAK_FLOPS,
    PEAKS,
    Roofline,
    bound_ms,
    collective_bytes,
    count_flops,
    from_callable,
    model_flops_for,
)
