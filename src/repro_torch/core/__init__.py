"""DeltaDQ core: the paper's contribution as PyTorch functions."""
from repro_torch.core.apply import (
    MultiSlotDelta,
    SlotDelta,
    TenantSegments,
    apply_linear,
    combine_slot_deltas,
    delta_matmul,
    dget,
    dindex,
    merge_delta,
    none_like,
    slot_delta_matmul,
    stack_tenant_deltas,
    wrap_slot_deltas,
    zero_delta_like,
)
from repro_torch.core.codecs import (
    BitDeltaCodec,
    BitDeltaLeaf,
    BitDeltaSpec,
    DeltaCodec,
    DeltaDQCodec,
    DeltaDQSpec,
    LowRankCodec,
    LowRankLeaf,
    LowRankSpec,
    codec_for_spec,
    codec_names,
    codec_of_leaf,
    get_codec,
    is_codec_leaf,
    reconstruct_dense_any,
    register_codec,
    runtime_delta_tree,
    runtime_packed_leaf,
)
from repro_torch.core.compress import (
    CompressionReport,
    compress,
    decompress,
    is_compressible,
)
from repro_torch.core.dropout import (
    bernoulli_dropout_dense,
    groupwise_dropout_pack,
    keep_count,
    rowwise_dropout_pack,
)
from repro_torch.core.groupsearch import (
    SearchResult,
    attention_proxy_error,
    candidate_group_sizes,
    search_direct,
    search_proxy,
)
from repro_torch.core.pack import (
    PackedDelta,
    StoragePart,
    decode_values,
    from_storage_parts,
    reconstruct_dense,
    to_storage_parts,
)
from repro_torch.core.quant import (
    QuantParams,
    compression_ratio,
    dequantize,
    pack_bits,
    quantize,
    storage_bits_per_value,
    unpack_bits,
)

__all__ = [k for k in dir() if not k.startswith("_")]
