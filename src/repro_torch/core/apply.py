"""Delta application — the paper's separate-computation scheme (§3.1, Fig. 3).

Port of ``repro/core/apply.py``. Every linear site routes through
:func:`apply_linear`:

    y = x @ W_base            (+ x @ dequant(packed delta)   if delta given)

The correction is ``kernels.ops.delta_spmm``: the CUDA kernel for a CUDA
tensor inside the envelope, the plain torch formulation for a CPU tensor
(the reference's ``_USE_PALLAS`` switch becomes "the tensor is on
CUDA").

Multi-tenant slot dispatch: a decode step whose batch rows belong to
*different* tenants stacks every tenant's :class:`PackedDelta` along a new
leading axis (:func:`stack_tenant_deltas`) and wraps each leaf in a
:class:`SlotDelta` carrying the per-row tenant index and, for the default
"segments" dispatch, the tenant-sorted :class:`TenantSegments` layout.
Tenants whose packings differ (codec, group size, quantization width)
are stacked per compatible group, and :class:`MultiSlotDelta` sums the
groups' corrections.

Mesh mode (:func:`set_mesh`, installed per step by a mesh engine): one
process per rank of a ``launch.mesh.ServingMesh``. A column-parallel
weight is this rank's :class:`ColumnShard`; :func:`apply_linear` computes
its local output columns (base product plus the correction of this
rank's delta slice, ``ops.delta_correction_sharded``) and all-gathers
them over ``model`` right after the site (:func:`_replicated`), so every
activation is whole again and every matmul reduces over the full
contraction locally, in the single-card order: a rank's columns equal
the unsharded site's bit for bit. Where the ring holds this rank's
kv-heads, q/k/v are its own columns of wq/wk/wv, not gathered
(:func:`local_linear`), and the attention output is gathered over heads
(:func:`gather_heads`); ssm and rg-lru states stay whole, each rank
running the whole mixer. With a ``data`` axis > 1 a
rank computes only its slot pool's rows: the per-data-shard
:class:`ShardedTenantSegments` layout hands it its pool's block
(:func:`_row_sharded`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.core.pack import PackedDelta, reconstruct_dense

# Active serving mesh (a ``launch.mesh.ServingMesh``), installed by a mesh
# engine before each of its steps (``ContinuousEngine._install_mesh``), so
# mesh and plain engines coexist in one process. One mesh at a time.
_MESH = None


def _note(site: str, **attrs) -> None:
    """Report the chosen dispatch to an open trace context (no-op
    otherwise)."""
    from repro_torch.serve.trace import note_path
    note_path(site, **attrs)


def set_mesh(mesh) -> None:
    """Install (or clear, with None) the process-wide serving mesh."""
    global _MESH
    _MESH = mesh


def get_mesh():
    return _MESH


class ColumnShard:
    """This model rank's output-column slice of a column-parallel weight:
    ``local`` holds columns ``[m * O/shards, (m + 1) * O/shards)`` of the
    ``[..., h_in, O]`` weight (``launch.mesh.shard_tree`` cuts it once,
    contiguous). Indexing slices the leading (layer) axes, as a tensor's
    would; :func:`apply_linear` and :func:`apply_linear_batched` take it
    in place of the weight."""

    __slots__ = ("local", "shards")

    def __init__(self, local: torch.Tensor, shards: int):
        self.local = local
        self.shards = int(shards)

    def __getitem__(self, i) -> "ColumnShard":
        return ColumnShard(self.local[i], self.shards)


def _replicated(t: torch.Tensor) -> torch.Tensor:
    """A column-parallel site's local output columns, all-gathered along
    the last axis over ``model``: the reference's replicated-activation
    pin (``repro/core/apply.py::_replicated``) as the collective it
    implies. Every matmul after it contracts the whole activation
    locally, in the single-card order."""
    if _MESH is None:
        return t
    return _MESH.all_gather(t, "model", dim=-1)


def _sharded_correction(x: torch.Tensor, d: PackedDelta, **kw):
    """This rank's correction columns, or None where the mesh path does
    not apply (``ops.delta_correction_sharded``)."""
    if _MESH is None:
        return None
    from repro_torch.kernels import ops
    return ops.delta_correction_sharded(x, d, _MESH, **kw)


def _own_columns(t: torch.Tensor) -> torch.Tensor:
    """This model rank's contiguous ``1/model`` of ``t``'s last axis."""
    n = t.shape[-1] // _MESH.shape["model"]
    m = _MESH.index("model")
    return t[..., m * n:(m + 1) * n]


def local_linear(x: torch.Tensor, w, d=None) -> torch.Tensor:
    """:func:`apply_linear`'s output columns of this model rank alone (its
    contiguous ``1/model`` of them), with no gather: a column slice's own
    product and correction, or a whole weight's result cut. The q/k/v
    projections that feed a ring sharded on kv-heads take it."""
    if _MESH is None:
        raise ValueError("a rank's own columns need the mesh installed "
                         "(core.apply.set_mesh)")
    if isinstance(w, ColumnShard):
        if w.shards != _MESH.shape["model"]:
            raise ValueError(f"a weight cut in {w.shards} under a model axis of "
                             f"{_MESH.shape['model']}")
        return _column_parallel(x, w, d, _matmul, gather=False)
    return _own_columns(apply_linear(x, w, d))


def gather_heads(out: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Attention output ``[B, S, H_local, D]`` of this rank's heads ->
    all ``n_heads``, gathered over ``model`` in head order."""
    if out.shape[2] == n_heads:
        return out
    return _MESH.all_gather(out, "model", dim=2)


def _pinned(c: torch.Tensor) -> torch.Tensor:
    """Identity. The reference wraps the correction in an
    ``optimization_barrier`` only to pin XLA's fusion boundary; eager
    torch fuses nothing, so there is nothing to pin."""
    return c


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with jnp's type promotion (an f32 activation against a
    bf16 weight multiplies in f32, as the reference does)."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        return x.to(dt) @ w.to(dt)  # deltalint: allow[DL001] base GEMM, not the correction
    return x @ w  # deltalint: allow[DL001] base GEMM, not the correction


@dataclass
class TenantSegments:
    """Tenant-segment layout for a mixed decode batch.

    Built host-side (``serve.scheduler.tenant_segments``) from the
    per-slot tenant rows: batch rows are sorted (stably) by tenant so
    each unique tenant occupies one contiguous segment. Shapes depend
    only on the slot count B:

      order       int [B]    row permutation (sorted by tenant row)
      inv_order   int [B]    inverse permutation (unsort the output)
      seg_rows    int [B]    tenant row per segment (padding rows 0)
      seg_offsets int [B+1]  half-open row ranges; empty segments have
                             equal offsets and are skipped
    """
    order: Any
    inv_order: Any
    seg_rows: Any
    seg_offsets: Any

    def to(self, device) -> "TenantSegments":
        def t(a):
            return torch.as_tensor(a).to(device=device, dtype=torch.int64)
        return TenantSegments(t(self.order), t(self.inv_order),
                              t(self.seg_rows), t(self.seg_offsets))


@dataclass
class ShardedTenantSegments:
    """Per-data-shard tenant-segment layout (``data > 1`` decode).

    Built host-side by ``serve.scheduler.tenant_segments_sharded``: each
    contiguous shard pool of B_s = B / D slots sorts its own rows by
    tenant and carries its own (pool-local) segment list:

      order       int [D, B_s]    pool-LOCAL row permutation
      inv_order   int [D, B_s]    its inverse (also pool-local)
      seg_rows    int [D, B_s]    tenant row per segment (padding 0)
      seg_offsets int [D, B_s+1]  pool-local half-open ranges

    A mesh rank of data index i computes only pool i's rows, so it takes
    block i (:meth:`block`) and decodes only the tenants its pool hosts;
    :meth:`global_order` / :meth:`global_segments` flatten the layout to
    the equivalent single-pool form (block-diagonal permutation,
    concatenated segment runs) for a run over all B rows — the same
    permutation and the same per-row bits.
    """
    order: Any
    inv_order: Any
    seg_rows: Any
    seg_offsets: Any

    @property
    def data_shards(self) -> int:
        return self.order.shape[0]

    def to(self, device) -> "ShardedTenantSegments":
        def t(a):
            return torch.as_tensor(a).to(device=device, dtype=torch.int64)
        return ShardedTenantSegments(t(self.order), t(self.inv_order),
                                     t(self.seg_rows), t(self.seg_offsets))

    def block(self, i: int) -> TenantSegments:
        """Pool i's own layout, over its B_s rows."""
        return TenantSegments(self.order[i], self.inv_order[i],
                              self.seg_rows[i], self.seg_offsets[i])

    def global_order(self) -> tuple:
        """(order, inv_order) over all B rows: the per-pool permutations
        shifted by each pool's base offset (never crossing a pool)."""
        D, Bs = self.order.shape
        base = (torch.arange(D, dtype=self.order.dtype,
                             device=self.order.device) * Bs)[:, None]
        return ((self.order + base).reshape(D * Bs),
                (self.inv_order + base).reshape(D * Bs))

    def global_segments(self) -> tuple:
        """(seg_rows [B], seg_offsets [B+1]) over all B rows: each pool's
        padding segments collapse onto its end boundary, so offsets stay
        monotone and segments never cross a pool."""
        D, Bs = self.seg_rows.shape
        B = D * Bs
        base = (torch.arange(D, dtype=self.seg_offsets.dtype,
                             device=self.seg_offsets.device) * Bs)[:, None]
        so = torch.cat([(self.seg_offsets[:, :Bs] + base).reshape(B),
                        self.seg_offsets.new_full((1,), B)])
        return self.seg_rows.reshape(B), so


@dataclass
class SlotDelta:
    """A tenant-stacked :class:`PackedDelta` plus per-batch-row tenant ids.

    ``delta`` arrays carry a leading tenant axis (then, optionally, the
    layer stack): idx/codes [R, *lead, G, K, O], scale/zero [R, *lead].
    ``slots`` is int [B] mapping each batch row to a tenant row; row 0 is
    conventionally the zero delta (base model). ``segments`` carries the
    sorted tenant-segment layout consumed by the unique-tenant dispatch.

    ``values``/``res_map`` (optional, only with ``segments``) carry the
    pre-decoded residency tier (``serve.engine.DeltaResidency``):
    ``values`` f32 [C, *lead, G, K, O] holds ``pack.decode_values`` output
    for C resident tenant rows, ``res_map`` int [R] maps a tenant row to
    its residency row (rows not made resident this step map to 0 and are
    never referenced by a live segment). The segment dispatch then reads
    the decoded values instead of unpacking the codes — on CPU tensors
    only: on the card ``ops.delta_spmm_segments`` refuses them.
    """
    delta: PackedDelta
    slots: torch.Tensor
    segments: Optional[TenantSegments] = None
    values: Optional[torch.Tensor] = None
    res_map: Optional[torch.Tensor] = None

    def index(self, i) -> "SlotDelta":
        """Slice the *layer* stack (axis 1, after the tenant axis)."""
        d = self.delta
        return SlotDelta(d.with_arrays(
            d.idx[:, i], d.codes[:, i],
            d.scale[:, i] if d.scale.ndim >= 2 else d.scale,
            d.zero[:, i] if d.zero.ndim >= 2 else d.zero),
            self.slots, self.segments,
            self.values[:, i] if self.values is not None else None,
            self.res_map)

    def gather(self) -> PackedDelta:
        """Per-row delta: [B, G, K, O] gathered from the tenant stack."""
        d = self.delta
        s = self.slots
        return d.with_arrays(d.idx[s], d.codes[s],
                             d.scale.to(torch.float32)[s],
                             d.zero.to(torch.int32)[s])


@dataclass
class MultiSlotDelta:
    """Mixed-codec decode: one :class:`SlotDelta` part per codec group.

    The engine cannot stack tenants whose runtime packings differ, so it
    stacks each compatible *group* separately and routes every group's
    rows through that group's own segment layout. Rows a group does not
    own map to its row 0 — the zero delta — so the per-leaf correction is
    the SUM of the parts' corrections: exactly one part contributes the
    row's real correction and every other part an exact 0.0, keeping
    mixed-codec decode token-identical to serving each tenant alone.
    """
    parts: tuple

    def index(self, i) -> "MultiSlotDelta":
        return MultiSlotDelta(tuple(p.index(i) for p in self.parts))


def combine_slot_deltas(wrapped: list) -> Any:
    """Merge per-group slot-wrapped trees (see ``wrap_slot_deltas``) into
    one tree of :class:`MultiSlotDelta` leaves (identity for one group)."""
    if len(wrapped) == 1:
        return wrapped[0]

    def merge(*nodes):
        if isinstance(nodes[0], dict):
            return {k: merge(*[n[k] for n in nodes]) for k in nodes[0]}
        if nodes[0] is None:
            return None
        return MultiSlotDelta(tuple(nodes))

    return merge(*wrapped)


def _row_sharded(seg, rows: int) -> tuple:
    """The (order, inv_order, seg_rows, seg_offsets) a run over ``rows``
    batch rows takes from a segment layout: a mesh rank of a ``data``
    axis > 1 computes only its pool's rows and takes its pool's block of
    a :class:`ShardedTenantSegments` (the reference pins the sorted rows
    over ``data`` instead); a run over all rows takes the flattened
    global form; a :class:`TenantSegments` is taken as it is."""
    if not isinstance(seg, ShardedTenantSegments):
        return seg.order, seg.inv_order, seg.seg_rows, seg.seg_offsets
    if _MESH is not None and _MESH.shape.get("data", 1) == seg.data_shards > 1:
        if rows != seg.order.shape[1]:
            raise ValueError(f"a data rank computes its pool's {seg.order.shape[1]} "
                             f"rows, got {rows}")
        b = seg.block(_MESH.index("data"))
        return b.order, b.inv_order, b.seg_rows, b.seg_offsets
    order, inv_order = seg.global_order()
    return (order, inv_order, *seg.global_segments())


def _segment_dispatch(x: torch.Tensor, sd: SlotDelta) -> torch.Tensor:
    """Unique-tenant correction: sort rows by tenant, decode each unique
    delta once, apply per segment, unsort. x [B, ..., h_in]."""
    from repro_torch.kernels import ops
    d = sd.delta
    B = x.shape[0]
    lead = x.shape[1:-1]
    tokens_per_row = math.prod(lead)
    order, inv_order, seg_rows, seg_offsets = _row_sharded(sd.segments, B)
    xs = x.index_select(0, order)
    x2 = xs.reshape(B * tokens_per_row, d.h_in)
    # row ranges scale with the tokens folded out of each batch row
    y2 = _sharded_correction(x2, d, segments=(seg_rows, seg_offsets * tokens_per_row),
                             values=sd.values, res_map=sd.res_map)
    if y2 is None:
        y2 = ops.delta_spmm_segments(x2, d, seg_rows, seg_offsets * tokens_per_row,
                                     values=sd.values, res_map=sd.res_map)
    # same dtype round-trip as every other path (no-op for f32)
    y = y2.reshape(B, *lead, d.h_out).to(x.dtype)
    return y.index_select(0, inv_order)


def slot_delta_matmul(x: torch.Tensor, sd: SlotDelta) -> torch.Tensor:
    """Mixed-tenant correction: x [B, S, h_in] with row b using tenant
    slots[b]. A SlotDelta that carries a TenantSegments layout takes the
    segments dispatch (each unique delta decoded once per step); one
    without (``segments=None``) takes the per-row gather."""
    if sd.segments is not None:
        _note("slot_dispatch", dispatch="segments")
        return _segment_dispatch(x, sd)
    _note("slot_dispatch", dispatch="per_row")
    from repro_torch.kernels import ops
    g = sd.gather()
    y = _sharded_correction(x, g)
    if y is not None:
        return y
    return ops.delta_spmm_slots(x, g).to(x.dtype)


def delta_matmul(x: torch.Tensor, d) -> torch.Tensor:
    """x [..., h_in] @ dequant(delta) [h_in, h_out] -> [..., h_out]."""
    if isinstance(d, MultiSlotDelta):
        # mixed-codec groups: the per-group corrections summed in f32, in
        # group order. Each row is owned by exactly one group; the others
        # map it to their zero-delta row and contribute an exact 0.0
        y = slot_delta_matmul(x, d.parts[0]).to(torch.float32)
        for p in d.parts[1:]:
            y = y + slot_delta_matmul(x, p).to(torch.float32)
        return y.to(x.dtype)
    if isinstance(d, SlotDelta):
        return slot_delta_matmul(x, d)
    y = _sharded_correction(x, d)
    if y is not None:
        return y
    from repro_torch.kernels import ops
    # the kernel on the card, the gather formulation at decode-sized token
    # counts and dense reconstruction at prefill-sized ones on the CPU; the
    # same contraction backs the segment dispatch
    return ops.delta_spmm(x, d).to(x.dtype)


def _column_parallel(x: torch.Tensor, w: ColumnShard, d, product,
                     gather: bool = True) -> torch.Tensor:
    """A column-parallel site on this rank: ``product(x, local columns)``;
    a correction of this rank's delta slice is added to those columns
    before the gather, a whole (replicated) delta's after it — in f32
    with one final rounding either way, each column as the single-card
    site computes it. ``gather=False`` keeps this rank's columns (a whole
    delta's correction cut to them)."""
    y = product(x, w.local)
    c = None if d is None else delta_matmul(x, d)
    whole = c is not None and c.shape[-1] != y.shape[-1]
    if whole and not gather:
        c, whole = _own_columns(c), False
    if whole:
        y = _replicated(y)
    if c is not None:
        y = (y.to(torch.float32) + _pinned(c.to(torch.float32))).to(y.dtype)
    return _replicated(y) if gather and not whole else y


def apply_linear(x: torch.Tensor, w: torch.Tensor, d=None) -> torch.Tensor:
    """Base matmul plus (optionally) the tenant's delta correction, added
    in f32 with ONE final rounding (``apply.py:488-493``). A
    :class:`ColumnShard` weight computes this rank's columns and gathers
    them over the mesh's ``model`` axis."""
    if isinstance(w, ColumnShard):
        return _column_parallel(x, w, d, _matmul)
    y = _matmul(x, w)
    if d is not None:
        c = _pinned(delta_matmul(x, d).to(torch.float32))
        y = (y.to(torch.float32) + c).to(y.dtype)
    return y


def apply_linear_batched(x: torch.Tensor, w: torch.Tensor, d=None,
                         counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched over a leading stack dim (MoE experts): x [E, ..., h_in],
    w [E, h_in, h_out], delta stacked [E, ...] (``apply.py:496-523``).

    The base is one batched product under :func:`_matmul`'s dtype rule;
    the correction is added in f32 with ONE final rounding, as in
    :func:`apply_linear`. On the CPU the correction is the reference's
    formulation, the dense ``[E, h_in, h_out]`` reconstruction and a
    batched product; on the card ``ops.delta_spmm_experts``, the segments
    kernel over the expert stack (``counts`` [E], optional: each expert's
    live leading rows of x, the rest being zero rows)."""
    if isinstance(d, (SlotDelta, MultiSlotDelta)):
        # Expert buffers mix tokens from many slots; a per-row gather has no
        # meaning here. The serving engine must group such archs per tenant.
        raise NotImplementedError(
            "slot-dispatched deltas are not supported at expert-batched "
            "linear sites (MoE); serve these tenants via per-tenant grouping")
    from repro_torch.kernels import ops
    x3 = x.reshape(x.shape[0], -1, x.shape[-1])
    if isinstance(w, ColumnShard):
        # the expert stack's output columns on this rank, gathered after
        # the site; a (whole) expert delta is added after the gather
        y = _replicated(_matmul(x3, w.local))
    else:
        y = _matmul(x3, w)
    h_out = y.shape[-1]
    if d is not None:
        if ops._device_kind(x3) == "cpu":
            _note("apply_linear_batched", formulation="experts-dense", codec=d.codec)
            # deltalint: allow[DL001] the reference's dense expert correction (its einsum)
            c = x3 @ reconstruct_dense(d, dtype=x3.dtype)
        else:
            c = ops.delta_spmm_experts(x3, d, counts)
        y = (y.to(torch.float32) + _pinned(c.to(torch.float32))).to(y.dtype)
    return y.reshape(*x.shape[:-1], h_out)


# ---------------------------------------------------------------------------
# Delta-tree helpers: deltas mirror the params tree with None at
# uncompressed leaves, so block code can slice them alongside params.
# ---------------------------------------------------------------------------
def none_like(params: Any) -> Any:
    """A deltas tree of all-None matching ``params``' dict structure."""
    if isinstance(params, dict):
        return {k: none_like(v) for k, v in params.items()}
    return None


def dget(deltas: Any, *keys: str) -> Any:
    """None-safe nested lookup into a deltas tree."""
    node = deltas
    for k in keys:
        if node is None:
            return None
        node = node.get(k) if isinstance(node, dict) else None
    return node


def dindex(deltas: Any, i) -> Any:
    """Slice every PackedDelta in a deltas subtree at stacked-layer index i."""
    if deltas is None:
        return None
    if isinstance(deltas, (SlotDelta, MultiSlotDelta, PackedDelta)):
        return deltas.index(i)
    if isinstance(deltas, dict):
        return {k: dindex(v, i) for k, v in deltas.items()}
    return None


# ---------------------------------------------------------------------------
# Tenant stacking for mixed-tenant decode
# ---------------------------------------------------------------------------
def _map_packed(fn, tree: Any, *rest: Any) -> Any:
    """Map ``fn`` over the PackedDelta leaves of parallel deltas trees
    (None leaves stay None); raises ValueError on a structure mismatch."""
    if isinstance(tree, dict):
        for r in rest:
            if not isinstance(r, dict) or r.keys() != tree.keys():
                raise ValueError("tenant delta trees differ in structure; "
                                 "cannot stack for slot dispatch")
        return {k: _map_packed(fn, v, *[r[k] for r in rest])
                for k, v in tree.items()}
    if tree is None:
        if any(r is not None for r in rest):
            raise ValueError("tenant delta trees differ in structure; "
                             "cannot stack for slot dispatch")
        return None
    if not isinstance(tree, PackedDelta) or \
            not all(isinstance(r, PackedDelta) for r in rest):
        raise ValueError("tenant delta trees differ in structure; "
                         "cannot stack for slot dispatch")
    return fn(tree, *rest)


def zero_delta_like(deltas: Any) -> Any:
    """An all-zero deltas tree with the same packed structure/shapes.

    Dequantizes to exactly 0 at every leaf (scale 0, codes 0), so the
    base model can occupy a row of a tenant stack."""
    def z(d: PackedDelta) -> PackedDelta:
        return d.with_arrays(torch.zeros_like(d.idx), torch.zeros_like(d.codes),
                             torch.zeros(d.scale.shape, dtype=torch.float32,
                                         device=d.device),
                             torch.zeros(d.zero.shape, dtype=torch.int32,
                                         device=d.device))
    return _map_packed(z, deltas)


def stack_tenant_deltas(trees: list) -> Any:
    """Stack N structurally identical delta trees along a new tenant axis.

    Every leaf becomes a PackedDelta with arrays [N, ...]; scale/zero
    become [N, *lead]. Raises ValueError when the trees disagree in
    structure or packing meta.
    """
    if not trees:
        raise ValueError("need at least one delta tree to stack")

    def stack(*leaves):
        d0 = leaves[0]
        for d in leaves[1:]:
            if (d.h_in, d.h_out, d.h_g, d.keep, d.k_bits, d.m, d.codec,
                    tuple(d.idx.shape), tuple(d.codes.shape)) != \
               (d0.h_in, d0.h_out, d0.h_g, d0.keep, d0.k_bits, d0.m,
                    d0.codec, tuple(d0.idx.shape), tuple(d0.codes.shape)):
                raise ValueError("tenant deltas use different packing specs; "
                                 "cannot stack for slot dispatch")
        return d0.with_arrays(
            torch.stack([d.idx for d in leaves]),
            torch.stack([d.codes for d in leaves]),
            torch.stack([d.scale.to(torch.float32) for d in leaves]),
            torch.stack([d.zero.to(torch.int32) for d in leaves]))

    return _map_packed(stack, trees[0], *trees[1:])


def wrap_slot_deltas(stacked: Any, slots: torch.Tensor,
                     segments: Optional[TenantSegments] = None,
                     values: Any = None,
                     res_map: Optional[torch.Tensor] = None) -> Any:
    """Attach per-row tenant ids (and, optionally, the sorted tenant-
    segment layout for unique-tenant dispatch, plus the pre-decoded
    residency tier: ``values`` a tree of f32 buffers mirroring ``stacked``
    leaf for leaf and ``res_map`` the shared tenant-row -> residency-row
    indirection) to every leaf of a tenant-stacked tree."""
    if values is None:
        return _map_packed(lambda d: SlotDelta(d, slots, segments), stacked)

    def wrap(node, vals):
        if isinstance(node, dict):
            return {k: wrap(v, vals[k]) for k, v in node.items()}
        if node is None:
            return None
        return SlotDelta(node, slots, segments, vals, res_map)

    return wrap(stacked, values)


def merge_delta(params: Any, deltas: Any) -> Any:
    """Materialize fine-tuned params = base + dense(delta). (Eval/reference.)

    Each matrix's dense delta comes from ``kernels.ops.dequant`` (the
    dequant kernel on the card) for a PackedDelta, from its codec's
    ``reconstruct_dense`` for the other codecs' leaves; a stacked leaf is
    merged one slice of its leading axis at a time, so no stacked dense
    delta is ever held."""
    if isinstance(params, dict):
        return {k: merge_delta(v, deltas.get(k) if isinstance(deltas, dict) else None)
                for k, v in params.items()}
    if deltas is None:
        return params
    if deltas.stack_shape():
        out = torch.empty_like(params)
        for i in range(params.shape[0]):
            out[i] = merge_delta(params[i], deltas.index(i))
        return out
    if isinstance(deltas, PackedDelta):
        from repro_torch.kernels import ops
        dense = ops.dequant(deltas)
    else:
        from repro_torch.core.codecs import reconstruct_dense_any
        dense = reconstruct_dense_any(deltas)
    return (params.to(torch.float32) + dense).to(params.dtype)
