"""Multi-tenant serving engines — the paper's deployment scheme (Fig. 2/3).

Port of ``repro/serve/engine.py`` for one card. One **base model** is
resident; each *tenant* registers only its compressed delta (any codec,
lowered to the PackedDelta runtime layout at registration). Two engines
share that model:

* :class:`ContinuousEngine` — the production path. A continuous-batching
  scheduler packs requests from *mixed tenants* into fixed decode slots
  (``serve.scheduler``), a slot KV cache admits and evicts sequences
  mid-flight (``serve.kv``), and every decode step serves all slots at
  once through the tenant-stacked packed deltas (``core.apply.SlotDelta``)
  — on the card, the ``delta_spmm_segments`` kernel. Tenants whose
  packings differ form codec groups, one stack each. Prompt lengths are
  bucketed and left-padded (exact lengths for archs with ssm or rec
  layers, whose carried state a pad would pollute); ``chunked_prefill=``
  streams prompts in fixed-size chunks inside the decode step instead
  (exact-length tail chunks for those archs). encdec and vlm archs are
  refused, as in the reference: their per-request encoder inputs go
  through ``Engine.generate(extra_inputs=)``. ``tenant_capacity=``
  pre-allocates a :class:`TenantTable` so tenants register, roll out and
  retire as in-place row writes. ``residency_budget_bytes=`` builds the
  :class:`DeltaResidency` tier of pre-decoded tenant values.

* :class:`Engine` — the static per-tenant-batch engine, kept as the
  reference path (``generate``) and as a thin shim: ``serve_batch``
  routes through a ContinuousEngine and falls back to per-tenant
  grouping only where slot dispatch cannot apply.

The reference jits each step; the port runs eagerly and updates the KV
cache and the tenant table in place. ``ContinuousEngine(mesh=)`` serves
sharded over a ``launch.mesh.ServingMesh``, one process per rank (see
the class doc); ``Engine.generate`` stays single-card, as in the
reference.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.configs.arch import ArchConfig
from repro_torch.core.apply import (
    _map_packed,
    combine_slot_deltas,
    dget,
    wrap_slot_deltas,
)
from repro_torch.core.codecs import runtime_delta_tree
from repro_torch.core.compress import CompressionReport
from repro_torch.core.pack import PackedDelta, decode_values
from repro_torch.models import lm
from repro_torch.serve.kv import SlotKVCache
from repro_torch.serve.metrics import Metrics
from repro_torch.serve.scheduler import (
    ChunkBudget,
    ChunkQueue,
    LengthBuckets,
    Request,
    RequestQueue,
    Scheduler,
    SlotState,
    tenant_segments,
    tenant_segments_sharded,
)
from repro_torch.serve.trace import EventBus, attribution, path_label
from repro_torch.utils import iter_leaves, tree_bytes


def mask_after_stop(gen: np.ndarray, stop_token: int) -> np.ndarray:
    """Replace every token *after* the first stop token with the stop token.

    ``gen`` [B, T] int. Explicit zero-filled shift: a stop token in the
    final step must not wrap around and corrupt column 0.
    """
    stopped = np.cumsum(gen == stop_token, axis=1) > 0
    after = np.zeros_like(stopped)
    after[:, 1:] = stopped[:, :-1]
    return np.where(after, stop_token, gen)


def _packed_leaves(deltas: Any) -> list:
    return [l for _, l in iter_leaves(deltas) if isinstance(l, PackedDelta)]


@dataclasses.dataclass
class Tenant:
    name: str
    deltas: Any                       # PackedDelta tree mirroring params
    report: Optional[CompressionReport] = None

    def bytes(self) -> int:
        return tree_bytes(self.deltas)

    def codecs(self) -> tuple:
        """Codec names appearing in this tenant's (runtime) delta tree."""
        return tuple(sorted({l.codec for l in _packed_leaves(self.deltas)}))


class DeltaStore:
    """Registry of compressed per-tenant deltas.

    ``version`` bumps on every registration so engines rebuild their
    tenant-stacked dispatch trees lazily; registration order is stable,
    so tenant row indices never shift under appends. ``unregister`` DOES
    shift rows — ContinuousEngine refuses to continue in-flight sequences
    across it (drain first).
    """

    def __init__(self):
        self._tenants: dict[str, Tenant] = {}
        self.version = 0

    def register(self, name: str, deltas: Any, report=None, *,
                 replace: bool = False) -> Tenant:
        if name in self._tenants and not replace:
            # a silent same-name replace would switch live sequences of
            # this tenant to new deltas mid-sequence
            raise ValueError(
                f"tenant {name!r} is already registered; pass replace=True "
                "(or use ContinuousEngine.register_tenant, which refuses "
                "only while the tenant has in-flight sequences)")
        t = Tenant(name, deltas, report)
        self._tenants[name] = t
        self.version += 1
        return t

    def unregister(self, name: str) -> None:
        self._tenants.pop(name, None)
        self.version += 1

    def snapshot(self) -> tuple:
        """Cheap copy of the registry state (mapping + version cursor), so
        engine mutations can roll back to exactly this state when a
        refresh fails downstream."""
        return (dict(self._tenants), self.version)

    def restore(self, snap: tuple) -> None:
        self._tenants, self.version = dict(snap[0]), snap[1]

    def get(self, name: str) -> Tenant:
        return self._tenants[name]

    def names(self):
        return sorted(self._tenants)

    def ordered(self) -> List[Tenant]:
        """Tenants in registration order (stable stack rows)."""
        return list(self._tenants.values())

    def total_bytes(self) -> int:
        return sum(t.bytes() for t in self._tenants.values())


# ---------------------------------------------------------------------------
# Pre-decoded delta residency (the hot-tenant value cache)
# ---------------------------------------------------------------------------
def residency_bytes_from_mb(mb: float) -> Optional[int]:
    """``--residency-mb``-style knob -> ``residency_budget_bytes=``.

    Decimal MB; 0 (or negative) disables the tier (None). The one
    conversion every entry point uses, so the unit and the disable
    semantics cannot drift between them.
    """
    b = int(mb * 1e6)
    return b if b > 0 else None


class Signatures:
    """The distinct call signatures one of the engine's entry points has
    run with: what a jit's compile cache holds in the reference (a new
    signature is a retrace there). ``_cache_size()`` is the count
    ``analysis.CompileGuard`` reads; :meth:`record` returns whether the
    key is new (a jit would trace). ``traces`` counts the new keys that
    emitted ``jit_trace`` (calls with path notes, i.e. with deltas)."""

    def __init__(self) -> None:
        self.keys: set = set()
        self.traces = 0

    def record(self, key: Any) -> bool:
        new = key not in self.keys
        self.keys.add(key)
        return new

    def _cache_size(self) -> int:
        return len(self.keys)


def _zip_packed(fn, stacked: Any, values: Any) -> None:
    """Call ``fn(delta, buffer)`` for each PackedDelta leaf of ``stacked``
    and its buffer in the parallel ``values`` tree."""
    if isinstance(stacked, dict):
        for k, v in stacked.items():
            _zip_packed(fn, v, values[k])
    elif stacked is not None:
        fn(stacked, values)


class DeltaResidency:
    """LRU cache of *dequantized* per-tenant delta values under a byte budget.

    The packed delta stack stays the ground truth; this tier additionally
    keeps, for up to ``capacity`` hot tenant rows, the f32
    ``pack.decode_values`` output of every leaf (shape = the leaf's idx
    shape — ~8x the packed bytes at k=4, still ~10x under dense). A
    decode step whose unique tenant rows are all resident skips the
    per-step code unpack (the values path of ``core.apply`` /
    ``kernels.fallback``); any other step takes the packed path, which is
    always correct.

    The values path is a plain torch formulation, taken on CPU tensors
    only, as the reference takes it only when its Pallas backend is off
    (``repro/serve/engine.py:1373``): on the card the segments kernel
    decodes each tile once per segment and ``ops.delta_spmm_segments``
    refuses values, so the engine builds and accounts the tier on every
    device but consults it only for a stack on the CPU.

    * **Budget**: ``capacity = budget_bytes // bytes-per-row`` rows
      (capped at the stack height). Below 2 rows the tier disables
      itself — row 0 (the zero delta) is pinned to residency row 0,
      whose zero-initialized buffer IS its decoded value, so at least
      one real tenant must also fit for the tier to ever apply.
    * **Promotion** is an in-place ``copy_`` of
      ``pack.decode_values(stack row)`` into the residency row of each
      leaf: the same elementwise math the packed path runs in-step, so
      resident values equal in-step decode bit for bit.
    * **Demotion** is LRU among rows not referenced by the current
      step; no device work — the row is simply reused.

    Under a mesh the engine passes this rank's slice of the stack (the
    reference's ``shard_output`` layout), so the value buffers, shaped
    after its leaves, hold this rank's output columns and the budget is
    per rank: no mesh argument is needed to place them.
    """

    def __init__(self, stacked: Any, budget_bytes: int):
        leaves = _packed_leaves(stacked)
        if not leaves:
            raise ValueError(
                "residency needs a stacked delta tree with PackedDelta "
                f"leaves; got {type(stacked).__name__}")
        self.n_rows = int(leaves[0].idx.shape[0])
        self.device = leaves[0].device   # the stack's, and the buffers'
        self.row_bytes = int(sum(4 * math.prod(l.idx.shape[1:]) for l in leaves))
        self.budget_bytes = int(budget_bytes)
        self.capacity = int(min(self.n_rows, self.budget_bytes // self.row_bytes))
        self.enabled = self.capacity >= 2
        self.hits = self.misses = self.fallback_steps = 0
        self._stacked = stacked
        self._slot_of: dict[int, int] = {}
        self._lru: List[int] = []        # tenant rows, least-recent first
        self._free: List[int] = []
        self.values: Any = None
        if not self.enabled:
            return
        self.values = _map_packed(
            lambda d: torch.zeros((self.capacity, *d.idx.shape[1:]),
                                  dtype=torch.float32, device=d.device),
            stacked)
        self._slot_of = {0: 0}           # zero delta: decoded values ARE 0
        self._free = list(range(1, self.capacity))
        # the reference's promotion jit: one signature per stack shape
        self._promote = Signatures()

    def _promote_row(self, row: int, slot: int) -> None:
        self._promote.record(_stack_signature(self._stacked))
        _zip_packed(lambda d, buf: buf[slot].copy_(decode_values(d.index(row))),
                    self._stacked, self.values)

    def ensure(self, rows: np.ndarray) -> Optional[np.ndarray]:
        """Make every unique tenant row of ``rows`` resident, promoting
        (and LRU-demoting) as needed; returns the int32 [n_rows]
        tenant-row -> residency-row map, or None when this step must run
        packed (tier disabled, or more unique tenants than capacity)."""
        if not self.enabled:
            return None
        uniq = [int(r) for r in np.unique(np.asarray(rows)) if r != 0]
        if len(uniq) > self.capacity - 1:     # row 0 keeps its pinned slot
            self.fallback_steps += 1
            return None
        missing = [r for r in uniq if r not in self._slot_of]
        self.hits += len(uniq) - len(missing)
        self.misses += len(missing)
        for r in missing:
            if self._free:
                slot = self._free.pop(0)
            else:
                victim = next(v for v in self._lru if v not in uniq)
                self._lru.remove(victim)
                slot = self._slot_of.pop(victim)
            self._slot_of[r] = slot
            self._promote_row(r, slot)
        for r in uniq:                        # refresh recency, MRU last
            if r in self._lru:
                self._lru.remove(r)
            self._lru.append(r)
        res_map = np.zeros(self.n_rows, np.int32)
        for row, slot in self._slot_of.items():
            res_map[row] = slot
        return res_map

    def invalidate(self, rows) -> None:
        """Drop the pre-decoded values of ``rows`` (their packed source
        was rewritten — a tenant-table write, rollout or retire); the
        freed residency slots go back to the promotion free list. Row 0
        stays pinned: the zero delta's values are always zeros."""
        if not self.enabled:
            return
        for r in rows:
            r = int(r)
            if r == 0:
                continue
            slot = self._slot_of.pop(r, None)
            if slot is not None:
                self._free.append(slot)
            if r in self._lru:
                self._lru.remove(r)

    def retarget(self, stacked: Any) -> None:
        """Point promotions at a rewritten stacked tree (same shapes)."""
        self._stacked = stacked

    def reset_counters(self) -> None:
        """Zero the hit/miss/fallback counters; resident rows stay warm."""
        self.hits = self.misses = self.fallback_steps = 0

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "enabled": self.enabled,
            "capacity_rows": self.capacity,
            "row_bytes": self.row_bytes,
            "budget_bytes": self.budget_bytes,
            # the full capacity*row_bytes buffer is committed at
            # construction; resident_bytes is the HOT subset of it
            "allocated_bytes": (self.capacity if self.enabled else 0)
            * self.row_bytes,
            "resident_rows": len(self._slot_of),
            "resident_bytes": len(self._slot_of) * self.row_bytes,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / total if total else None,
            "fallback_steps": self.fallback_steps,
        }


# ---------------------------------------------------------------------------
# Which tenants can share one tenant stack
# ---------------------------------------------------------------------------
def _refuse_expert_deltas(deltas: Any) -> None:
    """Slot dispatch mixes tenants' rows in one batch; an MoE expert
    buffer mixes them again across experts, where a per-row delta has no
    meaning (``apply_linear_batched`` raises). A tenant with packed deltas
    at ``moe/{wi,wg,wo}`` is served by per-tenant grouping instead
    (``Engine.serve_batch``), as the reference's engine refuses it
    (``repro/serve/engine.py:882-888``)."""
    moe = dget(deltas, "moe")
    if moe is not None and any(isinstance(dget(moe, k), PackedDelta)
                               for k in ("wi", "wg", "wo")):
        raise ValueError(
            "slot dispatch cannot apply deltas at MoE expert "
            "sites; serve MoE tenants via per-tenant grouping")


def _tree_structure(deltas: Any) -> tuple:
    """Paths of the tree and which of them hold a PackedDelta: two tenants
    can be combined only when these are equal."""
    return tuple(sorted((p, isinstance(l, PackedDelta))
                        for p, l in iter_leaves(deltas)))


def _stack_signature(deltas: Any) -> tuple:
    """Per-leaf packing meta of a runtime delta tree. Two tenants can join
    one tenant stack iff their signatures are equal (the meta
    ``stack_tenant_deltas`` checks, including the codec)."""
    return tuple(
        (l.h_in, l.h_out, l.h_g, l.keep, l.k_bits, l.m, l.codec,
         tuple(l.idx.shape), tuple(l.codes.shape))
        for l in _packed_leaves(deltas))


def _alloc_rows(template: Any, n: int) -> Any:
    """A tenant stack of ``n`` all-zero rows shaped after ``template``'s
    leaves (scale f32, zero int32). A zero row decodes to exactly 0."""
    def alloc(d: PackedDelta) -> PackedDelta:
        return d.with_arrays(
            torch.zeros((n, *d.idx.shape), dtype=d.idx.dtype, device=d.device),
            torch.zeros((n, *d.codes.shape), dtype=d.codes.dtype, device=d.device),
            torch.zeros((n, *d.scale.shape), dtype=torch.float32, device=d.device),
            torch.zeros((n, *d.zero.shape), dtype=torch.int32, device=d.device))
    return _map_packed(alloc, template)


def _write_row(stacked: Any, row: int, tree: Optional[Any]) -> None:
    """Row ``row`` of a tenant stack := ``tree`` (None: the zero delta),
    in place, leaf by leaf."""
    def write(t: PackedDelta, d: Optional[PackedDelta]) -> None:
        if d is None:
            for a in (t.idx, t.codes, t.scale, t.zero):
                a[row].zero_()
            return
        t.idx[row].copy_(d.idx)
        t.codes[row].copy_(d.codes)
        t.scale[row].copy_(d.scale.to(torch.float32))
        t.zero[row].copy_(d.zero.to(torch.int32))

    if tree is None:
        _map_packed(lambda t: write(t, None), stacked)
    else:
        _map_packed(write, stacked, tree)


def _row_view(stacked: Any, row: int) -> Any:
    """Row ``row`` of a tenant stack as an unstacked tree (views)."""
    return _map_packed(lambda t: t.index(row), stacked)


@dataclasses.dataclass
class _CodecGroup:
    """One stack-compatible tenant group of a mixed-codec engine.

    ``stacked`` is the group's tenant-stacked runtime tree with the zero
    delta at its row 0; ``lut`` maps a GLOBAL tenant row (the engine's
    ``_rows`` / scheduler numbering) to this group's local stack row —
    rows the group does not own map to 0, the zero delta, so applying
    every group to every batch row and summing is exact (see
    ``core.apply.MultiSlotDelta``). ``shapes`` is the stack's packing
    signature, leading dimension included: the argument shapes a
    reference jit would retrace on.
    """
    stacked: Any
    lut: np.ndarray                   # int32 [n_global_rows]
    names: List[str]
    codecs: tuple
    shapes: tuple = ()


# ---------------------------------------------------------------------------
# Static tenant table: pre-allocated stack rows for hot registration
# ---------------------------------------------------------------------------
class TenantTable:
    """Pre-allocated tenant-stacked envelope with free rows.

    The dynamic path re-stacks the whole tenant dimension on every
    register/unregister (the stack's leading dimension changes). The
    table allocates ``capacity + 1`` rows up front (row 0 = the zero
    delta, as in every stack) shaped after the FIRST tenant's runtime
    tree, and lifecycle events become in-place row writes:

    * **register** fills a free row (per-leaf ``copy_``): values change,
      shapes never do;
    * **retire** tombstones the row (zeroes it, so a stale dispatch of
      that row decodes to an exact 0.0) and returns it to the free list —
      other tenants' rows never shift;
    * **rollout** writes the new version into a *new* row and the engine
      flips the name→row mapping, so in-flight sequences keep decoding
      against the old row until they drain.

    Every tenant must match the template's tree structure AND stack
    signature (:meth:`check_compatible`); heterogeneous-codec fleets need
    the dynamic multi-group path.

    Under a mesh (``mesh=``, ``shard_deltas="auto"``) the table holds this
    rank's output-column slice of every row: a row write copies the
    tenant's slice in (``launch.mesh.shard_delta``, cut at the write,
    never per step); ``"replicated"`` keeps whole rows.
    """

    def __init__(self, template: Any, capacity: int, *, mesh=None,
                 shard_deltas: str = "auto"):
        if capacity < 1:
            raise ValueError(f"tenant_capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.signature = _stack_signature(template)
        self.structure = _tree_structure(template)
        self.mesh = mesh if shard_deltas == "auto" else None
        self.stacked = _alloc_rows(self._cut(template), self.capacity + 1)
        self._free: List[int] = list(range(1, self.capacity + 1))
        # the reference's row-write jit: every write and tombstone has the
        # template's signature
        self._write_jit = Signatures()

    def _cut(self, tree: Any) -> Any:
        """This rank's slice of a runtime tree (views), or the tree."""
        if self.mesh is None:
            return tree
        from repro_torch.launch.mesh import shard_delta_tree
        return shard_delta_tree(tree, self.mesh, copy=False)

    @property
    def n_free(self) -> int:
        return len(self._free)

    def check_compatible(self, tree: Any) -> None:
        """Raise ValueError unless ``tree`` can fill a row (called BEFORE
        any engine state mutates, so a rejected tenant is a no-op)."""
        got_struct = _tree_structure(tree)
        if got_struct != self.structure:
            raise ValueError(
                f"tenant delta tree structure {got_struct!r} does not match "
                f"the tenant table template {self.structure!r}; cannot "
                "hot-register")
        got_sig = _stack_signature(tree)
        if got_sig != self.signature:
            raise ValueError(
                f"tenant packing meta signature {got_sig!r} does not "
                f"match the tenant table template {self.signature!r}; "
                "heterogeneous-codec fleets need the dynamic "
                "(tenant_capacity=None) engine")

    def alloc(self) -> int:
        """Claim the lowest free row; ValueError when the table is full."""
        if not self._free:
            raise ValueError(
                f"tenant table full ({self.capacity} rows); retire a "
                "tenant or raise tenant_capacity")
        return self._free.pop(0)

    def free(self, row: int) -> None:
        if row in self._free or not 1 <= row <= self.capacity:
            raise ValueError(f"bad tenant-table row free: {row}")
        self._free.append(row)
        self._free.sort()

    def write(self, row: int, tree: Any) -> None:
        """Fill ``row`` from a runtime delta tree on the table's device,
        in place (scale cast to f32, zero to int32)."""
        self._write_jit.record(self.signature)
        _write_row(self.stacked, row, self._cut(tree))

    def clear(self, row: int) -> None:
        """Tombstone ``row``: the zero delta, written in place."""
        self._write_jit.record(self.signature)
        _write_row(self.stacked, row, None)


# ---------------------------------------------------------------------------
# Continuous-batching engine
# ---------------------------------------------------------------------------
class ContinuousEngine:
    """Continuous-batching server over one base model + N deltas.

    Usage::

        eng = ContinuousEngine(cfg, base_params, n_slots=8, max_seq=256)
        eng.register_tenant("math", deltas)
        req = eng.submit("math", prompt, max_new_tokens=16,
                         on_token=lambda r, tok, done: ...)
        eng.run()                      # drains queue + slots
        req.output()                   # np.ndarray of generated tokens

    Runs on the device of ``base_params``. Every step is eager: one
    whole-prompt prefill per admitted request (batch 1, left-padded to
    its length bucket — exact for ssm/rec archs — base requests on the
    all-zero delta tree) and one
    decode call over all ``n_slots`` rows, whose tenant rows are sorted
    into segments (``slot_dispatch="segments"``) or gathered per row
    (``"per_row"``). The step's one device-to-host copy is the
    ``[n_slots]`` next tokens, plus one argmax read per prefill.

    ``chunked_prefill=`` swaps the whole-prompt prefill for the chunk
    state machine: admission claims the KV slot (reset to the clean
    template) and queues the request on an EDF
    :class:`~repro_torch.serve.scheduler.ChunkQueue`; every step then runs
    all decode rows plus at most one ``chunk_size``-token prompt chunk
    through the same tenant-segment delta dispatch. ``chunk_share`` is
    the SLO knob (:class:`~repro_torch.serve.scheduler.ChunkBudget`).
    Rows that are free or mid-prefill are decoded with the rest and get
    their ring entry and ssm/rec state back afterwards
    (``SlotKVCache.restore_entries``), bit for bit.

    Tenants of any codec register: each tree is lowered to the
    PackedDelta runtime layout once, at registration. Tenants whose
    packings differ (codec, group size, quantization width) land in
    separate codec groups (:class:`_CodecGroup`), one stack each; every
    step runs one correction per group and site and sums them
    (``core.apply.MultiSlotDelta``), exact because a row's other groups
    map it to their zero row.

    ``tenant_capacity=`` switches the lifecycle to TABLE mode: a
    :class:`TenantTable` of ``capacity + 1`` rows (built from the first
    tenant's tree, or seeded from a pre-populated ``store``) whose rows
    are written and tombstoned in place, so register, rollout and retire
    never re-stack (``restacks`` counts the dynamic path's re-stacks).
    A rollout lands in a new row; in-flight sequences drain on the old
    one, which is then cleared and freed.

    ``residency_budget_bytes=`` builds the :class:`DeltaResidency` tier
    of pre-decoded values over the tenant stack (segments dispatch, one
    codec group). It serves values only for a stack on the CPU; on the
    card every step is a packed step, as on a TPU running the reference's
    Pallas kernels.

    ``mesh=`` (a ``launch.mesh.ServingMesh`` from ``make_serving_mesh``)
    serves the same loop sharded, SPMD: every rank runs this engine on
    the same requests and the same host decisions. The base is cut to
    the rank's column-parallel slice (``launch.mesh.shard_params``), KV
    rings to its kv-heads and ssm/rg-lru states to its width
    (``cache_shardings``), and each codec group's stack to its
    output-column slice at registration (``shard_deltas="auto"``; or
    whole, ``"replicated"``); prefills read a tenant's row of that stack.
    Every linear site's output is gathered over ``model`` after the site
    (``core.apply`` mesh mode, installed per step by
    :meth:`_install_mesh`, so mesh and plain engines coexist in one
    process), so the tokens are the unsharded engine's. ``data=``
    (default: the mesh's ``data`` extent) splits the slot rows into
    contiguous pools: admission balances per-pool occupancy, the decode
    step's segment layout is built per pool, and a rank stores and
    computes only its pool's rows — prefills into its pool, decode over
    its rows — then the ranks all-gather each step's next tokens over
    ``data``, so every rank's scheduler, stop checks and ``Metrics`` see
    the same state. Without a mesh ``data > 1`` keeps the pools as a
    host-side policy over one cache.

    ``trace=`` (a :class:`~repro_torch.serve.trace.Tracer`), ``slo=`` (a
    :class:`~repro_torch.serve.telemetry.SLOCounters`) and ``telemetry=``
    (a :class:`~repro_torch.serve.telemetry.TelemetrySnapshotWriter`)
    attach observability: every hook site emits one typed event on
    ``self.bus`` and all consumers — ``Metrics`` too — read that stream.
    Timestamps come only from the injectable clock, read where the
    reference reads it, so reports are deterministic under
    ``VirtualClock`` and equal the reference's on the same trace.
    """

    def __init__(self, cfg: ArchConfig, base_params: Any, *,
                 n_slots: int = 8, max_seq: int = 256, min_bucket: int = 8,
                 store: Optional[DeltaStore] = None, clock=time.monotonic,
                 mesh=None, data: Optional[int] = None,
                 slot_dispatch: str = "segments",
                 shard_deltas: str = "auto",
                 admission="occupancy",
                 residency_budget_bytes: Optional[int] = None,
                 tenant_capacity: Optional[int] = None,
                 chunked_prefill: bool = False, chunk_size: int = 16,
                 chunk_share: float = 1.0,
                 trace=None, slo=None, telemetry=None):
        if cfg.family in ("encdec", "vlm"):
            raise ValueError(
                f"continuous batching does not support family={cfg.family!r} "
                "(per-request encoder inputs); use Engine.generate")
        lm._check_family(cfg)
        from repro_torch.launch import mesh as mesh_lib
        if mesh is not None and not isinstance(mesh, mesh_lib.ServingMesh):
            raise TypeError(f"mesh= takes a launch.mesh.ServingMesh, got "
                            f"{type(mesh).__name__}")
        mesh_data = mesh.shape.get("data", 1) if mesh is not None else 1
        if data is None:
            data = mesh_data
        if mesh is not None and data != mesh_data:
            raise ValueError(
                f"data={data} does not match the mesh's data axis "
                f"({mesh_data}); slot pools must mirror the device shards")
        if data < 1 or n_slots % data:
            raise ValueError(
                f"n_slots={n_slots} must be a positive multiple of "
                f"data={data} (equal contiguous shard pools)")
        if slot_dispatch not in ("segments", "per_row"):
            raise ValueError(f"slot_dispatch={slot_dispatch!r} not in "
                             "('segments', 'per_row')")
        if shard_deltas not in ("auto", "replicated"):
            raise ValueError(f"shard_deltas={shard_deltas!r} not in "
                             "('auto', 'replicated')")
        self.cfg = cfg
        self.mesh = mesh
        self.data = data
        self.shard_deltas = shard_deltas
        self.slot_dispatch = slot_dispatch
        cache_sh = None
        if mesh is not None:
            # this rank's column-parallel slice of the base, cut once
            base_params = mesh_lib.shard_params(cfg, base_params, mesh)
            cache_sh = mesh_lib.cache_shardings(cfg, mesh, n_slots, max_seq)
        self.base = base_params
        self.device = base_params["embed"]["tok"].device
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.store = store if store is not None else DeltaStore()
        if tenant_capacity is not None:
            if int(tenant_capacity) < 1:
                raise ValueError(
                    f"tenant_capacity must be >= 1, got {tenant_capacity}")
            if len(self.store.names()) > int(tenant_capacity):
                raise ValueError(
                    f"store already holds {len(self.store.names())} tenants "
                    f"> tenant_capacity={tenant_capacity}")
        self.tenant_capacity = (None if tenant_capacity is None
                                else int(tenant_capacity))
        # pre-decoded delta residency: built with the tenant stack (one
        # codec group, segments dispatch), consulted for a CPU stack
        self.residency_budget_bytes = residency_budget_bytes
        self.residency: Optional[DeltaResidency] = None
        self._table: Optional[TenantTable] = None
        self._retiring: set = set()      # rolled-out rows awaiting drain
        self.restacks = 0                # dynamic re-stacks of the tenant rows
        # ssm/rec mixers carry sequence state, so left-padding would
        # pollute it: bucket those archs by exact prompt length instead
        exact = any(k in ("ssm", "rec") for k in cfg.layer_kinds)
        self.buckets = LengthBuckets(min_bucket=min_bucket,
                                     max_bucket=max_seq, exact=exact)
        self.chunked = bool(chunked_prefill)
        self.chunk_size = int(chunk_size)
        self.chunk_share = float(chunk_share)
        if self.chunked:
            # a chunk may not exceed any layer's ring: its C tokens must
            # land in C distinct slots
            min_ring = min((max_seq if w == 0 else min(w, max_seq))
                           for _, _, w in lm.layer_plan(cfg))
            if not 1 <= self.chunk_size <= min_ring:
                raise ValueError(
                    f"chunk_size={chunk_size} must be in [1, {min_ring}] "
                    f"(the smallest attention ring of this arch/max_seq)")
        # ssm/rec mixers cannot consume right-padded tail chunks (pad
        # tokens would pollute the carried state): exact archs get
        # exact-length tail chunks, attention-only archs pad every chunk
        # to chunk_size (pad K/V writes never reach the ring)
        self._chunk_pad = not exact
        self._chunks = ChunkQueue(self.chunk_size)
        self._chunk_budget = ChunkBudget(self.chunk_share)
        self._chunk_t0: dict[int, float] = {}    # rid -> admit time
        self.queue = RequestQueue()
        self.sched = Scheduler(n_slots, self.buckets, data_shards=data,
                               admission=admission)
        self.kv = SlotKVCache(cfg, n_slots, max_seq, shardings=cache_sh,
                              data_shards=data, mesh=mesh, device=self.device)
        # the slot rows this process computes: its pool's under a mesh
        # with data > 1, all of them otherwise
        self._here = self.kv.rows
        self.metrics = Metrics(n_slots, data_shards=data)
        self.clock = clock
        self.trace = trace
        self.slo = slo
        self.telemetry = telemetry
        self.bus = EventBus([self.metrics, trace, slo])
        # path-attribution notes per call signature. The reference's
        # dispatch notes fire only while jax traces; here they fire on
        # every call, so a call whose argument shapes its entry point has
        # not seen (what would retrace a jit there) emits the jit_trace
        # event and later calls replay the signature's notes
        self._path_notes: dict = {}
        # each entry point's signatures: the reference's jits' compile
        # caches (analysis.CompileGuard's ENTRY_PATHS)
        self._prefill = Signatures()
        self._decode = Signatures()
        self._decode_masked = Signatures()
        self._combined = Signatures()

        # host mirrors of per-slot decode state (row 0 = zero delta / base)
        self._tok = np.zeros(n_slots, np.int64)
        self._pos = np.zeros(n_slots, np.int64)
        self._row = np.zeros(n_slots, np.int32)

        # one tenant stack per codec group, the zero delta at each row 0
        self._groups: List[_CodecGroup] = []
        # unstacked all-zero tree (base prefill): a view of group 0's row 0
        self._zero_tree = None
        self._rows: dict[str, int] = {}
        self._store_version = -1
        self._t0: Optional[float] = None
        self.prefill_shapes: set = set()

        # table mode over a pre-populated store: seed the table with the
        # existing tenants (registration order), exactly as if each had
        # been hot-registered
        if self.tenant_capacity is not None and self.store.names():
            for t in self.store.ordered():
                self._table_admit(t.name,
                                  self._on_device(runtime_delta_tree(t.deltas)))
            self._store_version = self.store.version

    # -- tenants ------------------------------------------------------------
    def _on_device(self, tree: Any) -> Any:
        """A runtime delta tree on the engine's device (no copy where it
        already is)."""
        return _map_packed(lambda d: d.to(self.device), tree)

    def _cut(self, tree: Any) -> Any:
        """This rank's output-column slice of a runtime tree, as views (the
        stacks copy them into their rows), or the tree itself without a
        mesh or with ``shard_deltas="replicated"``."""
        if self.mesh is None or self.shard_deltas != "auto":
            return tree
        from repro_torch.launch.mesh import shard_delta_tree
        return shard_delta_tree(tree, self.mesh, copy=False)

    def _prefill_deltas(self, tenant: Optional[str]) -> Any:
        """The deltas a prefill of ``tenant``'s request applies: its
        registered tree; under a mesh, its row of its group's stack
        (views of this rank's slice, cut at registration)."""
        if tenant is None:
            return self._zero_tree    # None when no tenants registered
        if self.mesh is None:
            return self.store.get(tenant).deltas
        grow = self._rows[tenant]
        for g in self._groups:
            if g.lut[grow]:
                return _row_view(g.stacked, int(g.lut[grow]))
        raise KeyError(f"tenant {tenant!r} is in no codec group")

    def register_tenant(self, name: str, deltas: Any, report=None) -> Tenant:
        """Register (or roll out a new version of) a tenant.

        ``deltas`` may be any codec's compressed tree, on any device; it is
        lowered to the PackedDelta runtime layout and moved to the
        engine's device here, once. A tenant whose tree cannot join the
        engine fails here, not mid-run inside a prefill, and a rejected
        registration leaves the engine untouched.

        Table mode: the tenant fills a free table row in place; re-register
        of an existing name is the rollout path — the new version lands in
        a fresh row and only NEW requests see it. Dynamic mode re-stacks
        its codec group and refuses a same-name re-register while the
        tenant has in-flight sequences.
        """
        rt = self._on_device(runtime_delta_tree(deltas))
        if self.tenant_capacity is not None:
            rollout = name in self._rows
            old = self._rows.get(name)
            row, _ = self._table_admit(name, rt)     # raises pre-mutation
            t = self.store.register(name, rt, report, replace=rollout)
            self._store_version = self.store.version
            if rollout:
                self.bus.emit("tenant_rollout", self._now(), tenant=name,
                              row=row, old_row=old,
                              retiring=len(self._retiring))
            else:
                self.bus.emit("tenant_register", self._now(), tenant=name,
                              row=row, free_rows=self._table.n_free)
            return t
        replace = name in self.store.names()
        if replace and self._tenant_in_flight(name):
            raise RuntimeError(
                f"tenant {name!r} has in-flight sequences; re-registering "
                "would switch their deltas mid-sequence — drain first, or "
                "serve with tenant_capacity= for hot version rollout")
        snap = self.store.snapshot()
        t = self.store.register(name, rt, report, replace=replace)
        try:
            self._refresh_stacked()
        except (ValueError, RuntimeError):
            self.store.restore(snap)
            raise
        self.bus.emit("tenant_rollout" if replace else "tenant_register",
                      self._now(), tenant=name,
                      row=self._rows.get(name), old_row=None)
        return t

    def unregister_tenant(self, name: str) -> None:
        """Retire a tenant.

        Table mode tombstones its row in place (zeroed and returned to the
        free list — no other tenant's row shifts). Dynamic mode re-stacks
        the remaining tenants. Both refuse while the tenant has in-flight
        sequences or queued requests, and a refused retire leaves the
        engine untouched."""
        self.store.get(name)             # KeyError early for unknown names
        if self._tenant_in_flight(name):
            raise RuntimeError(
                f"tenant {name!r} has in-flight sequences; drain before "
                "retiring")
        if any(r.tenant == name for r in self.queue.pending()):
            raise RuntimeError(
                f"tenant {name!r} has queued requests; drain before "
                "retiring")
        if self.tenant_capacity is not None:
            row = self._rows.pop(name)
            self.store.unregister(name)
            self._store_version = self.store.version
            self._table.clear(row)
            self._table.free(row)
            if self.residency is not None:
                self.residency.invalidate([row])
            self._sync_table_group()
            self.bus.emit("tenant_retire", self._now(), tenant=name,
                          row=row, free_rows=self._table.n_free)
            return
        snap = self.store.snapshot()
        self.store.unregister(name)
        try:
            self._refresh_stacked()
        except (ValueError, RuntimeError):
            self.store.restore(snap)
            raise
        self.bus.emit("tenant_retire", self._now(), tenant=name, row=None)

    def _tenant_in_flight(self, name: str) -> bool:
        return any(self.sched.slots[s].request.tenant == name
                   for s in self.sched.active_slots())

    # -- tenant table (hot lifecycle) ---------------------------------------
    def _table_admit(self, name: str, rt: Any) -> tuple:
        """Fill a tenant-table row for ``name`` (no store writes, no
        events — seeding and hot registration both route here). Returns
        ``(row, old_row)``. Everything fallible happens before the first
        mutation, so a rejected tenant leaves the engine untouched."""
        _refuse_expert_deltas(rt)
        if self._table is None:
            # the first tenant fixes the template: the envelope is built
            # once, here, as ONE group with an identity LUT for the
            # table's whole life
            table = TenantTable(rt, self.tenant_capacity, mesh=self.mesh,
                                shard_deltas=self.shard_deltas)
            self._table = table
            self._zero_tree = _row_view(table.stacked, 0)
            lut = np.arange(self.tenant_capacity + 1, dtype=np.int32)
            codecs = tuple(sorted({sig[6] for sig in table.signature}))
            self._groups = [_CodecGroup(
                stacked=table.stacked, lut=lut, names=[], codecs=codecs,
                shapes=_stack_signature(table.stacked))]
            if self.residency_budget_bytes and self.slot_dispatch == "segments":
                self.residency = DeltaResidency(table.stacked,
                                                self.residency_budget_bytes)
        else:
            self._table.check_compatible(rt)
        self._reclaim_retired()
        row = self._table.alloc()        # ValueError when full, pre-mutation
        old = self._rows.get(name)
        self._table.write(row, rt)
        if self.residency is not None:
            # a resident copy of this row would be stale after the write
            self.residency.invalidate([row])
        self._rows[name] = row
        if old is not None:
            # rollout: in-flight sequences keep decoding the old row
            # until they drain; tombstone it now if nothing references it
            live = {int(self.sched.slots[s].tenant_row)
                    for s in self.sched.active_slots()}
            if old in live:
                self._retiring.add(old)
            else:
                self._table.clear(old)
                self._table.free(old)
                if self.residency is not None:
                    self.residency.invalidate([old])
        self._sync_table_group()
        return row, old

    def _sync_table_group(self) -> None:
        """Bookkeeping after a row write: the group's tenant names (the
        table is written in place, so dispatch needs nothing else; the
        residency tier is pointed at the same arrays)."""
        self._groups[0].names = [
            n for n, _ in sorted(self._rows.items(), key=lambda kv: kv[1])]
        if self.residency is not None:
            self.residency.retarget(self._table.stacked)

    def _reclaim_retired(self) -> None:
        """Tombstone rolled-out rows once their last in-flight sequence
        drains (lazy: checked at request finish and before row alloc)."""
        if not self._retiring:
            return
        live = {int(self.sched.slots[s].tenant_row)
                for s in self.sched.active_slots()}
        done = sorted(self._retiring - live)
        if not done:
            return
        for row in done:
            self._table.clear(row)
            self._table.free(row)
            self._retiring.discard(row)
            if self.residency is not None:
                self.residency.invalidate([row])
        self._sync_table_group()

    def _refresh_stacked(self) -> None:
        """Re-stack the tenant rows after a store change (dynamic mode):
        tenants partitioned into codec groups by packing signature
        (first-fit in registration order), each group's stack with the
        zero delta at row 0. Runs once per store version, never per step.
        Every check (tree structure, rows shifted under in-flight
        requests) comes before any change, so a rejected register or
        unregister leaves the engine as it was."""
        if self.tenant_capacity is not None:
            return   # table mode: dispatch state is maintained per row write
        if self._store_version == self.store.version:
            return
        tenants = self.store.ordered()
        new_rows = {t.name: i + 1 for i, t in enumerate(tenants)}
        buckets: List[tuple] = []        # (signature, [(global_row, Tenant)])
        if tenants:
            ref_struct = _tree_structure(tenants[0].deltas)
            for i, t in enumerate(tenants):
                _refuse_expert_deltas(t.deltas)
                if _tree_structure(t.deltas) != ref_struct:
                    # codec groups relax the *packing* meta, not the tree
                    # shape: combining per-group corrections needs every
                    # group's tree to mirror the same param sites
                    raise ValueError(
                        "tenant delta trees differ in structure; "
                        "cannot stack for slot dispatch")
                sig = _stack_signature(t.deltas)
                for bsig, members in buckets:
                    if bsig == sig:
                        members.append((i + 1, t))
                        break
                else:
                    buckets.append((sig, [(i + 1, t)]))
        # registration is append-only so rows never shift — but a live
        # unregister would remap rows under in-flight sequences, silently
        # decoding them with another tenant's delta. Refuse instead.
        for slot in self.sched.active_slots():
            state = self.sched.slots[slot]
            want = new_rows.get(state.request.tenant, 0) \
                if state.request.tenant else 0
            if want != state.tenant_row:
                raise RuntimeError(
                    f"tenant stack rows shifted under in-flight request "
                    f"{state.request.rid} (tenant {state.request.tenant!r}); "
                    "drain the engine before unregistering tenants")
        # drop the old stacks before building the new ones: one stacked
        # copy at a time (a failed build leaves the engine stale, so the
        # next refresh builds again)
        self._groups, self._zero_tree, self.residency = [], None, None
        self._store_version = -1
        groups = []
        n_global = len(tenants) + 1
        for _, members in buckets:
            # under a mesh each rank's stack holds its output-column slice,
            # cut here, at registration, never per step
            stacked = _alloc_rows(self._cut(members[0][1].deltas), len(members) + 1)
            lut = np.zeros(n_global, np.int32)
            for local, (grow, t) in enumerate(members, start=1):
                _write_row(stacked, local, self._cut(t.deltas))
                lut[grow] = local
            groups.append(_CodecGroup(
                stacked=stacked, lut=lut, names=[t.name for _, t in members],
                codecs=tuple(sorted({c for _, t in members for c in t.codecs()})),
                shapes=_stack_signature(stacked)))
        self.restacks += 1
        self._groups = groups
        self._zero_tree = _row_view(groups[0].stacked, 0) if groups else None
        if groups and self.residency_budget_bytes \
                and self.slot_dispatch == "segments" and len(groups) == 1:
            # the tier keys its value buffers to ONE stack's rows;
            # mixed-codec engines serve packed (still correct)
            self.residency = DeltaResidency(groups[0].stacked,
                                            self.residency_budget_bytes)
        self._rows = new_rows
        self._store_version = self.store.version

    # -- request API --------------------------------------------------------
    def submit(self, tenant: Optional[str], prompt: np.ndarray, *,
               max_new_tokens: int = 16, stop_token: Optional[int] = None,
               arrival: float = 0.0, deadline: Optional[float] = None,
               on_token=None) -> Request:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.buckets.bucket(len(prompt))   # raises if no bucket fits
        # live positions are 0..L+new-1; left-pad slots carry invalid
        # positions and may be overwritten
        if len(prompt) + max_new_tokens > self.max_seq:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_seq={self.max_seq}")
        if tenant is not None:
            self.store.get(tenant)   # KeyError early for unknown tenants
        req = self.queue.submit(tenant, prompt, max_new_tokens=max_new_tokens,
                                stop_token=stop_token, arrival=arrival,
                                deadline=deadline, on_token=on_token)
        self.bus.emit("submit", req.arrival, rid=req.rid, tenant=tenant,
                      prompt_len=len(prompt), max_new_tokens=max_new_tokens,
                      deadline=deadline)
        return req

    # -- scheduling core ----------------------------------------------------
    def _now(self) -> float:
        """Engine-relative time; the timebase of Request.arrival/deadline."""
        if self._t0 is None:
            self._t0 = self.clock()
        return self.clock() - self._t0

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device)

    def _install_mesh(self) -> None:
        """Install THIS engine's mesh (or None) as the process-wide apply
        mode before its step runs, so engines with different meshes (or
        none) coexist in one process."""
        from repro_torch.core.apply import set_mesh
        set_mesh(self.mesh)

    def _pooled(self) -> bool:
        """Whether this rank computes only its pool's slot rows."""
        return self.mesh is not None and self.data > 1

    def _all_rows(self, t: torch.Tensor) -> torch.Tensor:
        """A step's per-row result over this rank's rows -> over all
        ``n_slots`` rows (all-gathered over ``data`` in pool order)."""
        return self.mesh.all_gather(t, "data", dim=0) if self._pooled() else t

    def _from_owner(self, t: Optional[torch.Tensor], slot: int) -> torch.Tensor:
        """A token the ranks of ``slot``'s pool computed (``t``; None on the
        other pools' ranks), on every rank: an all-gather over ``data``
        that every rank makes at the same point of the same step."""
        if not self._pooled():
            return t
        buf = t.reshape(1).to(torch.int64) if t is not None else \
            torch.full((1,), -1, dtype=torch.int64, device=self.device)
        return self.mesh.all_gather(buf, "data", dim=0)[self.kv.shard_of(slot)]

    @property
    def decode_traces(self) -> int:
        """jit_trace events of the step's signatures (decode,
        decode_masked, combined): the reference's decode recompiles."""
        return self._decode.traces + self._decode_masked.traces + self._combined.traces

    def _record_path(self, sig: tuple, shapes: tuple, site: str, notes: list,
                     now: float) -> tuple:
        """Emit ``jit_trace`` when this call's argument shapes are new
        (``sig`` plus ``shapes``: what would retrace a jit in the
        reference, e.g. a re-stack's new leading dimension), with
        ``first`` unless ``sig`` was seen before, as
        ``src/repro/serve/engine.py:1425-1429`` does; return (the
        signature's memoised notes, whether this call emitted)."""
        # a call without notes (no deltas) has its own signature, so it
        # never hides a later traced call's
        entry = getattr(self, f"_{site}")
        traced = entry.record((sig, shapes)) and bool(notes)
        if traced:
            entry.traces += 1
            self.bus.emit("jit_trace", now, signature=sig, site=site,
                          first=sig not in self._path_notes, notes=list(notes))
            self._path_notes[sig] = list(notes)
        return self._path_notes.get(sig, []), traced

    def _prefill_into(self, slot: int, req: Request, now: float) -> None:
        self._refresh_stacked()
        L = req.prompt_len
        bucket = self.buckets.bucket(L)
        pad = bucket - L
        host = np.zeros((2, bucket), np.int64)
        host[0, pad:] = req.prompt                        # tokens
        host[1] = np.arange(bucket) - pad                 # positions
        deltas = self._prefill_deltas(req.tenant)
        self.prefill_shapes.add(bucket)
        top = None
        if self.kv.holds(slot):
            # under a mesh with data > 1 only the ranks of the slot's pool
            # prefill it; the others receive its first token
            batch = self._to_device(host)
            row_cache = self.kv.empty_row()
            with attribution() as notes:
                logits, row_cache = lm.prefill(
                    self.cfg, self.base,
                    {"tokens": batch[0:1], "positions": batch[1:2]},
                    row_cache, deltas=deltas)
            self._record_path(("prefill", bucket),
                              _stack_signature(deltas) if deltas is not None else None,
                              "prefill", notes, now)
            self.kv.insert(slot, row_cache)
            top = torch.argmax(logits[0])
        first = int(self._from_owner(top, slot))
        t_first = self._now()
        slack = None if req.deadline is None else req.deadline - now
        self.bus.emit("admit", now, rid=req.rid, tenant=req.tenant, slot=slot,
                      wait=now - req.arrival, deadline_slack=slack,
                      prompt_len=L, bucket=bucket)
        self.bus.emit("prefill", t_first, rid=req.rid, tenant=req.tenant,
                      t_start=now, prompt_len=L, bucket=bucket, slot=slot)
        self.bus.emit("first_token", t_first, rid=req.rid, tenant=req.tenant,
                      ttft=t_first - req.arrival)
        self.bus.emit("token", t_first, rid=req.rid, tenant=req.tenant)
        if self.data > 1:
            self.bus.emit("shard_token", t_first, shard=self.sched.shard_of(slot))
        req.t_first_token = t_first
        fin = req.emit(first)

        self._tok[slot] = first
        self._pos[slot] = L
        self._row[slot] = self._rows.get(req.tenant, 0) if req.tenant else 0
        self.sched.place(slot, SlotState(request=req, next_token=first,
                                         pos=L, tenant_row=self._row[slot]))
        if fin:
            self._finish(slot, t_first)

    def _finish(self, slot: int, now: float) -> None:
        state = self.sched.slots[slot]
        req = state.request
        req.t_done = now
        ttft = None if req.t_first_token is None \
            else req.t_first_token - req.arrival
        slack = None if req.deadline is None else req.deadline - now
        self.bus.emit("done", now, rid=req.rid, tenant=req.tenant,
                      latency=now - req.arrival, ttft=ttft,
                      n_tokens=len(req.tokens), deadline_slack=slack)
        self.sched.release(slot)
        self.kv.release(slot)
        # park the freed slot on tenant row 0 so stale rows don't inflate
        # the unique-tenant segment count of subsequent decode steps
        self._row[slot] = 0
        if self._retiring:
            # a rollout's old row may just have lost its last reference
            self._reclaim_retired()

    # -- chunked prefill ----------------------------------------------------
    def _admit_chunked(self, slot: int, req: Request, now: float) -> None:
        """Claim a slot for chunked prefill: no device prefill happens
        here — the request joins the EDF chunk queue and the combined
        step streams its prompt in ``chunk_size``-token chunks."""
        self._refresh_stacked()
        # the previous occupant's ring pos markers would be attended as
        # valid context by mid-sequence appends: reset first
        self.kv.reset(slot)
        row = self._rows.get(req.tenant, 0) if req.tenant else 0
        self._row[slot] = row
        self._tok[slot] = 0
        self._pos[slot] = 0
        self.sched.place(slot, SlotState(request=req, next_token=0, pos=0,
                                         tenant_row=row, prefilling=True))
        self._chunks.add(slot, req)
        self._chunk_t0[req.rid] = now
        slack = None if req.deadline is None else req.deadline - now
        self.bus.emit("admit", now, rid=req.rid, tenant=req.tenant, slot=slot,
                      wait=now - req.arrival, deadline_slack=slack,
                      prompt_len=req.prompt_len, bucket=None)

    def _combined_step(self, now: float) -> bool:
        """One chunked-mode step: all decode rows + at most one prompt
        chunk. Returns False when idle."""
        active = self.sched.active_slots()
        decode_slots = [s for s in active
                        if not self.sched.slots[s].prefilling]
        task = None
        if self._chunk_budget.grant(len(decode_slots), len(self._chunks)):
            task = self._chunks.next_task()
        if task is None and not decode_slots:
            return False
        self._refresh_stacked()
        act = np.zeros(self.n_slots, bool)
        act[decode_slots] = True
        # parked slots (free, or mid-prefill) are masked to tenant row 0
        # so their tenants are not dequantized and don't inflate the
        # unique-tenant segment count
        rows_eff = np.where(act, self._row, 0)
        # every host-to-device copy of the step before its first launch;
        # this rank's rows only (its pool's under a mesh with data > 1)
        sd, res_used = self._slot_delta(rows_eff)
        lo, hi = self._here
        dev = self._to_device(np.stack([self._tok[lo:hi], self._pos[lo:hi],
                                        act[lo:hi].astype(np.int64)]))
        tok_d, pos_d, act_d = dev[0][:, None], dev[1], dev[2].bool()
        if task is not None:
            req = task.request
            C = self.chunk_size if self._chunk_pad else task.length
            host = np.zeros((3, C), np.int64)
            host[0, :task.length] = req.prompt[task.start:
                                               task.start + task.length]
            # pad positions run past every real query position, so the
            # padded keys are causally masked; their K/V never reach the
            # ring (valid mask)
            host[1] = task.start + np.arange(C)
            host[2, :task.length] = 1
            chunk = self._to_device(host)
            cd, _ = self._slot_delta(self._row[task.slot:task.slot + 1],
                                     resident=False)
        cache = self.kv.cache
        masked = not act[lo:hi].all()
        with attribution() as notes:
            # parked rows decode too (fixed batch); their ring entries are
            # saved first and put back after the step, bit for bit
            saved = self.kv.ring_entries(pos_d) if masked else None
            logits, _ = lm.decode_step(self.cfg, self.base, cache, tok_d, pos_d,
                                       deltas=sd)
            nxt = torch.argmax(logits, dim=-1)
            if masked:
                self.kv.restore_entries(pos_d, saved, act_d)
            cn = None
            if task is not None and self.kv.holds(task.slot):
                # the chunk row is prefilled against its restored, clean
                # ring, through views of the shared cache (by the ranks of
                # its pool)
                i = self.kv.local(task.slot)
                row = lm.cache_rows(cache, i, i + 1)
                clog, _ = lm.prefill_chunk(
                    self.cfg, self.base,
                    {"tokens": chunk[0:1], "positions": chunk[1:2],
                     "valid": chunk[2:3].bool()}, row, deltas=cd)
                cn = torch.argmax(clog[0], dim=-1)
        if task is None:
            sig = ("decode_masked", len(self._groups), bool(res_used))
            site = "decode_masked"
        else:
            sig = ("combined", chunk.shape[1], len(self._groups), bool(res_used))
            site = "combined"
        path_notes, recompiled = self._record_path(sig, self._group_shapes(), site,
                                                   notes, now)
        nxt = self._all_rows(nxt).cpu().numpy()
        if task is not None and task.last:
            first = int(self._from_owner(
                cn[task.length - 1] if cn is not None else None, task.slot))
        t = self._now()
        self.bus.emit(
            "step", t, t_start=now, n_active=len(decode_slots),
            chunk_tokens=task.length if task is not None else 0,
            shard_active=self.sched.shard_occupancy() if self.data > 1 else None,
            shard_unique=self.sched.shard_unique_tenants(rows_eff),
            residency_used=res_used,
            path="base" if sd is None else path_label(path_notes),
            notes=path_notes, recompiled=recompiled)
        for slot in decode_slots:
            state = self.sched.slots[slot]
            req = state.request
            tok = int(nxt[slot])
            self._tok[slot] = tok
            self._pos[slot] += 1
            state.next_token = tok
            state.pos = int(self._pos[slot])
            fin = req.emit(tok)
            self.bus.emit("token", t, rid=req.rid, tenant=req.tenant)
            if self.data > 1:
                self.bus.emit("shard_token", t, shard=self.sched.shard_of(slot))
            if fin:
                self._finish(slot, t)
        if task is not None:
            req = task.request
            self._chunks.advance(task)
            state = self.sched.slots[task.slot]
            state.pos = task.start + task.length
            self.bus.emit("prefill_chunk", t, rid=req.rid, tenant=req.tenant,
                          slot=task.slot, t_start=now, start=task.start,
                          length=task.length, last=task.last,
                          n_decode=len(decode_slots))
            if task.last:
                # the final chunk's last real position predicts the first
                # generated token (``first`` above), as whole-prompt
                # prefill's last row does
                L = req.prompt_len
                self.bus.emit("prefill", t, rid=req.rid, tenant=req.tenant,
                              t_start=self._chunk_t0.pop(req.rid, now),
                              prompt_len=L, bucket=None, slot=task.slot)
                self.bus.emit("first_token", t, rid=req.rid,
                              tenant=req.tenant, ttft=t - req.arrival)
                self.bus.emit("token", t, rid=req.rid, tenant=req.tenant)
                if self.data > 1:
                    self.bus.emit("shard_token", t,
                                  shard=self.sched.shard_of(task.slot))
                req.t_first_token = t
                self._tok[task.slot] = first
                self._pos[task.slot] = L
                state.prefilling = False
                state.next_token = first
                state.pos = L
                fin = req.emit(first)
                if fin:
                    self._finish(task.slot, t)
        return True

    def _slot_delta(self, rows: np.ndarray, resident: bool = True):
        """Per-slot delta dispatch tree for one step and whether the
        residency tier served it: ``(sd, res_used)``, ``(None, None)`` with
        no tenants. ``rows`` is the [n_slots] GLOBAL tenant-row vector a
        decode step serves (the chunked path masks parked slots to row
        0), or the one row of a prompt chunk, which threads the SAME
        segment dispatch as decode (on the card the segments kernel at
        T = ``chunk_size``). Each codec group gets its group-local rows —
        slots owned by another group's tenants (and base slots) map to
        this group's zero row and contribute an exact 0.0 — and, for the
        segments dispatch, their tenant-sorted layout (built on the host,
        copied to the device once), which leaves the zero row's segment
        out so those rows are zero-filled, not decoded; the groups' trees
        are combined into MultiSlotDelta leaves.

        With a residency tier (one group, segments dispatch) a decode step
        (``resident``; a prompt chunk is not) promotes its tenants and
        attaches their values when the stack lies on the CPU — the port's
        form of the reference's ``not get_use_pallas()``
        (``repro/serve/engine.py:1373``); ``res_used`` is False when the
        step runs packed (over capacity, or a stack on the card), None
        without a tier."""
        if not self._groups:
            return None, None
        parts = []
        res_used = None
        # a decode step's full slot vector with data > 1 takes the
        # per-pool layout (each pool sorted on its own; a mesh rank then
        # computes its own pool's block and rows); a prompt chunk's one row
        # takes the single-pool form
        pooled = self.data > 1 and len(rows) == self.n_slots
        lo, hi = self._here if pooled else (0, len(rows))
        for g in self._groups:
            rows_g = g.lut[rows]
            seg = None
            values = res_map = None
            if self.slot_dispatch == "segments":
                if pooled:
                    seg = tenant_segments_sharded(rows_g, self.data,
                                                  skip_zero_row=True).to(self.device)
                else:
                    seg = tenant_segments(rows_g, skip_zero_row=True).to(self.device)
                if self.residency is not None and resident:
                    rm = None
                    if self.residency.device.type == "cpu":
                        rm = self.residency.ensure(rows_g)
                    res_used = rm is not None
                    if res_used:
                        values = self.residency.values
                        res_map = self._to_device(rm.astype(np.int64))
            parts.append(wrap_slot_deltas(
                g.stacked, self._to_device(rows_g[lo:hi].astype(np.int64)),
                segments=seg, values=values, res_map=res_map))
        return combine_slot_deltas(parts), res_used

    def _group_shapes(self) -> tuple:
        """The codec groups' stack shapes (a reference jit's retrace key)."""
        return tuple(g.shapes for g in self._groups)

    def _decode_all(self, now: float) -> None:
        active = self.sched.active_slots()
        if not active:
            return
        self._refresh_stacked()
        sd, res_used = self._slot_delta(self._row)
        lo, hi = self._here
        dev = self._to_device(np.stack([self._tok[lo:hi], self._pos[lo:hi]]))
        with attribution() as notes:
            logits, _ = lm.decode_step(self.cfg, self.base, self.kv.cache,
                                       dev[0][:, None], dev[1], deltas=sd)
            nxt = torch.argmax(logits, dim=-1)
        sig = ("decode", len(self._groups), bool(res_used))
        path_notes, recompiled = self._record_path(sig, self._group_shapes(), "decode",
                                                   notes, now)
        nxt = self._all_rows(nxt).cpu().numpy()
        t = self._now()
        self.bus.emit(
            "step", t, t_start=now, n_active=len(active),
            shard_active=self.sched.shard_occupancy() if self.data > 1 else None,
            shard_unique=self.sched.shard_unique_tenants(self._row),
            residency_used=res_used,
            path="base" if sd is None else path_label(path_notes),
            notes=path_notes, recompiled=recompiled)
        for slot in active:
            state = self.sched.slots[slot]
            req = state.request
            tok = int(nxt[slot])
            self._tok[slot] = tok
            self._pos[slot] += 1
            state.next_token = tok
            state.pos = int(self._pos[slot])
            fin = req.emit(tok)
            self.bus.emit("token", t, rid=req.rid, tenant=req.tenant)
            if self.data > 1:
                self.bus.emit("shard_token", t, shard=self.sched.shard_of(slot))
            if fin:
                self._finish(slot, t)

    @torch.no_grad()
    def step(self, now: float) -> bool:
        """One scheduler iteration: admit into free slots, then decode."""
        self._install_mesh()
        worked = False
        for slot, req in self.sched.admit(self.queue, now):
            self.kv.claim(slot)      # kv free list mirrors the slot table
            if self.chunked:
                self._admit_chunked(slot, req, now)
            else:
                self._prefill_into(slot, req, now)
            worked = True
        if self.chunked:
            worked = self._combined_step(now) or worked
        elif self.sched.n_active:
            self._decode_all(now)
            worked = True
        return worked

    def run(self, max_steps: int = 1_000_000) -> Metrics:
        """Drain the queue and all slots; returns the metrics collector."""
        self.bus.emit("start", self._now())
        for _ in range(max_steps):
            if not len(self.queue) and not self.sched.n_active:
                break
            now = self._now()
            if self.mesh is not None:
                # every rank admits against rank 0's clock
                now = self.mesh.agree(now)
            worked = self.step(now)
            if self.telemetry is not None:
                # driven by the same `now` as the step: zero extra clock
                # reads, deterministic snapshot times under VirtualClock
                self.telemetry.maybe_write(now, self._telemetry_payload)
            if not worked:
                # nothing active and no arrived request: jump (virtual
                # clock) or sleep (real clock) to the next arrival
                nxt = self.queue.next_arrival()
                if nxt is None:
                    break
                if hasattr(self.clock, "advance"):
                    self.clock.advance(max(0.0, nxt - self._now()))
                else:
                    time.sleep(max(0.0, min(0.01, nxt - self._now())))
        else:
            raise RuntimeError(f"serve loop did not drain in {max_steps} steps")
        self.bus.emit("stop", self._now())
        if self.residency is not None:
            self.metrics.residency = self.residency.stats()
        return self.metrics

    def _telemetry_payload(self) -> dict:
        """Snapshot body for the periodic telemetry writer."""
        if self.residency is not None:
            self.metrics.residency = self.residency.stats()
        payload = {"metrics": self.metrics.report()}
        if self.slo is not None:
            payload["slo"] = self.slo.report()
        return payload

    def reset_metrics(self) -> None:
        """Fresh metrics collector (e.g. after a warmup run), same engine.

        The event bus is rebuilt around the new collector; an attached
        tracer/SLO consumer keeps its history. Memoised path notes stay
        (the reference's compiled jits do); the residency tier's counters
        reset with the metrics window while its rows stay warm."""
        self.metrics = Metrics(self.n_slots, data_shards=self.data)
        self.bus = EventBus([self.metrics, self.trace, self.slo])
        if self.residency is not None:
            self.residency.reset_counters()
        self._t0 = None

    def serve(self, requests: List[tuple], max_new_tokens: int = 16) -> List[np.ndarray]:
        """Convenience: submit (tenant, prompt) pairs, run, return outputs."""
        reqs = [self.submit(t, p, max_new_tokens=max_new_tokens)
                for t, p in requests]
        self.run()
        return [r.output() for r in reqs]


# ---------------------------------------------------------------------------
# Static engine (reference path + compatibility shim)
# ---------------------------------------------------------------------------
class Engine:
    """Static per-tenant-batch engine: the reference serving path.

    Runs on the device of ``base_params`` (``cuda`` unless the caller
    built the params on the CPU). ``clock`` is forwarded to the
    ``serve_batch`` shim so tests can inject a VirtualClock."""

    def __init__(self, cfg: ArchConfig, base_params: Any, max_seq: int = 256,
                 clock=time.monotonic):
        self.cfg = cfg
        self.base = base_params
        self.max_seq = max_seq
        self.clock = clock
        self.store = DeltaStore()
        self.device = base_params["embed"]["tok"].device
        self._cont: Optional[ContinuousEngine] = None

    def register_tenant(self, name: str, deltas: Any, report=None) -> Tenant:
        # lower any codec's compressed tree to the PackedDelta runtime
        # layout once here; generate() reads store.get(...).deltas directly
        return self.store.register(name, runtime_delta_tree(deltas), report)

    @torch.inference_mode()
    def generate(self, tenant: Optional[str], prompts: np.ndarray,
                 max_new_tokens: int = 16, stop_token: Optional[int] = None,
                 extra_inputs: Optional[dict] = None,
                 logits_out: Optional[list] = None) -> np.ndarray:
        """Greedy decode for one tenant group. prompts [B, S] int.

        tenant=None serves the raw base model (control arm).
        ``extra_inputs`` carries the cross blocks' inputs (``enc_feats``
        [B, S_enc, d] for encdec, which sizes the cache's encoder rows, or
        ``image_embeds`` [B, n_frontend_tokens, d] for vlm; arrays or
        tensors). When ``logits_out`` is a list, the logits that chose each
        generated token ([B, V] f32, on the engine's device) are appended
        to it.
        """
        deltas = self.store.get(tenant).deltas if tenant else None
        B, S = prompts.shape
        batch = {"tokens": torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                                           device=self.device)}
        enc_len = 0
        if extra_inputs:
            batch.update({k: torch.as_tensor(v).to(self.device)
                          for k, v in extra_inputs.items()})
            if "enc_feats" in batch:
                enc_len = batch["enc_feats"].shape[1]
        cache = lm.init_cache(self.cfg, B, self.max_seq, enc_len, device=self.device)
        logits, cache = lm.prefill(self.cfg, self.base, batch, cache, deltas=deltas)
        out = []
        for t in range(max_new_tokens):
            if logits_out is not None:
                logits_out.append(logits)
            tok = torch.argmax(logits, dim=-1)
            out.append(tok)
            if t + 1 < max_new_tokens:
                logits, cache = lm.decode_step(self.cfg, self.base, cache,
                                               tok[:, None], S + t, deltas=deltas)
        gen = torch.stack(out, dim=1).cpu().numpy().astype(np.int32) if out \
            else np.zeros((B, 0), np.int32)
        if stop_token is not None:
            gen = mask_after_stop(gen, stop_token)
        return gen

    # -- continuous-batching shim -------------------------------------------
    def _continuous(self) -> ContinuousEngine:
        if self._cont is None:
            self._cont = ContinuousEngine(
                self.cfg, self.base, n_slots=8, max_seq=self.max_seq,
                store=self.store, clock=self.clock)
        return self._cont

    def serve_batch(self, requests: list[tuple[str, np.ndarray]],
                    max_new_tokens: int = 16) -> list[np.ndarray]:
        """Serve a mixed request batch.

        Thin shim over :class:`ContinuousEngine`; falls back to the
        per-tenant static grouping where slot dispatch cannot apply to
        the registered tenants (packed deltas at MoE expert sites, trees
        of different structure) or to the arch (encdec/vlm, which the
        continuous engine refuses). As in the reference, the grouped path
        passes no encoder inputs, so an encdec or vlm batch fails there
        (``repro/serve/engine.py:1620-1634``).
        """
        try:
            eng = self._continuous()
            eng._refresh_stacked()   # raises for non-stackable tenant sets
        except (ValueError, NotImplementedError):
            # slot dispatch inapplicable (MoE expert deltas, trees of
            # different structure, encdec/vlm): per-tenant grouping serves
            return self._serve_batch_grouped(requests, max_new_tokens)
        for tenant, prompt in requests:
            # capacity errors must NOT fall back: the grouped path would
            # silently ring-wrap the cache and truncate context
            L = len(np.asarray(prompt).reshape(-1))
            eng.buckets.bucket(L)
            if L + max_new_tokens > self.max_seq:
                raise ValueError(
                    f"request (prompt {L} + max_new {max_new_tokens}) "
                    f"exceeds max_seq={self.max_seq}")
        return eng.serve(requests, max_new_tokens=max_new_tokens)

    def _serve_batch_grouped(self, requests, max_new_tokens: int = 16):
        """Static path: group requests by tenant, run each group."""
        by_tenant: dict[str, list[int]] = {}
        for i, (tenant, _) in enumerate(requests):
            by_tenant.setdefault(tenant, []).append(i)
        results: list[Optional[np.ndarray]] = [None] * len(requests)
        for tenant, idxs in by_tenant.items():
            lens = {requests[i][1].shape[-1] for i in idxs}
            for L in lens:  # one batch per (tenant, prompt-length) group
                group = [i for i in idxs if requests[i][1].shape[-1] == L]
                prompts = np.stack([requests[i][1] for i in group])
                gen = self.generate(tenant, prompts, max_new_tokens)
                for row, i in enumerate(group):
                    results[i] = gen[row]
        return results  # type: ignore

    def memory_report(self) -> dict:
        """Deployment memory ledger.

        * ``bytes_vs_n_full_models``    — ours / (n full fine-tuned
          models), the paper's Fig. 2 comparison.
        * ``bytes_vs_base_plus_n_full`` — ours / (base + n full models),
          for deployments that must also keep the control-arm base.
        """
        base = tree_bytes(self.base)
        deltas = self.store.total_bytes()
        n = len(self.store.names())
        ours = base + deltas
        return {
            "base_bytes": base,
            "delta_bytes_total": deltas,
            "n_tenants": n,
            "bytes_vs_n_full_models": ours / (base * n) if n else 1.0,
            "bytes_vs_base_plus_n_full": ours / (base * (n + 1)),
        }
