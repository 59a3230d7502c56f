"""Continuous-batching scheduler: requests, length buckets, slot packing.

Copy of ``repro/serve/scheduler.py`` (framework-free); the segment
layouts build the port's ``core.apply`` classes, and both take
``skip_zero_row``.

The scheduler owns *admission policy only* — which pending request goes
into which free KV slot, and when. All jax work (prefill, batched decode)
stays in ``serve.engine``; all cache storage in ``serve.kv``. This keeps
the policy unit-testable without compiling anything.

Design points (serve/README.md has the full picture):

* Requests arrive with ``(arrival, deadline)`` metadata; admission order
  is earliest-deadline-first, ties broken by arrival then id — a simple,
  deterministic policy that later PRs can swap out.
* Prompt lengths are rounded up to a small set of **buckets** (powers of
  two by default) and left-padded, so jit compiles at most once per
  bucket instead of once per distinct prompt length. Archs whose mixers
  carry sequence state (ssm/rec) cannot be left-padded without polluting
  the state, so they use ``exact=True`` buckets (one shape per distinct
  length — still bounded by the number of distinct lengths seen).
* A slot is freed **only** when its sequence finishes (stop token or
  token budget). Unfinished sequences are never evicted; under slot
  pressure new requests simply wait in the queue.
* With ``data_shards > 1`` the slot table is partitioned into
  ``data_shards`` **contiguous shard pools** (slot rows shard over the
  mesh ``data`` axis in the serve layout, so pool ``s`` is exactly the
  rows device-shard ``s`` owns). *Which* pool a popped request lands in
  is a pluggable :class:`AdmissionPolicy`:

  - :class:`BalancedAdmission` (default): the least-occupied shard with
    a free slot, ties broken by the lowest slot id — placement is a
    pure function of the slot table, so a replayed trace lands every
    request on the same shard.
  - :class:`AffinityAdmission`: prefer a shard already hosting the
    request's *tenant* (so each data shard sees fewer unique tenants
    per decode step and dequantizes fewer deltas), but only while that
    shard stays within ``max_imbalance`` of the least-occupied shard;
    otherwise fall back to the balanced rule. A policy only picks
    *among* open shards — it can never decline a placement — so the
    capacity / EDF / no-starvation guarantees are policy-independent.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np


# ---------------------------------------------------------------------------
# Requests
# ---------------------------------------------------------------------------
@dataclass
class Request:
    """One generation request plus its lifecycle bookkeeping."""
    rid: int
    tenant: Optional[str]            # None = raw base model
    prompt: np.ndarray               # [L] int32
    max_new_tokens: int = 16
    stop_token: Optional[int] = None
    arrival: float = 0.0
    deadline: Optional[float] = None
    on_token: Optional[Callable[["Request", int, bool], None]] = None

    # -- filled in by the engine --------------------------------------------
    tokens: List[int] = field(default_factory=list)
    t_admitted: Optional[float] = None
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None

    @property
    def done(self) -> bool:
        return self.t_done is not None

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[-1])

    def output(self) -> np.ndarray:
        return np.asarray(self.tokens, np.int32)

    def emit(self, token: int) -> bool:
        """Record one generated token, fire the streaming callback, and
        return whether the sequence just finished (single source of the
        stop condition)."""
        self.tokens.append(int(token))
        fin = self.should_stop()
        if self.on_token is not None:
            self.on_token(self, int(token), fin)
        return fin

    def should_stop(self) -> bool:
        if self.stop_token is not None and self.tokens \
                and self.tokens[-1] == self.stop_token:
            return True
        return len(self.tokens) >= self.max_new_tokens


class RequestQueue:
    """Arrival-ordered queue with deadline-aware pop.

    Two heaps instead of the old linear best-scan + ``list.remove``
    (which made draining n requests O(n^2) — measurable at
    registry-scale queue depths): ``_future`` orders not-yet-arrived
    requests by arrival, ``_ready`` orders arrived ones by the EDF key
    ``(deadline-or-inf, arrival, rid)``. ``pop_ready`` migrates arrived
    requests future->ready, then pops the heap head — the exact request
    the old scan's ``min()`` picked, so pop order is unchanged (the EDF
    property suite pins it). Each request is pushed/popped O(log n)
    once per heap.
    """

    def __init__(self):
        self._future: List[tuple] = []    # (arrival, rid, Request)
        self._ready: List[tuple] = []     # (deadline|inf, arrival, rid, Req)
        self._ids = itertools.count()

    def submit(self, tenant: Optional[str], prompt: np.ndarray, *,
               max_new_tokens: int = 16, stop_token: Optional[int] = None,
               arrival: float = 0.0, deadline: Optional[float] = None,
               on_token=None) -> Request:
        req = Request(rid=next(self._ids), tenant=tenant,
                      prompt=np.asarray(prompt, np.int32).reshape(-1),
                      max_new_tokens=max_new_tokens, stop_token=stop_token,
                      arrival=arrival, deadline=deadline, on_token=on_token)
        heapq.heappush(self._future, (req.arrival, req.rid, req))
        return req

    def _migrate(self, now: float) -> None:
        """Move every arrived request onto the EDF-keyed ready heap."""
        while self._future and self._future[0][0] <= now:
            _, rid, req = heapq.heappop(self._future)
            heapq.heappush(self._ready, (
                req.deadline if req.deadline is not None else float("inf"),
                req.arrival, rid, req))

    def __len__(self) -> int:
        return len(self._future) + len(self._ready)

    def ready(self, now: float) -> List[Request]:
        """Arrived-but-unpopped requests, in submission (rid) order —
        introspection only, never consulted by the pop path."""
        out = [r for _, _, r in self._future if r.arrival <= now]
        out += [r for _, _, _, r in self._ready]
        return sorted(out, key=lambda r: r.rid)

    def pending(self) -> List[Request]:
        """ALL queued requests (arrived or not), in submission (rid)
        order — lifecycle guards scan this before retiring a tenant."""
        out = [r for _, _, r in self._future]
        out += [r for _, _, _, r in self._ready]
        return sorted(out, key=lambda r: r.rid)

    def next_arrival(self) -> Optional[float]:
        if self._ready:
            # already-arrived requests are waiting (e.g. on slots): the
            # earliest pending arrival is theirs, not a future one's
            return min(r.arrival for _, _, _, r in self._ready)
        return self._future[0][0] if self._future else None

    def pop_ready(self, now: float) -> Optional[Request]:
        """Earliest deadline first among arrived requests; FIFO otherwise."""
        self._migrate(now)
        if not self._ready:
            return None
        return heapq.heappop(self._ready)[3]


# ---------------------------------------------------------------------------
# Length buckets
# ---------------------------------------------------------------------------
class LengthBuckets:
    """Round prompt lengths up to a bounded set of jit shapes."""

    def __init__(self, min_bucket: int = 8, max_bucket: int = 4096,
                 exact: bool = False):
        self.min_bucket = min_bucket
        self.max_bucket = max_bucket
        self.exact = exact
        self.seen: set[int] = set()

    def bucket(self, length: int) -> int:
        if length > self.max_bucket:
            raise ValueError(f"prompt length {length} exceeds max bucket "
                             f"{self.max_bucket}")
        if self.exact:
            b = length
        else:
            b = self.min_bucket
            while b < length:
                b *= 2
            # a non-power-of-two max_bucket must still admit prompts that
            # fit: clamp instead of overshooting past the cap
            b = min(b, self.max_bucket)
        self.seen.add(b)
        return b


# ---------------------------------------------------------------------------
# Tenant-segment layout (unique-tenant decode dispatch)
# ---------------------------------------------------------------------------
def tenant_segments(rows: np.ndarray, *, skip_zero_row: bool = False):
    """Build the static-shape tenant-segment layout for one decode step.

    ``rows`` int [B] is the per-slot tenant row (0 = base/zero delta).
    Returns a :class:`repro_torch.core.apply.TenantSegments` of numpy arrays:
    batch rows stably sorted by tenant so each unique tenant occupies
    one contiguous segment; segment arrays are padded to B entries
    (empty segments carry ``seg_offsets[s] == seg_offsets[s+1]`` and
    tenant row 0) so every decode step shares ONE jit shape regardless
    of how many distinct tenants happen to share the batch.

    ``skip_zero_row`` leaves row 0's segment out: its rows (sorted first)
    are then covered by no segment, and the segments kernel and its plain
    version zero-fill them — the same exact 0.0 the zero delta decodes
    to, without reading it.
    """
    from repro_torch.core.apply import TenantSegments
    rows = np.asarray(rows, np.int32)
    B = rows.shape[0]
    order = np.argsort(rows, kind="stable").astype(np.int32)
    inv_order = np.argsort(order, kind="stable").astype(np.int32)
    uniq, starts = np.unique(rows[order], return_index=True)
    if skip_zero_row and len(uniq) and uniq[0] == 0:
        uniq, starts = uniq[1:], starts[1:]
    seg_rows = np.zeros(B, np.int32)
    seg_rows[:len(uniq)] = uniq
    seg_offsets = np.full(B + 1, B, np.int32)
    seg_offsets[:len(uniq)] = starts
    return TenantSegments(order=order, inv_order=inv_order,
                          seg_rows=seg_rows, seg_offsets=seg_offsets)


def tenant_segments_sharded(rows: np.ndarray, data_shards: int, *,
                            skip_zero_row: bool = False):
    """Per-data-shard tenant-segment layout for one decode step.

    The ``data > 1`` companion of :func:`tenant_segments`: returns a
    :class:`repro_torch.core.apply.ShardedTenantSegments` of [D, B_s] /
    [D, B_s+1] numpy arrays — each contiguous shard pool's own stable
    sort, pool-LOCAL permutation and pool-local segment list. Rows sort
    by tenant only *within* a pool (the permutation never crosses a pool
    boundary, so the sorted batch partitions over the mesh ``data`` axis
    exactly like the unsorted slot rows) and each pool contributes its own
    segments — a tenant hosted by two shards gets two segments, so each
    data rank decodes exactly the tenants its pool hosts. A run over all
    rows flattens it with ``global_order()`` / ``global_segments()``.
    ``skip_zero_row`` leaves each pool's row-0 segment out, as
    :func:`tenant_segments` does.
    """
    from repro_torch.core.apply import ShardedTenantSegments
    rows = np.asarray(rows, np.int32)
    B = rows.shape[0]
    # ValueError (not assert): a bad split must fail loudly even under
    # python -O, or np.empty garbage would flow into gather indices
    per = shard_pool_size(B, data_shards)
    order = np.empty((data_shards, per), np.int32)
    inv_order = np.empty((data_shards, per), np.int32)
    seg_rows = np.zeros((data_shards, per), np.int32)
    seg_offsets = np.full((data_shards, per + 1), per, np.int32)
    for s in range(data_shards):
        pool = tenant_segments(rows[s * per:(s + 1) * per],
                               skip_zero_row=skip_zero_row)
        order[s] = pool.order
        inv_order[s] = pool.inv_order
        seg_rows[s] = pool.seg_rows
        seg_offsets[s] = pool.seg_offsets
    return ShardedTenantSegments(order=order, inv_order=inv_order,
                                 seg_rows=seg_rows, seg_offsets=seg_offsets)


# ---------------------------------------------------------------------------
# Admission policies
# ---------------------------------------------------------------------------
class AdmissionPolicy:
    """Chooses the shard pool for one popped request.

    The contract every policy must honor (and the property suite pins):
    ``choose`` is called only when at least one shard has a free slot,
    and must return a member of ``open_shards`` — a policy decides
    *where*, never *whether*, so admission always fills free slots from
    the ready queue (no starvation) and the EDF pop order is untouched.
    All inputs are host-side state, so placement stays a deterministic
    pure function of the slot table and the popped request.

    ``max_imbalance`` is the policy's occupancy bound: immediately after
    any admission round, every shard the policy placed into is within
    ``max_imbalance`` of the least-occupied shard.
    """

    name = "base"
    max_imbalance = 1

    def choose(self, req: "Request", open_shards: List[int], occ: List[int],
               free: List[List[int]], hosted: List[set]) -> int:
        """Pick a shard for ``req``.

        ``open_shards``: shards with >= 1 free slot (ascending).
        ``occ``: per-shard active count (including slots claimed earlier
        in this round). ``free``: per-shard free slot ids (ascending).
        ``hosted``: per-shard set of tenant names currently hosted
        (active slots plus this round's claims).
        """
        raise NotImplementedError


class BalancedAdmission(AdmissionPolicy):
    """Occupancy-balanced placement (the default):
    least-occupied open shard, ties broken by the lowest free slot id."""

    name = "occupancy"
    max_imbalance = 1

    def choose(self, req, open_shards, occ, free, hosted) -> int:
        return min(open_shards, key=lambda s: (occ[s], free[s][0]))


class AffinityAdmission(BalancedAdmission):
    """Tenant-affinity placement with a bounded-imbalance guardrail.

    Prefer an open shard that already hosts the request's tenant — the
    per-shard unique-tenant count then grows only when it must, so each
    ``(data, model)`` device dequantizes fewer distinct deltas per
    decode step. Affinity never overrides balance unboundedly: a hosting
    shard is eligible only while its occupancy stays strictly below
    ``min(occ) + max_imbalance`` (occupancy over *all* shards), so after
    placement it is within ``max_imbalance`` of the least-occupied
    shard. Base requests (``tenant=None``) and requests whose tenant is
    hosted nowhere eligible fall back to the balanced rule.
    """

    name = "affinity"

    def __init__(self, max_imbalance: int = 2):
        if max_imbalance < 1:
            raise ValueError(f"max_imbalance={max_imbalance} must be >= 1")
        self.max_imbalance = int(max_imbalance)

    def choose(self, req, open_shards, occ, free, hosted) -> int:
        if req.tenant is not None:
            floor = min(occ)
            aff = [s for s in open_shards
                   if req.tenant in hosted[s]
                   and occ[s] - floor < self.max_imbalance]
            if aff:
                return min(aff, key=lambda s: (occ[s], free[s][0]))
        return super().choose(req, open_shards, occ, free, hosted)


def make_admission(policy) -> AdmissionPolicy:
    """Resolve an admission policy from a name or pass an instance through."""
    if isinstance(policy, AdmissionPolicy):
        return policy
    if policy in (None, "occupancy", "balanced"):
        return BalancedAdmission()
    if policy == "affinity":
        return AffinityAdmission()
    raise ValueError(f"unknown admission policy {policy!r} "
                     "(expected 'occupancy' | 'affinity' | AdmissionPolicy)")


# ---------------------------------------------------------------------------
# Slot table
# ---------------------------------------------------------------------------
def shard_pool_size(n_slots: int, data_shards: int) -> int:
    """Validate the contiguous equal shard-pool partition and return the
    pool size.

    The ONE definition of the slot->shard mapping every serve component
    (Scheduler, SlotKVCache, Metrics) derives from:
    ``shard_of(slot) = slot // shard_pool_size(n_slots, data_shards)``.
    Pool ``s`` is exactly the slot rows mesh data-shard ``s`` owns under
    the serve cache layout (jax partitions an axis into contiguous equal
    blocks), so host bookkeeping and device layout agree by construction.
    """
    if data_shards < 1 or n_slots % data_shards:
        raise ValueError(
            f"n_slots={n_slots} must be a positive multiple of "
            f"data_shards={data_shards} (contiguous equal shard pools)")
    return n_slots // data_shards


@dataclass
class SlotState:
    """Runtime state of one occupied decode slot."""
    request: Request
    next_token: int                  # last sampled token (decode input)
    pos: int                         # next decode position (= tokens so far)
    tenant_row: int                  # row in the tenant-stacked delta tree
    # chunked prefill: the slot is claimed (KV row reserved, mid-prefill)
    # but not yet decoding — the combined step masks it out of the decode
    # rows and restores its cache row untouched
    prefilling: bool = False


class Scheduler:
    """Packs mixed-tenant requests into fixed decode slots.

    ``data_shards > 1`` partitions the ``n_slots`` slot rows into
    contiguous shard pools of ``n_slots / data_shards`` (the rows each
    mesh ``data`` shard owns in the serve cache layout); ``admission``
    (an :class:`AdmissionPolicy`, or its name) picks the pool for each
    popped request — occupancy-balanced by default — see :meth:`admit`.
    """

    def __init__(self, n_slots: int, buckets: LengthBuckets,
                 data_shards: int = 1, admission=None):
        self.n_slots = n_slots
        self.buckets = buckets
        self.data_shards = data_shards
        self.shard_size = shard_pool_size(n_slots, data_shards)
        self.admission = make_admission(admission)
        self.slots: List[Optional[SlotState]] = [None] * n_slots

    # -- introspection ------------------------------------------------------
    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def active_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is not None]

    @property
    def n_active(self) -> int:
        return len(self.active_slots())

    def shard_of(self, slot: int) -> int:
        """Data shard owning ``slot`` (pools are contiguous slot ranges)."""
        return slot // self.shard_size

    def shard_slots(self, shard: int) -> range:
        return range(shard * self.shard_size, (shard + 1) * self.shard_size)

    def shard_occupancy(self) -> List[int]:
        """Active-slot count per data shard."""
        occ = [0] * self.data_shards
        for i, s in enumerate(self.slots):
            if s is not None:
                occ[self.shard_of(i)] += 1
        return occ

    def hosted_tenants(self) -> List[set]:
        """Per-shard set of tenant names currently hosted (base requests,
        ``tenant=None``, are not tracked — they carry no delta)."""
        hosted: List[set] = [set() for _ in range(self.data_shards)]
        for i, s in enumerate(self.slots):
            if s is not None and s.request.tenant is not None:
                hosted[self.shard_of(i)].add(s.request.tenant)
        return hosted

    def shard_unique_tenants(self, rows) -> List[int]:
        """Distinct non-base tenant rows per shard pool of ``rows`` [B] —
        the number of distinct deltas each data shard dequantizes in a
        decode step over those slot rows (row 0, the zero delta, is not
        counted). The observable affinity admission tries to shrink."""
        rows = np.asarray(rows)
        return [int(np.unique(pool[pool > 0]).size)
                for s in range(self.data_shards)
                for pool in [rows[s * self.shard_size:
                                  (s + 1) * self.shard_size]]]

    # -- transitions --------------------------------------------------------
    def admit(self, queue: RequestQueue, now: float) -> List[tuple]:
        """Fill free slots from the queue; returns [(slot, request)].

        Placement is **deterministic** and delegated to the admission
        policy: each popped request goes to the shard
        ``self.admission.choose(...)`` picks among those that still
        have a free slot (occupancy and hosted-tenant sets count both
        active slots and slots already claimed earlier in this round),
        and takes that shard's lowest free slot id. Guarantees pinned
        by the property tests, for every policy: admission fills
        ``min(free, ready)`` slots in EDF pop order, and every shard
        the policy placed into ends within ``policy.max_imbalance`` of
        the least-occupied shard (1 for the balanced default). (A shard
        left imbalanced by earlier finishes stays imbalanced if the
        queue drains first — admission balances what it admits, it does
        not migrate active sequences.) With data_shards=1 every policy
        degrades to exactly the old lowest-free-slot-first behavior.
        """
        occ = self.shard_occupancy()
        hosted = self.hosted_tenants()
        # pool ranges ascend, so each free list is born sorted by slot id
        free = [[i for i in self.shard_slots(s) if self.slots[i] is None]
                for s in range(self.data_shards)]
        admitted = []
        while True:
            open_shards = [s for s in range(self.data_shards) if free[s]]
            if not open_shards:
                break
            req = queue.pop_ready(now)
            if req is None:
                break
            shard = self.admission.choose(req, open_shards, occ, free, hosted)
            if shard not in open_shards:
                # ValueError (not assert): a policy returning a full shard
                # must fail loudly, not pop from an empty free list
                raise ValueError(
                    f"admission policy {self.admission.name!r} chose shard "
                    f"{shard} with no free slot (open: {open_shards})")
            slot = free[shard].pop(0)
            occ[shard] += 1
            if req.tenant is not None:
                hosted[shard].add(req.tenant)
            req.t_admitted = now
            admitted.append((slot, req))
        return admitted

    def place(self, slot: int, state: SlotState) -> None:
        if self.slots[slot] is not None:
            raise RuntimeError(
                f"slot {slot} already occupied by rid "
                f"{self.slots[slot].request.rid}")
        self.slots[slot] = state

    def release(self, slot: int) -> Request:
        """Free a slot. Refuses to drop an unfinished sequence."""
        state = self.slots[slot]
        if state is None:
            raise RuntimeError(f"slot {slot} already free")
        if not state.request.done:
            raise RuntimeError(
                f"refusing to evict unfinished request {state.request.rid} "
                f"from slot {slot}")
        self.slots[slot] = None
        return state.request


@dataclass
class ChunkTask:
    """One prompt chunk picked for the next combined step."""
    slot: int
    request: Request
    start: int                       # cursor: prompt tokens already consumed
    length: int                      # tokens in this chunk (<= chunk_size)
    last: bool                       # final chunk -> first token after this


class ChunkQueue:
    """EDF-ordered queue of admitted, mid-prefill requests.

    Chunked prefill admits a request by claiming its KV slot, then feeds
    the prompt through the combined decode step ``chunk_size`` tokens at
    a time. This queue owns the **resumable per-request chunk cursors**:
    ``next_task`` peeks the head request's next chunk (earliest deadline
    first, ties by arrival then rid — the same order ``RequestQueue.
    pop_ready`` admits in), and ``advance`` moves the cursor only after
    the engine actually processed the chunk, so a step that skips chunk
    work (budget denied) repicks the identical task later. Cursors are
    strictly monotone and a request leaves the queue exactly when its
    cursor reaches the prompt length — the property suite pins both.
    """

    def __init__(self, chunk_size: int):
        if chunk_size < 1:
            raise ValueError(f"chunk_size={chunk_size} must be >= 1")
        self.chunk_size = chunk_size
        self._entries: dict[int, tuple] = {}     # rid -> (slot, Request)
        self._cursors: dict[int, int] = {}       # rid -> tokens consumed

    def add(self, slot: int, req: Request) -> None:
        if req.rid in self._entries:
            raise RuntimeError(
                f"rid {req.rid} already queued for chunked prefill")
        self._entries[req.rid] = (slot, req)
        self._cursors[req.rid] = 0

    def __len__(self) -> int:
        return len(self._entries)

    def cursor(self, rid: int) -> int:
        return self._cursors[rid]

    def pending_tokens(self) -> int:
        """Prompt tokens not yet consumed across all queued requests."""
        return sum(req.prompt_len - self._cursors[rid]
                   for rid, (_, req) in self._entries.items())

    def next_task(self) -> Optional[ChunkTask]:
        """The EDF-head request's next chunk; does NOT advance the cursor."""
        if not self._entries:
            return None
        rid = min(self._entries, key=lambda r: (
            self._entries[r][1].deadline
            if self._entries[r][1].deadline is not None else float("inf"),
            self._entries[r][1].arrival, r))
        slot, req = self._entries[rid]
        start = self._cursors[rid]
        length = min(self.chunk_size, req.prompt_len - start)
        return ChunkTask(slot=slot, request=req, start=start, length=length,
                         last=start + length >= req.prompt_len)

    def advance(self, task: ChunkTask) -> None:
        """Move the cursor past a processed chunk; pop the request when
        its whole prompt has been consumed."""
        rid = task.request.rid
        if self._cursors.get(rid) != task.start:
            raise ValueError(
                f"stale chunk task for rid {rid}: cursor is "
                f"{self._cursors.get(rid)}, task starts at {task.start}")
        self._cursors[rid] = task.start + task.length
        if task.last:
            del self._entries[rid]
            del self._cursors[rid]


class ChunkBudget:
    """Per-step chunk-budget policy under the decode-SLO knob.

    ``share`` in (0, 1] is the maximum fraction of combined steps that
    may carry prefill-chunk work while decode rows are active — the knob
    trading TTFT (chunks land sooner) against ITL (every chunk-carrying
    step is a little slower for the in-flight decodes). Implemented as a
    deterministic token bucket: each ``grant`` call with active decode
    rows accrues ``share`` credit (capped at 1, so idle stretches never
    bank a burst) and a granted chunk spends 1, so over any window of n
    such steps at most ``ceil(share * n)`` chunks run, and with
    share=1.0 (the TTFT-first default) every step may carry one. Steps
    with NO active decode rows always grant — there is no ITL left to
    protect, and refusing would deadlock the drain loop.
    """

    def __init__(self, share: float = 1.0):
        if not 0.0 < share <= 1.0:
            raise ValueError(f"chunk share={share} must be in (0, 1]")
        self.share = float(share)
        self._credit = 0.0

    def grant(self, n_decode_active: int, n_pending: int) -> bool:
        """Decide whether THIS step may process one prefill chunk."""
        if n_pending == 0:
            return False
        if n_decode_active == 0:
            return True
        self._credit = min(1.0, self._credit + self.share)
        if self._credit >= 1.0:
            self._credit -= 1.0
            return True
        return False


class VirtualClock:
    """Deterministic clock for tests/benchmarks: advances only on demand."""

    def __init__(self, t0: float = 0.0, tick: float = 0.0):
        self.t = t0
        self.tick = tick

    def __call__(self) -> float:
        self.t += self.tick
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t
