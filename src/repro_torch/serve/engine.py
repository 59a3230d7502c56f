"""Multi-tenant serving engines — the paper's deployment scheme (Fig. 2/3).

Port of ``repro/serve/engine.py`` for one card and the port's one codec.
One **base model** is resident; each *tenant* registers only its
DeltaDQ-compressed delta. Two engines share that model:

* :class:`ContinuousEngine` — the production path. A continuous-batching
  scheduler packs requests from *mixed tenants* into fixed decode slots
  (``serve.scheduler``), a slot KV cache admits and evicts sequences
  mid-flight (``serve.kv``), and every decode step serves all slots at
  once through the tenant-stacked packed deltas (``core.apply.SlotDelta``)
  — on the card, the ``delta_spmm_segments`` kernel. Prompt lengths are
  bucketed and left-padded; ``chunked_prefill=`` streams prompts in
  fixed-size chunks inside the decode step instead.

* :class:`Engine` — the static per-tenant-batch engine, kept as the
  reference path (``generate``) and as a thin shim: ``serve_batch``
  routes through a ContinuousEngine and falls back to per-tenant
  grouping only where slot dispatch cannot apply.

The reference jits each step; the port runs eagerly and updates the KV
cache in place. What waits for later slices raises: ``mesh=``,
``data > 1``, ``residency_budget_bytes=``, ``tenant_capacity=`` (the
tenant table), tenants whose packings differ (mixed codec groups) and
non-dense families.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.configs.arch import ArchConfig
from repro_torch.core.apply import (
    stack_tenant_deltas,
    wrap_slot_deltas,
    zero_delta_like,
)
from repro_torch.core.codecs import runtime_delta_tree
from repro_torch.core.compress import CompressionReport
from repro_torch.core.pack import PackedDelta
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
# Which tenants can share one tenant stack
# ---------------------------------------------------------------------------
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
    its length bucket, base requests on the all-zero delta tree) and one
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
    their ring entry back afterwards (``SlotKVCache.restore_entries``),
    bit for bit.

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
                 admission="occupancy",
                 residency_budget_bytes: Optional[int] = None,
                 tenant_capacity: Optional[int] = None,
                 chunked_prefill: bool = False, chunk_size: int = 16,
                 chunk_share: float = 1.0,
                 trace=None, slo=None, telemetry=None):
        lm._check_dense(cfg)
        if mesh is not None:
            raise NotImplementedError(
                "mesh=: sharded serving is not ported yet; the port serves "
                "one card")
        if data is not None and data != 1:
            raise NotImplementedError(
                f"data={data}: data-parallel slot pools come with the mesh")
        if residency_budget_bytes:
            raise NotImplementedError(
                "residency_budget_bytes=: the pre-decoded delta residency "
                "tier is not ported yet")
        if tenant_capacity is not None:
            raise NotImplementedError(
                "tenant_capacity=: the tenant table (hot registration) is "
                "not ported yet; the port re-stacks tenants on registration")
        if slot_dispatch not in ("segments", "per_row"):
            raise ValueError(f"slot_dispatch={slot_dispatch!r} not in "
                             "('segments', 'per_row')")
        self.cfg = cfg
        self.slot_dispatch = slot_dispatch
        self.base = base_params
        self.device = base_params["embed"]["tok"].device
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.store = store if store is not None else DeltaStore()
        # dense attention only: left-padding is safe, so lengths bucket
        self.buckets = LengthBuckets(min_bucket=min_bucket,
                                     max_bucket=max_seq, exact=False)
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
        self._chunks = ChunkQueue(self.chunk_size)
        self._chunk_budget = ChunkBudget(self.chunk_share)
        self._chunk_t0: dict[int, float] = {}    # rid -> admit time
        self.queue = RequestQueue()
        self.sched = Scheduler(n_slots, self.buckets, data_shards=1,
                               admission=admission)
        self.kv = SlotKVCache(cfg, n_slots, max_seq, device=self.device)
        self.metrics = Metrics(n_slots, data_shards=1)
        self.clock = clock
        self.trace = trace
        self.slo = slo
        self.telemetry = telemetry
        self.bus = EventBus([self.metrics, trace, slo])
        # path-attribution notes per call signature. The reference's
        # dispatch notes fire only while jax traces a signature; here they
        # fire on every call, so the first call of a signature emits the
        # jit_trace event and later calls replay its notes
        self._path_notes: dict = {}

        # host mirrors of per-slot decode state (row 0 = zero delta / base)
        self._tok = np.zeros(n_slots, np.int64)
        self._pos = np.zeros(n_slots, np.int64)
        self._row = np.zeros(n_slots, np.int32)

        # tenant-stacked deltas tree: the zero delta at row 0, tenants in
        # registration order (None with no tenants)
        self._stacked = None
        self._zero_tree = None        # unstacked all-zero tree (base prefill)
        self._rows: dict[str, int] = {}
        self._store_version = -1
        self._t0: Optional[float] = None
        self.prefill_shapes: set = set()

    # -- tenants ------------------------------------------------------------
    def register_tenant(self, name: str, deltas: Any, report=None) -> Tenant:
        """Register (or replace) a tenant and re-stack the tenant rows.

        ``deltas`` is lowered to the PackedDelta runtime layout here,
        once. A tenant whose tree cannot join the engine fails here, not
        mid-run inside a prefill, and a rejected registration leaves the
        engine untouched. A same-name re-register is refused while the
        tenant has in-flight sequences (they would switch deltas
        mid-sequence).
        """
        rt = runtime_delta_tree(deltas)
        replace = name in self.store.names()
        if replace and self._tenant_in_flight(name):
            raise RuntimeError(
                f"tenant {name!r} has in-flight sequences; re-registering "
                "would switch their deltas mid-sequence — drain first")
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
        """Retire a tenant and re-stack the rest. Refuses while the tenant
        has in-flight sequences or queued requests; a refused retire
        leaves the engine untouched."""
        self.store.get(name)             # KeyError early for unknown names
        if self._tenant_in_flight(name):
            raise RuntimeError(
                f"tenant {name!r} has in-flight sequences; drain before "
                "retiring")
        if any(r.tenant == name for r in self.queue.pending()):
            raise RuntimeError(
                f"tenant {name!r} has queued requests; drain before "
                "retiring")
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

    def _refresh_stacked(self) -> None:
        """Re-stack the tenant rows after a store change: zero delta at
        row 0, tenants in registration order. Runs once per store
        version, never per step. Every check (tree structure, packing,
        rows shifted under in-flight requests) comes before any change,
        so a rejected register/unregister leaves the engine as it was."""
        if self._store_version == self.store.version:
            return
        tenants = self.store.ordered()
        new_rows = {t.name: i + 1 for i, t in enumerate(tenants)}
        if tenants:
            ref_struct = _tree_structure(tenants[0].deltas)
            ref_sig = _stack_signature(tenants[0].deltas)
            for t in tenants:
                if _tree_structure(t.deltas) != ref_struct:
                    raise ValueError(
                        "tenant delta trees differ in structure; "
                        "cannot stack for slot dispatch")
                if _stack_signature(t.deltas) != ref_sig:
                    raise NotImplementedError(
                        f"tenant {t.name!r} is packed differently from "
                        f"{tenants[0].name!r}: mixed codec groups "
                        "(MultiSlotDelta) are not ported yet")
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
        # drop the old stack before building the new one: one stacked
        # copy at a time (a failed build leaves the engine stale, so the
        # next refresh builds again)
        self._stacked = None
        self._store_version = -1
        new_zero = new_stacked = None
        if tenants:
            new_zero = zero_delta_like(tenants[0].deltas)
            new_stacked = stack_tenant_deltas(
                [new_zero] + [t.deltas for t in tenants])
        self._stacked = new_stacked
        self._zero_tree = new_zero
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

    def _record_path(self, sig: tuple, site: str, notes: list,
                     now: float) -> tuple:
        """Emit ``jit_trace`` the first time ``sig`` is called with notes
        (the reference's trace of that signature) and return (the
        signature's memoised notes, whether this call emitted)."""
        first = bool(notes) and sig not in self._path_notes
        if first:
            self.bus.emit("jit_trace", now, signature=sig, site=site,
                          first=True, notes=list(notes))
            self._path_notes[sig] = list(notes)
        return self._path_notes.get(sig, []), first

    def _prefill_into(self, slot: int, req: Request, now: float) -> None:
        self._refresh_stacked()
        L = req.prompt_len
        bucket = self.buckets.bucket(L)
        pad = bucket - L
        host = np.zeros((2, bucket), np.int64)
        host[0, pad:] = req.prompt                        # tokens
        host[1] = np.arange(bucket) - pad                 # positions
        if req.tenant is not None:
            deltas = self.store.get(req.tenant).deltas
        else:
            deltas = self._zero_tree    # None when no tenants registered
        batch = self._to_device(host)
        row_cache = lm.init_cache(self.cfg, 1, self.max_seq, device=self.device)
        self.prefill_shapes.add(bucket)
        with attribution() as notes:
            logits, row_cache = lm.prefill(
                self.cfg, self.base,
                {"tokens": batch[0:1], "positions": batch[1:2]},
                row_cache, deltas=deltas)
        self._record_path(("prefill", bucket), "prefill", notes, now)
        self.kv.insert(slot, row_cache)

        first = int(torch.argmax(logits[0]))
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
        # every host-to-device copy of the step before its first launch
        sd = self._slot_delta(rows_eff)
        dev = self._to_device(np.stack([self._tok, self._pos,
                                        act.astype(np.int64)]))
        tok_d, pos_d, act_d = dev[0][:, None], dev[1], dev[2].bool()
        if task is not None:
            req = task.request
            C = self.chunk_size
            host = np.zeros((3, C), np.int64)
            host[0, :task.length] = req.prompt[task.start:
                                               task.start + task.length]
            # pad positions run past every real query position, so the
            # padded keys are causally masked; their K/V never reach the
            # ring (valid mask)
            host[1] = task.start + np.arange(C)
            host[2, :task.length] = 1
            chunk = self._to_device(host)
            cd = self._slot_delta(self._row[task.slot:task.slot + 1])
        cache = self.kv.cache
        masked = not act.all()
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
            if task is not None:
                # the chunk row is prefilled against its restored, clean
                # ring, through views of the shared cache
                row = [{k: c[k][task.slot:task.slot + 1]
                        for k in ("k", "v", "pos")} for c in cache]
                clog, _ = lm.prefill_chunk(
                    self.cfg, self.base,
                    {"tokens": chunk[0:1], "positions": chunk[1:2],
                     "valid": chunk[2:3].bool()}, row, deltas=cd)
                cn = torch.argmax(clog[0], dim=-1)
        if task is None:
            sig = ("decode_masked", self._n_groups(), False)
            site = "decode_masked"
        else:
            sig = ("combined", self.chunk_size, self._n_groups(), False)
            site = "combined"
        path_notes, recompiled = self._record_path(sig, site, notes, now)
        nxt = nxt.cpu().numpy()
        t = self._now()
        self.bus.emit(
            "step", t, t_start=now, n_active=len(decode_slots),
            chunk_tokens=task.length if task is not None else 0,
            shard_active=None,
            shard_unique=self.sched.shard_unique_tenants(rows_eff),
            residency_used=None,
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
                # generated token, as whole-prompt prefill's last row does
                first = int(cn[task.length - 1])
                L = req.prompt_len
                self.bus.emit("prefill", t, rid=req.rid, tenant=req.tenant,
                              t_start=self._chunk_t0.pop(req.rid, now),
                              prompt_len=L, bucket=None, slot=task.slot)
                self.bus.emit("first_token", t, rid=req.rid,
                              tenant=req.tenant, ttft=t - req.arrival)
                self.bus.emit("token", t, rid=req.rid, tenant=req.tenant)
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

    def _slot_delta(self, rows: np.ndarray):
        """Per-slot delta dispatch tree for one step (None with no
        tenants): the tenant stack with per-row tenant rows and, for the
        segments dispatch, the tenant-sorted layout (built on the host,
        copied to the device once). ``rows`` is the [n_slots] tenant-row
        vector a decode step serves (the chunked path masks parked slots
        to row 0), or the one row of a prompt chunk, which threads the
        SAME segment dispatch as decode (on the card the segments kernel
        at T = ``chunk_size``)."""
        if self._stacked is None:
            return None
        seg = None
        if self.slot_dispatch == "segments":
            seg = tenant_segments(rows).to(self.device)
        return wrap_slot_deltas(self._stacked,
                                self._to_device(rows.astype(np.int64)), segments=seg)

    def _n_groups(self) -> int:
        """Stack groups in the reference's signatures (one at most here)."""
        return int(self._stacked is not None)

    def _decode_all(self, now: float) -> None:
        active = self.sched.active_slots()
        if not active:
            return
        self._refresh_stacked()
        sd = self._slot_delta(self._row)
        dev = self._to_device(np.stack([self._tok, self._pos]))
        with attribution() as notes:
            logits, _ = lm.decode_step(self.cfg, self.base, self.kv.cache,
                                       dev[0][:, None], dev[1], deltas=sd)
            nxt = torch.argmax(logits, dim=-1)
        sig = ("decode", self._n_groups(), False)
        path_notes, recompiled = self._record_path(sig, "decode", notes, now)
        nxt = nxt.cpu().numpy()
        t = self._now()
        self.bus.emit(
            "step", t, t_start=now, n_active=len(active),
            shard_active=None,
            shard_unique=self.sched.shard_unique_tenants(self._row),
            residency_used=None,
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
            if fin:
                self._finish(slot, t)

    @torch.no_grad()
    def step(self, now: float) -> bool:
        """One scheduler iteration: admit into free slots, then decode."""
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
        return self.metrics

    def _telemetry_payload(self) -> dict:
        """Snapshot body for the periodic telemetry writer."""
        payload = {"metrics": self.metrics.report()}
        if self.slo is not None:
            payload["slo"] = self.slo.report()
        return payload

    def reset_metrics(self) -> None:
        """Fresh metrics collector (e.g. after a warmup run), same engine.

        The event bus is rebuilt around the new collector; an attached
        tracer/SLO consumer keeps its history. Memoised path notes stay
        (the reference's compiled jits do)."""
        self.metrics = Metrics(self.n_slots, data_shards=1)
        self.bus = EventBus([self.metrics, self.trace, self.slo])
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
                 logits_out: Optional[list] = None) -> np.ndarray:
        """Greedy decode for one tenant group. prompts [B, S] int.

        tenant=None serves the raw base model (control arm). When
        ``logits_out`` is a list, the logits that chose each generated
        token ([B, V] f32, on the engine's device) are appended to it.
        """
        deltas = self.store.get(tenant).deltas if tenant else None
        B, S = prompts.shape
        tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                                 device=self.device)
        cache = lm.init_cache(self.cfg, B, self.max_seq, device=self.device)
        logits, cache = lm.prefill(self.cfg, self.base, {"tokens": tokens},
                                   cache, deltas=deltas)
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
        the registered tenants (trees of different structure, packings
        that need mixed codec groups).
        """
        try:
            eng = self._continuous()
            eng._refresh_stacked()   # raises for non-stackable tenant sets
        except (ValueError, NotImplementedError):
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
