"""Online tenant lifecycle: compress-and-register service + cold tiers
(port of ``repro/serve/registry.py``).

The paper's deployment story is one resident base model plus many tiny
deltas — but a fleet onboards, updates and retires fine-tunes
continuously, so compression itself runs as an online service. The
:class:`DeltaRegistry` closes that loop around a running
:class:`~repro_torch.serve.engine.ContinuousEngine`:

* **Ingestion**: a raw fine-tuned checkpoint arrives (an
  :meth:`~DeltaRegistry.ingest` call, or a ``.npz`` dropped into a
  watched directory picked up by :meth:`~DeltaRegistry.scan`), is
  compressed by ``core.compress`` on the base's device (``codec="auto"``
  under a bit budget by default) — inline, or on a background worker
  thread — and lands in the registry as a *ready* record.
* **Hot registration**: :meth:`~DeltaRegistry.pump` (called from the
  serving loop between steps) drains ready records into the engine via
  ``engine.register_tenant``. With the engine in table mode
  (``tenant_capacity=``) that is an in-place row write: no restart, no
  re-stack, in-flight sequences untouched.
* **Cold tiers**:

  ========  =============================================  ============
  tier      holds                                          owner
  ========  =============================================  ============
  hot       packed rows in the engine's tenant table       TenantTable
  warm      packed tree as host (CPU) tensors              this registry
  cold      packed leaves spooled to disk (npz)            this registry
  ========  =============================================  ============

  Promotion happens on first request (:meth:`~DeltaRegistry.submit`
  re-registers a warm/cold tenant before queueing); eviction is by
  traffic — when the table is full, the least-recently-requested hot
  tenant with no in-flight sequences is retired to warm, and warm
  records beyond ``host_capacity`` spill to the disk spool.
* **Rollout / rollback**: ingesting an existing name is a version
  rollout (new requests only); the previous version stays warm so
  :meth:`~DeltaRegistry.rollback` is one more rollout away.

Every lifecycle transition emits a typed event on the engine's bus
(``tenant_ready`` / ``tenant_promote`` / ``tenant_evict`` here;
``tenant_register`` / ``tenant_rollout`` / ``tenant_retire`` from the
engine).

The worker thread runs on the default stream like everything else; it
never touches the engine — :meth:`~DeltaRegistry.pump` does, from the
serving thread, between steps. Spool files are the reference's format
(npz plus a JSON sidecar naming the bf16 leaves, stored as raw uint16
bits) and are read back without ``ml_dtypes``, so a file written by
either package loads in the other.
"""
from __future__ import annotations

import json
import os
import queue as queue_mod
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.core.apply import _map_packed
from repro_torch.core.codecs import runtime_delta_tree
from repro_torch.core.compress import compress
from repro_torch.core.pack import PackedDelta
from repro_torch.utils import iter_leaves, map_with_paths

# dtypes numpy cannot hold, stored as their raw bits (the sidecar names them)
_FROM_BITS = {"bfloat16": torch.bfloat16}


def _to_host(tree: Any) -> Any:
    """Packed runtime tree -> the same tree on host (CPU) tensors."""
    return _map_packed(lambda d: d.to("cpu"), tree)


def _save_npz(path: str, arrays: dict) -> None:
    """Atomic npz write (tmp + rename), with bf16 stored as raw uint16 bits
    and named in a JSON sidecar. Values are tensors or numpy arrays."""
    host, bit_dtypes = {}, {}
    for k, v in arrays.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            if v.dtype == torch.bfloat16:
                bit_dtypes[k] = "bfloat16"
                v = v.view(torch.int16).numpy().view(np.uint16)
            else:
                v = v.numpy()
        host[k] = np.asarray(v)
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz")
    os.close(fd)
    np.savez(tmp, **host)                # .npz suffix: savez keeps the name
    os.replace(tmp, path)
    with open(path + ".json", "w") as f:
        json.dump({"bit_dtypes": bit_dtypes, "leaves": sorted(host)}, f)


def _load_npz(path: str) -> dict:
    """npz -> {name: CPU tensor}; leaves the sidecar names as bf16 come
    back as bf16 (a view of their bits)."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    bit_dtypes = {}
    meta_path = path + ".json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            bit_dtypes = json.load(f).get("bit_dtypes", {})
    out = {}
    for k, a in arrays.items():
        name = bit_dtypes.get(k)
        if name is None:
            out[k] = torch.from_numpy(np.array(a))
        elif name in _FROM_BITS and a.dtype.itemsize == 2:
            out[k] = torch.from_numpy(np.array(a).view(np.int16)).view(_FROM_BITS[name])
        else:
            raise ValueError(f"{path}: leaf {k!r} holds {name} bits, which the "
                             "port cannot read")
    return out


_FIELDS = ("idx", "codes", "scale", "zero")


def _flatten_packed(tree: Any) -> dict:
    """{"<path>/<field>": tensor} over a runtime tree's PackedDelta leaves."""
    return {f"{p}/{f}": getattr(d, f) for p, d in iter_leaves(tree)
            if isinstance(d, PackedDelta) for f in _FIELDS}


def _skeleton(tree: Any) -> Any:
    """The tree's static part (PackedDelta meta, arrays dropped)."""
    return _map_packed(lambda d: d.with_arrays(None, None, None, None), tree)


def _unflatten_packed(skeleton: Any, arrays: dict) -> Any:
    return map_with_paths(
        lambda p, d: None if d is None else d.with_arrays(
            *[arrays[f"{p}/{f}"] for f in _FIELDS]), skeleton)


@dataclass
class TenantRecord:
    """One tenant's lifecycle state as the registry tracks it."""
    name: str
    state: str                        # queued|compressing|ready|hot|warm|cold|failed
    version: int = 0
    report: Any = None
    host: Any = None                  # warm tier: packed tree, CPU tensors
    treedef: Any = None               # for reloading the cold spool
    spool: Optional[str] = None       # cold tier: npz path
    prev: Any = None                  # previous version (host tree)
    prev_report: Any = None
    last_used: float = float("-inf")  # engine time of the last request
    compress_s: Optional[float] = None
    register_s: Optional[float] = None
    error: Optional[str] = None


class DeltaRegistry:
    """Compress-and-register service around a running engine.

    ::

        eng = ContinuousEngine(cfg, base, tenant_capacity=64, ...)
        reg = DeltaRegistry(eng, base, budget_bits=2.0,
                            watch_dir="incoming/", spool_dir="spool/")
        reg.ingest("support-bot", ft_params)     # or drop an npz in incoming/
        while serving:
            reg.scan(); reg.pump()               # lifecycle work between steps
            eng.step(eng._now())
        req = reg.submit("support-bot", prompt)  # promotes warm/cold first

    ``background=True`` moves compression to a worker thread (the
    serving loop keeps stepping; ``pump()`` picks up finished work).
    Registration itself ALWAYS happens on the caller's thread — the
    engine is not thread-safe, and in table mode registration is one
    cheap row write anyway.
    """

    def __init__(self, engine, base_params: Any, *, spec: Any = None,
                 codec: Optional[str] = "auto",
                 budget_bits: Optional[float] = 2.0,
                 spool_dir: Optional[str] = None,
                 watch_dir: Optional[str] = None,
                 host_capacity: int = 64,
                 background: bool = False):
        self.engine = engine
        self.base = base_params
        self.spec = spec
        self.codec = codec
        self.budget_bits = budget_bits if codec == "auto" else None
        self.spool_dir = spool_dir
        self.watch_dir = watch_dir
        self.host_capacity = int(host_capacity)
        self._records: dict[str, TenantRecord] = {}
        self._busy: set = set()   # names mid-registration: spill must skip
        self._seen_files: set = set()
        self._lock = threading.Lock()
        self._ready: List[tuple] = []     # (name, rt_host, report)
        self._inbox: queue_mod.Queue = queue_mod.Queue()
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()
        if background:
            self._worker = threading.Thread(target=self._worker_loop,
                                            daemon=True)
            self._worker.start()

    # -- ingestion ----------------------------------------------------------
    def ingest(self, name: str, ft_params: Any = None, *,
               deltas: Any = None, report: Any = None) -> TenantRecord:
        """Accept a fine-tuned checkpoint (or pre-compressed deltas).

        Raw params are compressed with the registry's codec/budget —
        inline, or queued to the background worker. The result becomes a
        *ready* record; ``pump()`` hot-registers it. Ingesting an
        existing name is a version rollout."""
        rec = self._records.get(name)
        if rec is None:
            rec = self._records[name] = TenantRecord(name=name,
                                                     state="queued")
        if deltas is not None:
            rt = runtime_delta_tree(deltas)
            with self._lock:
                self._ready.append((name, _to_host(rt), report))
            return rec
        if ft_params is None:
            raise ValueError(
                f"ingest({name!r}) needs ft_params or deltas; got neither")
        if self._worker is not None:
            rec.state = "queued"
            self._inbox.put((name, ft_params))
        else:
            self._compress_one(name, ft_params)
        return rec

    def scan(self) -> List[str]:
        """Pick up new ``<name>.npz`` checkpoints from the watched
        directory (flat param-path keys, the Checkpointer layout) and
        ingest them. Returns the names ingested this call."""
        if self.watch_dir is None or not os.path.isdir(self.watch_dir):
            return []
        out = []
        for fn in sorted(os.listdir(self.watch_dir)):
            if not fn.endswith(".npz") or fn in self._seen_files:
                continue
            self._seen_files.add(fn)
            name = fn[:-len(".npz")]
            ft = self._load_checkpoint(os.path.join(self.watch_dir, fn))
            self.ingest(name, ft)
            out.append(name)
        return out

    def _load_checkpoint(self, path: str) -> Any:
        arrays = _load_npz(path)
        missing = [p for p, _ in iter_leaves(self.base) if p not in arrays]
        if missing:
            raise ValueError(
                f"checkpoint {path} is missing {len(missing)} param "
                f"leaves (e.g. {missing[0]!r}); it must mirror the base "
                "params tree")
        return map_with_paths(lambda p, b: arrays[p].to(b.device), self.base)

    def _compress_one(self, name: str, ft_params: Any) -> None:
        rec = self._records[name]
        rec.state = "compressing"
        try:
            deltas, report = compress(self.base, ft_params, self.spec,
                                      codec=self.codec,
                                      budget_bits=self.budget_bits)
            rt = _to_host(runtime_delta_tree(deltas))
        except Exception as e:          # record, don't kill the worker
            rec.state = "failed"
            rec.error = f"{type(e).__name__}: {e}"
            return
        rec.compress_s = report.wall_s
        with self._lock:
            self._ready.append((name, rt, report))
        rec.state = "ready"

    def _worker_loop(self) -> None:
        while not self._stop.is_set():
            try:
                name, ft = self._inbox.get(timeout=0.05)
            except queue_mod.Empty:
                continue
            self._compress_one(name, ft)

    def close(self) -> None:
        self._stop.set()
        if self._worker is not None:
            self._worker.join(timeout=5.0)
            self._worker = None

    # -- hot registration ---------------------------------------------------
    def pump(self) -> List[str]:
        """Hot-register every compressed-and-ready tenant (serving-loop
        thread). Returns the names that went hot this call."""
        with self._lock:
            ready, self._ready = self._ready, []
        out = []
        for name, rt, report in ready:
            rec = self._records[name]
            if rec.host is not None:
                rec.prev, rec.prev_report = rec.host, rec.report
            rec.host, rec.report = rt, report
            rec.version += 1
            rec.spool = None            # stale spool: new version supersedes
            self._register(rec)
            out.append(name)
            self.engine.bus.emit("tenant_ready", self.engine._now(),
                                 tenant=name, version=rec.version,
                                 compress_s=rec.compress_s)
        self._spill_warm()
        return out

    def _register(self, rec: TenantRecord) -> None:
        # the busy guard is load-bearing: _ensure_capacity can evict a
        # victim, whose _spill_warm() would otherwise pick THIS record
        # (still state="warm") as the LRU spill target and drop its host
        # tree mid-promotion
        self._busy.add(rec.name)
        try:
            self._ensure_capacity(exclude=rec.name)
            t0 = time.perf_counter()
            self.engine.register_tenant(rec.name, rec.host, rec.report)
            rec.register_s = time.perf_counter() - t0
            rec.state = "hot"
        finally:
            self._busy.discard(rec.name)

    def _ensure_capacity(self, exclude: Optional[str] = None) -> None:
        """Make room in the engine's tenant table by evicting the
        least-recently-requested hot tenant (traffic-based eviction).
        No-op for dynamic-mode engines (they re-stack, no fixed rows)."""
        table = getattr(self.engine, "_table", None)
        if table is None:
            return
        while table.n_free == 0:
            self.engine._reclaim_retired()     # drained rollouts free rows
            if table.n_free:
                return
            victim = self._pick_victim(exclude)
            if victim is None:
                return      # nothing evictable: let register_tenant raise
            self.evict(victim)

    def _pick_victim(self, exclude: Optional[str]) -> Optional[str]:
        hot = [r for r in self._records.values()
               if r.state == "hot" and r.name != exclude
               and not self.engine._tenant_in_flight(r.name)
               and not any(q.tenant == r.name
                           for q in self.engine.queue.pending())]
        # hot tenants registered around the registry (engine-direct) are
        # not evictable: the registry has no warm copy to restore them
        if not hot:
            return None
        return min(hot, key=lambda r: (r.last_used, r.name)).name

    # -- tiers --------------------------------------------------------------
    def evict(self, name: str) -> None:
        """Demote a hot tenant to the warm (host RAM) tier; its table
        row is tombstoned and freed. Refuses (RuntimeError, from the
        engine) while the tenant has in-flight or queued requests."""
        rec = self._records[name]
        if rec.state != "hot":
            raise ValueError(f"tenant {name!r} is {rec.state}, not hot")
        self.engine.unregister_tenant(name)
        rec.state = "warm"
        self.engine.bus.emit("tenant_evict", self.engine._now(),
                             tenant=name, tier="warm",
                             last_used=rec.last_used)
        self._spill_warm()

    def _spill_warm(self) -> None:
        """Spill the least-recently-used warm records past
        ``host_capacity`` to the disk spool (cold tier)."""
        if self.spool_dir is None:
            return
        warm = [r for r in self._records.values()
                if r.state == "warm" and r.name not in self._busy]
        warm.sort(key=lambda r: (r.last_used, r.name))
        for rec in warm[:max(0, len(warm) - self.host_capacity)]:
            rec.spool = os.path.join(
                self.spool_dir, f"{rec.name}-v{rec.version}.npz")
            _save_npz(rec.spool, _flatten_packed(rec.host))
            rec.treedef = _skeleton(rec.host)
            rec.host = None
            rec.state = "cold"
            self.engine.bus.emit("tenant_evict", self.engine._now(),
                                 tenant=rec.name, tier="cold",
                                 last_used=rec.last_used)

    def promote(self, name: str) -> None:
        """Bring a warm/cold tenant back into the engine's tenant table
        (the first-request path; also callable for prewarming)."""
        rec = self._records.get(name)
        if rec is None or rec.state == "hot":
            return
        t0 = time.perf_counter()
        tier = rec.state
        if rec.state == "cold":
            rec.host = _unflatten_packed(rec.treedef, _load_npz(rec.spool))
            rec.state = "warm"
        if rec.state != "warm" or rec.host is None:
            raise ValueError(
                f"tenant {name!r} is not promotable (state={rec.state})")
        self._register(rec)
        self.engine.bus.emit("tenant_promote", self.engine._now(),
                             tenant=name, tier=tier,
                             promote_s=time.perf_counter() - t0)

    def rollback(self, name: str) -> None:
        """Roll a tenant back to its previous version (one rollout back;
        in-flight sequences of the current version drain on their row)."""
        rec = self._records[name]
        if rec.prev is None:
            raise ValueError(f"tenant {name!r} has no previous version")
        rec.host, rec.prev = rec.prev, rec.host
        rec.report, rec.prev_report = rec.prev_report, rec.report
        rec.version += 1
        if rec.state == "hot":
            self._register(rec)         # rollout path: new requests only
        # warm/cold records just swap payloads; next promotion serves old

    # -- traffic ------------------------------------------------------------
    def submit(self, tenant: Optional[str], prompt, **kw):
        """Queue a request, promoting the tenant first if it is not hot."""
        if tenant is not None:
            rec = self._records.get(tenant)
            if rec is not None:
                if rec.state in ("warm", "cold"):
                    self.promote(tenant)
                rec.last_used = self.engine._now()
        return self.engine.submit(tenant, prompt, **kw)

    # -- introspection ------------------------------------------------------
    def stats(self) -> dict:
        tiers: dict[str, int] = {}
        for r in self._records.values():
            tiers[r.state] = tiers.get(r.state, 0) + 1
        table = getattr(self.engine, "_table", None)
        return {
            "tenants": {n: r.state for n, r in sorted(self._records.items())},
            "tiers": tiers,
            "table_free_rows": table.n_free if table is not None else None,
            "pending_compress": self._inbox.qsize(),
            "ready": len(self._ready),
        }
