"""Slot-based KV cache for continuous batching (port of ``repro/serve/kv.py``).

One persistent decode cache of ``n_slots`` rows lives on the device. A
freshly prefilled sequence (a batch-1 cache) is *inserted* into a free
slot mid-flight without touching the other rows; a finished sequence
just releases its slot index — no device work, the row is garbage until
the next insert overwrites it.

The port's cache is the list of ``models.lm.init_cache`` entries — an
attention layer's ``{"k", "v", "pos"}`` ring, an ssm layer's
``SsmState`` (conv rings and SSD state), a rec layer's ``RecState`` —
and is updated in place: ``insert`` copies every leaf of one batch-1 row
into row ``slot``, ``reset`` writes the ``init_cache`` values into every
leaf of it (the reference's template insert, ``repro/serve/kv.py:111-130``).

``data_shards`` mirrors the scheduler's contiguous slot pools: slot ``i``
lives in pool ``i // (n_slots / data_shards)``; claims and releases are
accounted per pool (``n_free_shard``, ``shard_occupancy``). With
``shardings=`` (``launch.mesh.cache_shardings``) and the ``mesh=`` rank
that holds it, the process stores only its slice: its pool's slot rows
when the rows shard over ``data``, and its kv-heads of each attention
ring when those shard over ``model``. An ssm/rg-lru state stays whole on
every model rank, whatever width cut its placement names: each rank runs
the whole mixer, so a cut state would only be gathered back before it.
Writes to a slot of another pool are no-ops here: that pool's ranks make
them.
"""
from __future__ import annotations

from typing import Any, List

import torch

from repro_torch.configs.arch import ArchConfig
from repro_torch.models import lm


class SlotKVCache:
    """Fixed-slot device cache with mid-flight row insertion.

    ``rows`` is ``[lo, hi)``, the global slot range this process stores
    (all slots unless the cache is sharded over ``data``); ``cache``
    holds those rows, local row ``slot - lo``."""

    def __init__(self, cfg: ArchConfig, n_slots: int, max_seq: int, *,
                 shardings: Any = None, data_shards: int = 1, mesh=None,
                 device=None):
        from repro_torch.serve.scheduler import shard_pool_size
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.data_shards = data_shards
        self.shard_size = shard_pool_size(n_slots, data_shards)
        self.shardings = shardings
        self.mesh = mesh
        if shardings is not None and mesh is None:
            raise ValueError(f"shardings={type(shardings).__name__}: a sharded "
                             "SlotKVCache needs the mesh rank that holds it (mesh=)")
        self.rows = (0, n_slots)
        if shardings is not None:
            first = shardings[0]
            leaf0 = next(iter(first.values())) if isinstance(first, dict) else first[0]
            if leaf0[0] is not None:           # slot rows sharded over data
                if mesh.shape.get("data", 1) != data_shards:
                    raise ValueError(f"slot rows sharded over data="
                                     f"{mesh.shape.get('data', 1)} but data_shards="
                                     f"{data_shards}")
                lo = mesh.index("data") * self.shard_size
                self.rows = (lo, lo + self.shard_size)
        self.device = device
        self.cache: Any = self._alloc(self.rows[1] - self.rows[0])
        self._free: List[int] = list(range(n_slots))

    def _alloc(self, batch: int) -> list:
        """``init_cache`` values (zeros, ``pos`` -1) at this process's
        shapes: ``batch`` rows, and its slice of each sharded leaf."""
        if self.shardings is None:
            return lm.init_cache(self.cfg, batch, self.max_seq, device=self.device)
        from repro_torch.dist.sharding import map_cache
        from repro_torch.launch.mesh import local_shape
        from repro_torch.utils import resolve_device
        dev = resolve_device(self.device)
        full = lm.init_cache(self.cfg, batch, self.max_seq, device="meta")

        def group(g, placements):
            # rows come from ``batch``; a ring is cut on kv-heads, a
            # recurrent state (a NamedTuple) stays whole
            def make(name, leaf, placement):
                cut = (None, *placement[1:]) if isinstance(g, dict) else ()
                shape = local_shape(tuple(leaf.shape), cut, self.mesh)
                return torch.full(shape, -1 if name == "pos" else 0, dtype=leaf.dtype,
                                  device=dev)
            return map_cache(make, g, placements)
        return [group(g, p) for g, p in zip(full, self.shardings)]

    def holds(self, slot: int) -> bool:
        """Whether this process stores slot ``slot``."""
        return self.rows[0] <= slot < self.rows[1]

    def local(self, slot: int) -> int:
        """Slot ``slot``'s row in :attr:`cache`."""
        if not self.holds(slot):
            raise ValueError(f"slot {slot} is stored by another data rank "
                             f"(this one holds {self.rows})")
        return slot - self.rows[0]

    def empty_row(self) -> list:
        """A batch-1 cache at this process's shapes (``init_cache``
        values): what a prefill fills before :meth:`insert`."""
        return self._alloc(1)

    # -- slot accounting ----------------------------------------------------
    def claim(self, slot: int) -> None:
        """Mark a specific slot occupied (scheduler-chosen slot id).

        ValueError (not assert): a double-claim means the scheduler's
        slot table and this free list disagree — the next insert would
        overwrite a live sequence's cache row.
        """
        if slot not in self._free:
            raise ValueError(f"slot {slot} is not free")
        self._free.remove(slot)

    def release(self, slot: int) -> None:
        if slot in self._free:
            raise ValueError(f"slot {slot} double-freed")
        self._free.append(slot)

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def occupancy(self) -> float:
        return 1.0 - len(self._free) / self.n_slots

    def shard_of(self, slot: int) -> int:
        """Data shard owning ``slot`` (contiguous pools, scheduler layout)."""
        return slot // self.shard_size

    def n_free_shard(self, shard: int) -> int:
        return sum(1 for s in self._free if self.shard_of(s) == shard)

    def shard_occupancy(self) -> List[float]:
        """Occupied fraction of each data shard's slot pool."""
        return [1.0 - self.n_free_shard(s) / self.shard_size
                for s in range(self.data_shards)]

    # -- device ops ---------------------------------------------------------
    def insert(self, slot: int, row_cache: Any) -> None:
        """Copy every leaf of a batch-1 cache into row ``slot`` of the
        shared cache (cast to the leaf's dtype, as decode's own writes
        are); a no-op for a slot another data rank stores."""
        if not self.holds(slot):
            return
        i = self.local(slot)
        for g, r in zip(self.cache, row_cache):
            rf = lm.cache_fields(r)
            for k, t in lm.cache_fields(g).items():
                t[i].copy_(rf[k][0])

    def reset(self, slot: int) -> None:
        """Reset row ``slot`` to the ``init_cache`` values (every leaf
        zero, ``pos`` -1: invalid); a no-op for another data rank's slot.

        Whole-prompt prefill overwrites the entire row at insert time;
        chunked prefill instead APPENDS into the claimed row, so the
        previous occupant's valid ``pos`` markers would be attended and
        its ssm/rec states carried into the new sequence."""
        if not self.holds(slot):
            return
        i = self.local(slot)
        for g in self.cache:
            for k, t in lm.cache_fields(g).items():
                t[i].fill_(-1 if k == "pos" else 0)

    def update(self, new_cache: Any) -> None:
        """Swap in the post-step cache (the in-place steps return the
        same list)."""
        self.cache = new_cache

    # -- masked decode (chunked mode) ----------------------------------------
    def ring_entries(self, pos: torch.Tensor) -> list:
        """Copies of what a decode step writes in each row: an attention
        layer's ring entry at ``pos % S_c`` per row (k, v and pos), an
        ssm/rec layer's whole state (every leaf, every row)."""
        out = []
        bi = torch.arange(pos.shape[0], device=pos.device)
        for g in self.cache:
            if isinstance(g, tuple):
                out.append(tuple(t.clone() for t in g))
                continue
            slot = pos % g["k"].shape[1]
            out.append(tuple(g[k][bi, slot].clone() for k in ("k", "v", "pos")))
        return out

    def restore_entries(self, pos: torch.Tensor, saved: list,
                        keep: torch.Tensor) -> None:
        """Put ``saved`` (from :meth:`ring_entries` at the same ``pos``)
        back into every row where ``keep`` [rows] bool is False — the
        in-place counterpart of the reference's whole-cache
        ``jnp.where(act, new, old)``: rows that did not really decode get
        their pre-step entries and states back bit for bit."""
        bi = torch.arange(pos.shape[0], device=pos.device)
        for g, old in zip(self.cache, saved):
            if isinstance(g, tuple):
                for t, o in zip(g, old):
                    m = keep.reshape(keep.shape + (1,) * (t.ndim - 1))
                    t.copy_(torch.where(m, t, o))
                continue
            slot = pos % g["k"].shape[1]
            for k, o in zip(("k", "v", "pos"), old):
                new = g[k][bi, slot]
                m = keep.reshape(keep.shape + (1,) * (new.ndim - 1))
                g[k][bi, slot] = torch.where(m, new, o)
