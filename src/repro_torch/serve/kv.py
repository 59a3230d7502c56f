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
Sharded caches (``shardings=``) come with the mesh; ``data_shards`` is
accounted at 1 only.
"""
from __future__ import annotations

from typing import Any, List

import torch

from repro_torch.configs.arch import ArchConfig
from repro_torch.models import lm


class SlotKVCache:
    """Fixed-slot device cache with mid-flight row insertion."""

    def __init__(self, cfg: ArchConfig, n_slots: int, max_seq: int, *,
                 data_shards: int = 1, device=None):
        if data_shards != 1:
            raise NotImplementedError(
                f"data_shards={data_shards}: per-shard slot pools come with "
                "the mesh, which the port does not serve yet")
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.data_shards = 1
        self.cache: Any = lm.init_cache(cfg, n_slots, max_seq, device=device)
        self._free: List[int] = list(range(n_slots))

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

    # -- device ops ---------------------------------------------------------
    def insert(self, slot: int, row_cache: Any) -> None:
        """Copy every leaf of a batch-1 cache into row ``slot`` of the
        shared cache (cast to the leaf's dtype, as decode's own writes
        are)."""
        for g, r in zip(self.cache, row_cache):
            rf = lm.cache_fields(r)
            for k, t in lm.cache_fields(g).items():
                t[slot].copy_(rf[k][0])

    def reset(self, slot: int) -> None:
        """Reset row ``slot`` to the ``init_cache`` values (every leaf
        zero, ``pos`` -1: invalid).

        Whole-prompt prefill overwrites the entire row at insert time;
        chunked prefill instead APPENDS into the claimed row, so the
        previous occupant's valid ``pos`` markers would be attended and
        its ssm/rec states carried into the new sequence."""
        for g in self.cache:
            for k, t in lm.cache_fields(g).items():
                t[slot].fill_(-1 if k == "pos" else 0)

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
        bi = torch.arange(self.n_slots, device=pos.device)
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
        back into every row where ``keep`` [n_slots] bool is False — the
        in-place counterpart of the reference's whole-cache
        ``jnp.where(act, new, old)``: rows that did not really decode get
        their pre-step entries and states back bit for bit."""
        bi = torch.arange(self.n_slots, device=pos.device)
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
