"""Multi-tenant serving — the paper's deployment scheme (Fig. 2/3).

Port of the static reference engine of ``repro/serve/engine.py``: one
**base model** is resident; each *tenant* registers only its
DeltaDQ-compressed delta, and :meth:`Engine.generate` serves one tenant
group with the separate computation at every linear site. It loops
``lm.prefill`` and ``lm.decode_step`` eagerly. ``serve_batch`` and the
continuous-batching ``ContinuousEngine`` (slot KV cache, residency,
chunked prefill) are the next slice; its mixed-tenant decode step is
already served by ``lm.decode_step`` with a slot-dispatched delta tree
(``core.apply.wrap_slot_deltas``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.configs.arch import ArchConfig
from repro_torch.core.codecs import runtime_delta_tree
from repro_torch.core.compress import CompressionReport
from repro_torch.models import lm


def mask_after_stop(gen: np.ndarray, stop_token: int) -> np.ndarray:
    """Replace every token *after* the first stop token with the stop token.

    ``gen`` [B, T] int. Explicit zero-filled shift: a stop token in the
    final step must not wrap around and corrupt column 0.
    """
    stopped = np.cumsum(gen == stop_token, axis=1) > 0
    after = np.zeros_like(stopped)
    after[:, 1:] = stopped[:, :-1]
    return np.where(after, stop_token, gen)


@dataclasses.dataclass
class Tenant:
    name: str
    deltas: Any                       # PackedDelta tree mirroring params
    report: Optional[CompressionReport] = None


class DeltaStore:
    """Registry of compressed per-tenant deltas.

    ``version`` bumps on every registration; registration order is
    stable, so tenant row indices never shift under appends.
    """

    def __init__(self):
        self._tenants: dict[str, Tenant] = {}
        self.version = 0

    def register(self, name: str, deltas: Any, report=None, *,
                 replace: bool = False) -> Tenant:
        if name in self._tenants and not replace:
            raise ValueError(
                f"tenant {name!r} is already registered; pass replace=True")
        t = Tenant(name, deltas, report)
        self._tenants[name] = t
        self.version += 1
        return t

    def unregister(self, name: str) -> None:
        self._tenants.pop(name, None)
        self.version += 1

    def get(self, name: str) -> Tenant:
        return self._tenants[name]

    def names(self):
        return sorted(self._tenants)

    def ordered(self) -> List[Tenant]:
        """Tenants in registration order (stable stack rows)."""
        return list(self._tenants.values())


class Engine:
    """Static per-tenant-batch engine: the reference serving path.

    Runs on the device of ``base_params`` (``cuda`` unless the caller
    built the params on the CPU)."""

    def __init__(self, cfg: ArchConfig, base_params: Any, max_seq: int = 256):
        self.cfg = cfg
        self.base = base_params
        self.max_seq = max_seq
        self.store = DeltaStore()
        self.device = base_params["embed"]["tok"].device

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
