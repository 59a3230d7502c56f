"""Optimal group-size search (paper §3.3, Table 4) (port of
``repro/core/groupsearch.py``).

Candidates: h_g in {alpha, alpha*2, alpha*4, ..., h_in}. Two selectors:

* ``search_direct``  — compress the whole model at each candidate and score
  the true downstream objective (eval loss / accuracy). Expensive.
* ``search_proxy``   — the paper's proxy: compress only the first layer's
  Q/K projections and score the attention-matrix error
  ``||Q1 K1^T - Q1_hat K1_hat^T||^2`` on ~1% calibration data (Eq. 5).
  All layers share one h_g*; shallow layers are most compression-sensitive,
  so layer 1 is the probe.

The search reconstructs each compressed delta densely
(``pack.reconstruct_dense``, the plain formulation) and never goes through
``kernels.ops``: candidates run up to h_g = h_in, far outside the
kernels' envelope, as the reference's XLA search is outside its Pallas
kernels'. It runs on the device of its inputs.

The dropout keys are an argument: ``keys[h_g] = (u_q, u_k)``, the uniform
keys of Q's and K's packing at that candidate (the reference's
``split(fold_in(rng, h_g))`` draws), so a caller that hands both packages
the same keys gets the same errors; candidates without keys draw them
from ``generator``.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, Mapping, Optional, Sequence

import torch

from repro_torch.core.codecs import DeltaDQSpec
from repro_torch.core.dropout import groupwise_dropout_pack
from repro_torch.core.pack import reconstruct_dense


def candidate_group_sizes(h_in: int, alpha: float) -> list[int]:
    out, hg = [], int(alpha)
    while hg <= h_in:
        if h_in % hg == 0:
            out.append(hg)
        hg *= 2
    if not out or out[-1] != h_in:
        out.append(h_in)
    return out


def attention_proxy_error(x: torch.Tensor,
                          wq_b: torch.Tensor, wk_b: torch.Tensor,
                          wq_f: torch.Tensor, wk_f: torch.Tensor,
                          h_g: int, spec: DeltaDQSpec, *,
                          keys: Optional[tuple] = None,
                          generator: Optional[torch.Generator] = None,
                          head_dim: Optional[int] = None) -> torch.Tensor:
    """||Q K^T - Qhat Khat^T||^2 with layer-1 deltas compressed at h_g
    (an f32 0-d tensor).

    ``keys`` = (u_q, u_k), the uniform dropout keys of the two packings
    (``[G, h_g, O]`` each); without them they are drawn from
    ``generator``. GQA-aware: when q_dim != kv_dim (or head_dim is given),
    scores are computed per head with KV heads broadcast to their query
    groups.
    """
    # the difference in the weights' own dtype, then f32, as the reference
    dq = (wq_f - wq_b).to(torch.float32)
    dk = (wk_f - wk_b).to(torch.float32)
    u_q, u_k = keys if keys is not None else (None, None)
    pq = groupwise_dropout_pack(dq, h_g=h_g, alpha=spec.alpha, k_bits=spec.k_bits,
                                m=spec.m, u=u_q, generator=generator)
    pk = groupwise_dropout_pack(dk, h_g=h_g, alpha=spec.alpha, k_bits=spec.k_bits,
                                m=spec.m, u=u_k, generator=generator)
    x = x.to(torch.float32)
    # jnp's promotion: a bf16 base weight plus an f32 delta is f32
    q = x @ (wq_b + dq)
    k = x @ (wk_b + dk)
    qh = x @ (wq_b + reconstruct_dense(pq))
    kh = x @ (wk_b + reconstruct_dense(pk))

    q_dim, kv_dim = q.shape[-1], k.shape[-1]
    if head_dim is None and q_dim != kv_dim:
        head_dim = math.gcd(q_dim, kv_dim)

    def scores(qm, km):
        if head_dim is None:
            return torch.einsum("td,sd->ts", qm, km)
        t = qm.shape[0]
        qs = qm.reshape(t, q_dim // head_dim, head_dim)
        ks = km.reshape(t, kv_dim // head_dim, head_dim)
        ks = torch.repeat_interleave(ks, q_dim // kv_dim, dim=1)
        return torch.einsum("thd,shd->hts", qs, ks)

    return torch.sum((scores(q, k) - scores(qh, kh)) ** 2)


@dataclass
class SearchResult:
    h_g_star: int
    errors: dict           # h_g -> score (proxy error or direct loss)
    seconds: float
    method: str


def search_proxy(x_calib: torch.Tensor,
                 wq_b, wk_b, wq_f, wk_f,
                 spec: DeltaDQSpec, *,
                 keys: Optional[Mapping[int, tuple]] = None,
                 generator: Optional[torch.Generator] = None,
                 candidates: Sequence[int] | None = None) -> SearchResult:
    """Pick h_g* minimizing the attention proxy error on calibration input.

    ``x_calib``: [t, d_model] layer-1 inputs for ~1% of the eval set.
    ``keys[h_g]`` = (u_q, u_k) per candidate (see the module doc); without
    them each candidate's keys come from ``generator``, or from a
    generator on ``x_calib``'s device seeded with ``spec.seed``.
    """
    if generator is None and keys is None:
        generator = torch.Generator(device=x_calib.device)
        generator.manual_seed(spec.seed)
    keys = keys or {}
    h_in = wq_b.shape[0]
    cands = list(candidates) if candidates else candidate_group_sizes(h_in, spec.alpha)
    t0 = time.perf_counter()
    errs = {}
    for hg in cands:
        errs[hg] = float(attention_proxy_error(x_calib, wq_b, wk_b, wq_f, wk_f,
                                               hg, spec, keys=keys.get(hg),
                                               generator=generator))
    best = min(errs, key=errs.get)
    return SearchResult(best, errs, time.perf_counter() - t0, "proxy")


def search_direct(score_fn: Callable[[int], float],
                  h_in: int, spec: DeltaDQSpec,
                  candidates: Sequence[int] | None = None) -> SearchResult:
    """Direct search: ``score_fn(h_g)`` returns a loss to minimize (e.g. full
    eval loss of the compressed model). The paper's expensive reference."""
    cands = list(candidates) if candidates else candidate_group_sizes(h_in, spec.alpha)
    t0 = time.perf_counter()
    errs = {hg: float(score_fn(hg)) for hg in cands}
    best = min(errs, key=errs.get)
    return SearchResult(best, errs, time.perf_counter() - t0, "direct")
