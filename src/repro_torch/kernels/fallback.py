"""Plain-torch delta-correction formulations (port of
``repro/kernels/fallback.py``).

These are the plain versions of the CUDA kernels: the CPU path, the
oracles ``chip_smoke.py`` holds the kernels against on the card, and the
out-of-envelope path. Two formulations with opposite scaling:

* :func:`dense_correction` — scatter the packed delta to a dense
  ``[h_in, h_out]`` matrix, then one matmul (prefill-sized T).
* :func:`gather_correction` — gather each kept element's activation by
  its flattened index and contract against the dequantized values
  (``y[t,o] = sum_{g,k} x[t, g*h_g + idx[g,k,o]] * val[g,k,o]``), never
  materializing the dense delta (decode-sized T).

Mixed-tenant decode adds :func:`gather_correction_rows` (per-row deltas)
and :func:`segment_correction` (rows sorted by tenant, each segment
routed to its tenant's packed bytes). :func:`dequant` and
:func:`fused_base_delta` are the plain versions of the merge-path and
fused kernels.

Bit-identity note: the gather contraction is an elementwise multiply
followed by ``sum`` over one merged (group, keep) axis, laid out
innermost — NOT a matmul or einsum, whose reduction order varies with
the batch extent. Each output element then reduces one contiguous row in
an order set by G*K alone: a row's correction has the same bits whether
it is computed alone, in a tenant group or in a mixed slot batch, and a
column's whether the matrix is whole or cut into output-column slices
over a serving mesh (a sum over a non-innermost axis vectorizes across
the columns, and its order then changes with their count). ``values=``/``res_map=`` (the
pre-decoded residency tier) skip the code unpack and feed the same
contraction, so resident rows keep those bits.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.pack import PackedDelta, decode_values, reconstruct_dense


def _note(site: str, **attrs) -> None:
    """Report the chosen formulation to an open trace context."""
    from repro_torch.serve.trace import note_path
    note_path(site, **attrs)


def _flat_gather_idx(d: PackedDelta, idx: torch.Tensor) -> torch.Tensor:
    """Local in-group indices [..., G, K, O] -> flat h_in indices (int64)."""
    base = (torch.arange(d.n_groups, dtype=torch.int64, device=idx.device)
            * d.h_g)[:, None, None]
    return idx.to(torch.int64) + base


def dense_correction(x2: torch.Tensor, d: PackedDelta) -> torch.Tensor:
    """x2 [T, h_in] @ dense(delta) -> [T, h_out] f32 (reconstruct path)."""
    # deltalint: allow[DL001] the reference's reconstruct path at prefill counts
    return x2.to(torch.float32) @ reconstruct_dense(d)


def _keep_last(t: torch.Tensor) -> torch.Tensor:
    """[..., G, K, O] -> [..., O, G*K] contiguous: the reduced axis
    innermost (see the module's bit-identity note)."""
    lead = t.shape[:-3]
    G, K, O = t.shape[-3:]
    return t.reshape(*lead, G * K, O).transpose(-1, -2).contiguous()


def gather_correction(x2: torch.Tensor, d: PackedDelta) -> torch.Tensor:
    """x2 [T, h_in] -> [T, h_out] f32 without materializing the dense delta."""
    vals = _keep_last(decode_values(d))                  # [O, G*K] f32
    O, GK = vals.shape
    gidx = _keep_last(_flat_gather_idx(d, d.idx)).reshape(-1)   # [O*G*K]
    sel = x2.to(torch.float32)[:, gidx].reshape(x2.shape[0], O, GK)
    # multiply + innermost-axis sum (not einsum): stable bits, see above
    return (sel * vals[None]).sum(dim=-1)


def dequant(d: PackedDelta) -> torch.Tensor:
    """The dense delta [..., h_in, h_out] f32."""
    return reconstruct_dense(d)


def fused_base_delta(x2: torch.Tensor, w: torch.Tensor,
                     d: PackedDelta) -> torch.Tensor:
    """x2 [T, h_in] @ (w + dense(delta)) -> [T, h_out] f32: the merged
    weight is formed in f32 (one rounding per element), then one matmul."""
    # deltalint: allow[DL001] the fused kernel's plain version: one merged-weight product
    return x2.to(torch.float32) @ (w.to(torch.float32) + reconstruct_dense(d))


def correction(x2: torch.Tensor, d: PackedDelta, *,
               gather_max_t: int = 64) -> torch.Tensor:
    """Formulation chooser: gather for decode-sized T, dense otherwise."""
    if x2.shape[0] <= gather_max_t:
        _note("correction", formulation="torch-gather", codec=d.codec,
              T=int(x2.shape[0]), gather_max_t=int(gather_max_t))
        return gather_correction(x2, d)
    _note("correction", formulation="torch-dense", codec=d.codec,
          T=int(x2.shape[0]), gather_max_t=int(gather_max_t))
    return dense_correction(x2, d)


def correction_nd(x: torch.Tensor, d: PackedDelta, *,
                  gather_max_t: Optional[int] = None) -> torch.Tensor:
    """x [..., h_in] -> [..., h_out] f32: flatten leading dims, choose the
    formulation, restore shape."""
    if gather_max_t is None:
        from repro_torch.kernels import autotune
        gather_max_t = autotune.lookup(
            d.h_g, d.keep, d.k_bits, d.h_in, d.h_out * d.shards)["gather_max_t"]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, d.h_in)
    y = correction(x2, d, gather_max_t=gather_max_t)
    return y.reshape(*lead, d.h_out)


def _rows_core(x_rows: torch.Tensor, gidx: torch.Tensor,
               vals: torch.Tensor) -> torch.Tensor:
    """Shared per-row contraction: x_rows [N, h_in], gidx [N, O*G*K] flat
    h_in indices, vals [N, O, G*K] -> [N, O] f32.

    Every per-row path funnels through this one function so the gather +
    reduce shapes — and therefore the bits — are identical across
    dispatch modes, and equal :func:`gather_correction`'s.
    """
    N = x_rows.shape[0]
    O, GK = vals.shape[1], vals.shape[2]
    sel = torch.gather(x_rows.to(torch.float32), 1, gidx)
    sel = sel.reshape(N, O, GK)
    return (sel * vals).sum(dim=-1)


def gather_correction_rows(x: torch.Tensor, d: PackedDelta,
                           values: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-row deltas: x [B, ..., h_in], d row-stacked [B] -> [B, ..., h_out].

    Peak extra memory is ``B * nnz`` floats (the gathered activations),
    not ``B * h_in * h_out``.

    ``values`` (optional f32 [B, G, K, O]) supplies pre-decoded kept
    values and skips the code unpack — the residency path. The decode is
    elementwise (``(q - z) * s`` after a bit unpack), so values decoded
    ahead of time equal values decoded here bit for bit, and the
    contraction below is unchanged.
    """
    B = x.shape[0]
    vals = decode_values(d) if values is None else values   # [B, G, K, O]
    _, G, K, O = vals.shape
    vals = _keep_last(vals)                          # [B, O, G*K]
    gidx = _keep_last(_flat_gather_idx(d, d.idx))    # [B, O, G*K]
    x2 = x.to(torch.float32).reshape(B, -1, d.h_in)
    T = x2.shape[1]
    # flatten (row, token) so the reduce shape matches gather_correction's
    # [rows, O, G*K] exactly — same bits as the shared-tenant path
    x_rows = x2.reshape(B * T, d.h_in)
    gidx_rows = gidx.reshape(B, 1, G * K * O).expand(B, T, G * K * O) \
        .reshape(B * T, -1)
    vals_rows = vals.reshape(B, 1, O, G * K).expand(B, T, O, G * K) \
        .reshape(B * T, O, G * K)
    y = _rows_core(x_rows, gidx_rows, vals_rows)
    return y.reshape(*x.shape[:-1], d.h_out)


def segment_correction(x2: torch.Tensor, d: PackedDelta,
                       seg_rows: torch.Tensor,
                       seg_offsets: torch.Tensor,
                       values: Optional[torch.Tensor] = None,
                       res_map: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Unique-tenant dispatch: x2 [T, h_in] rows sorted by tenant.

    ``d`` is the tenant-stacked packed delta [R, ...]; ``seg_rows`` [S]
    maps segment -> tenant row and ``seg_offsets`` [S+1] gives each
    segment's half-open row range (padding segments are empty). The
    packed bytes are routed to rows through the segment map and
    contracted by the same :func:`_rows_core` the per-row path uses.
    Rows that no segment covers, and rows of a segment whose tenant row
    is outside the stack, are zero, as in the kernel.

    ``values``/``res_map`` (optional) select the pre-decoded residency
    tier: ``values`` f32 [C, G, K, O] holds decoded kept values for C
    resident tenant rows and ``res_map`` int [R] maps tenant row ->
    residency row. The code unpack is skipped; the values were decoded at
    promotion by the same elementwise math, so the bits entering
    :func:`_rows_core` are unchanged.
    """
    T = x2.shape[0]
    _note("segment_correction", formulation="segments-torch", codec=d.codec,
          residency="values" if values is not None else "packed", T=int(T))
    # map each (sorted) row to its segment: count of segment ends <= row
    offs = seg_offsets.to(torch.int64)
    rows_iota = torch.arange(T, dtype=torch.int64, device=x2.device)
    row_seg = (rows_iota[:, None] >= offs[None, 1:]).sum(dim=1)
    covered = (rows_iota >= offs[0]) & (rows_iota < offs[-1])
    tenant_rows = seg_rows.to(torch.int64)[row_seg.clamp(max=seg_rows.shape[0] - 1)]
    covered &= (tenant_rows >= 0) & (tenant_rows < d.idx.shape[0])
    tenant_rows = torch.where(covered, tenant_rows, 0)   # [T]
    dl = d.with_arrays(d.idx[tenant_rows], d.codes[tenant_rows],
                       d.scale.to(torch.float32)[tenant_rows],
                       d.zero.to(torch.int32)[tenant_rows])
    vals = None
    if values is not None:
        vals = values[res_map.to(torch.int64)[tenant_rows]]   # [T, G, K, O]
    y = gather_correction_rows(x2[:, None, :], dl, values=vals)[:, 0]
    return torch.where(covered[:, None], y, 0.0)
