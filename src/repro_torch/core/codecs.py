"""Pluggable delta codecs: one compression interface, many formats
(port of ``repro/core/codecs.py``).

A :class:`DeltaCodec` packages what the rest of the port needs to know
about one delta-compression format:

* ``compress_leaf``     — (base, ft) weight pair -> codec leaf
* ``reconstruct_dense`` — codec leaf -> f32 [..., h_in, h_out] delta
* ``decode_values``     — per-row kept values of the *runtime* form
* ``storage_bits``      — paper/honest storage accounting per leaf
* ``runtime_packed``    — codec leaf -> :class:`PackedDelta`
* ``to_storage_parts`` / ``from_storage_parts`` — offline (numpy)
  serialization of one matrix's leaf: ``(parts, meta)`` and back, onto
  the caller's device

The last method is the serving contract: every codec lowers its leaf to
the structured :class:`~repro_torch.core.pack.PackedDelta` runtime
layout (dense-as-structured when the codec has no sparsity), tagged with
the codec's name, so every decode path — the CUDA kernels included —
serves any codec unchanged. The lowering is *bit-faithful*:
``pack.reconstruct_dense(runtime_packed(leaf))`` equals
``codec.reconstruct_dense(leaf)`` exactly, which is what extends the
token-identity contract to mixed-codec serving.

Registered codecs:

* ``deltadq``  — the paper's group-wise dropout + separate quantization
  (the registry default; :class:`DeltaDQSpec`).
* ``bitdelta`` — 1-bit sign bitmap + per-tensor scale = mean |delta|
  (arXiv 2402.10193; :class:`BitDeltaSpec`).
* ``lowrank``  — int-quantized dense core + rank-r f32 residual factors
  (:class:`LowRankSpec`); the factors come from numpy's SVD on the host,
  as the reference's do, so both packages get the same factors.

A leaf with leading stack dims (layers) is lowered and compressed one
matrix at a time: the per-tensor scales are per matrix either way, and a
full-width ``[32, 4096, 11008]`` leaf never needs its int32 temporaries
at once.

``leaf_spec`` is the dry run's shape-only twin of ``compress_leaf``: the
codec leaf whose array fields are ``(shape, dtype)`` pairs, the port's
stand-in for ``jax.ShapeDtypeStruct`` (``utils.materialize`` allocates
them, on the ``meta`` device for the dry run). ``leaf_axes`` is its
sharding twin: the same leaf with a tuple of logical axis names in each
array field (``dist.sharding`` maps them to mesh axes).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core import quant
from repro_torch.core.dropout import groupwise_dropout_pack, keep_count
from repro_torch.core.pack import PackedDelta
from repro_torch.core import pack as pack_lib
from repro_torch.utils import resolve_device, tree_map


# ---------------------------------------------------------------------------
# Specs (small frozen hyperparameter records; one per codec)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class DeltaDQSpec:
    """DeltaDQ hyperparameters (group-wise dropout + separate quant)."""
    alpha: float = 8.0            # dropout compression (keep-rate 1/alpha)
    k_bits: Optional[int] = None  # None -> dropout only (paper's 2x..8x rows)
    m: int = 1                    # separate-quantization parts
    h_g: Optional[int] = None     # None -> use h_in (row-wise)
    seed: int = 0

    def ratio(self) -> float:
        return quant.compression_ratio(self.alpha, self.k_bits, self.m)


@dataclass(frozen=True)
class BitDeltaSpec:
    """BitDelta: sign bitmap + per-tensor scale = mean |delta|."""
    seed: int = 0

    def ratio(self) -> float:
        return 16.0               # 1 bit per element vs bf16


@dataclass(frozen=True)
class LowRankSpec:
    """Quantized dense core + rank-r f32 residual factors. (No ``ratio``:
    the factors' share of the bits depends on the matrix's shape.)"""
    rank: int = 8
    k_bits: int = 4
    seed: int = 0


def _pick_hg(h_in: int, spec: DeltaDQSpec) -> int:
    if spec.h_g is None:
        return h_in
    # clamp to a divisor of h_in: largest halving of h_g dividing h_in.
    # Candidates below alpha are unsatisfiable (keep would round to 0).
    floor = max(spec.alpha, 1.0)
    hg = min(spec.h_g, h_in)
    if hg < floor:
        raise ValueError(
            f"unsatisfiable group size: requested h_g={spec.h_g} "
            f"(clamped to {hg} for h_in={h_in}) is below alpha={spec.alpha}; "
            f"every group must keep h_g/alpha >= 1 elements, so pick "
            f"h_g >= alpha")
    while h_in % hg:
        hg //= 2
        if hg < floor:
            raise ValueError(
                f"unsatisfiable group size: no halving of h_g={spec.h_g} "
                f"both divides h_in={h_in} and stays >= alpha={spec.alpha}")
    return int(hg)


def _runtime_hg(h_in: int) -> int:
    """Group size for dense-as-structured runtime lowering: the largest
    divisor of h_in within the kernel envelope (h_g <= MAX_HG and, since
    these lowerings keep every element, keep = h_g <= MAX_KEEP = 128)."""
    for hg in range(min(h_in, 128), 0, -1):
        if h_in % hg == 0:
            return hg
    return 1


def _lead_scalar(lead: tuple, value, dtype, device) -> torch.Tensor:
    """Per-tensor scalar in PackedDelta convention: a 0-d tensor without
    leading stack dims, a [lead]-shaped one with them."""
    return torch.full(lead, value, dtype=dtype, device=device)


def _dense_as_structured(codes: torch.Tensor, scale: torch.Tensor,
                         zero: torch.Tensor, h_in: int, h_out: int, hg: int,
                         k_bits: Optional[int], codec: str) -> PackedDelta:
    """Wrap per-group codes [..., G, hg|kp, O] as a keep-everything
    PackedDelta (idx = arange within each group). ``idx`` is materialized
    contiguous, not a stride-0 broadcast, and ``codes`` made contiguous
    (bit packing along a group whose size is no multiple of the codes a
    byte holds returns a strided view): the kernels take contiguous tiles
    only."""
    lead_g = codes.shape[:-2]
    idx = torch.arange(hg, dtype=torch.uint8, device=codes.device)[:, None]
    idx = idx.expand(*lead_g, hg, h_out).contiguous()
    return PackedDelta(idx=idx, codes=codes.contiguous(), scale=scale, zero=zero,
                       h_in=h_in, h_out=h_out, h_g=hg, keep=hg,
                       alpha=1.0, k_bits=k_bits, m=1, codec=codec)


def _per_matrix(leaf, fn: Callable[[Any], torch.Tensor]) -> torch.Tensor:
    """``fn`` of every matrix of a possibly stacked leaf, written into one
    tensor with the leaf's stack dims (one matrix's temporaries at a
    time)."""
    lead = leaf.stack_shape()
    if not lead:
        return fn(leaf)
    flat = leaf.flat()
    first = fn(flat.index(0))
    out = torch.empty((flat.stack_shape()[0], *first.shape), dtype=first.dtype,
                      device=first.device)
    out[0] = first
    for i in range(1, out.shape[0]):
        out[i] = fn(flat.index(i))
    return out.reshape(*lead, *first.shape)


def _shape_of(leaf) -> tuple:
    """The shape of a weight given as a tensor or a ``(shape, dtype)``
    spec."""
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf[0])


def _check_unstacked(leaf) -> None:
    """The storage layer works per matrix: a stacked leaf raises."""
    if leaf.stack_shape():
        raise ValueError(
            "storage layer operates per-matrix; got stacked leaf with "
            f"stack_shape={leaf.stack_shape()}")


# ---------------------------------------------------------------------------
# Codec leaves for the non-DeltaDQ formats
# ---------------------------------------------------------------------------
@dataclass
class BitDeltaLeaf:
    """BitDelta-compressed delta for one [h_in, h_out] weight.

    ``sign`` is the bit-packed (along h_in) sign bitmap, uint8
    [..., ceil(h_in/8), h_out] with bit 1 = positive; ``scale`` is the
    per-tensor mean |delta| (f32, shape = the stack dims).
    """
    sign: torch.Tensor
    scale: torch.Tensor
    h_in: int
    h_out: int

    def stack_shape(self) -> tuple[int, ...]:
        return tuple(self.sign.shape[:-2])

    def index(self, i) -> "BitDeltaLeaf":
        return replace(self, sign=self.sign[i], scale=self.scale[i])

    def flat(self) -> "BitDeltaLeaf":
        """The stack dims merged into one."""
        return replace(self, sign=self.sign.reshape(-1, *self.sign.shape[-2:]),
                       scale=self.scale.reshape(-1))

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.sign, self.scale))


@dataclass
class LowRankLeaf:
    """Quantized core + rank-r residual for one [h_in, h_out] weight.

    ``codes`` are bit-packed (along h_in) k-bit core codes, uint8
    [..., packed_len(h_in, k), h_out]; ``scale``/``zero`` the per-tensor
    quant params; ``u`` [..., h_in, r] / ``v`` [..., r, h_out] the f32
    residual factors of delta - dequant(core) (u absorbs the singular
    values). Reconstruction: dequant(core) + u @ v.
    """
    codes: torch.Tensor
    scale: torch.Tensor
    zero: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    h_in: int
    h_out: int
    k_bits: int
    rank: int

    def stack_shape(self) -> tuple[int, ...]:
        return tuple(self.codes.shape[:-2])

    def index(self, i) -> "LowRankLeaf":
        return replace(self, **{k: getattr(self, k)[i]
                                for k in ("codes", "scale", "zero", "u", "v")})

    def flat(self) -> "LowRankLeaf":
        """The stack dims merged into one."""
        return replace(self, codes=self.codes.reshape(-1, *self.codes.shape[-2:]),
                       scale=self.scale.reshape(-1), zero=self.zero.reshape(-1),
                       u=self.u.reshape(-1, *self.u.shape[-2:]),
                       v=self.v.reshape(-1, *self.v.shape[-2:]))

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.codes, self.scale, self.zero, self.u, self.v))


# ---------------------------------------------------------------------------
# The codec interface
# ---------------------------------------------------------------------------
class DeltaCodec:
    """One delta-compression format behind the common interface.

    Subclasses set ``name``, ``spec_cls`` and ``leaf_cls`` and implement
    the methods below. ``compress_leaf`` takes one [h_in, h_out] matrix
    pair (stacked leaves are compressed a matrix at a time by
    ``core.compress``); ``generator`` feeds codecs that draw (DeltaDQ's
    dropout keys). ``storage_bits`` returns ``value_bits`` (the paper's
    values-only convention) and ``total_bits`` (honest: + indices,
    factors, metadata) for the whole possibly-stacked leaf.
    """

    name: str = "?"
    spec_cls: type = object
    leaf_cls: type = object

    def default_spec(self):
        return self.spec_cls()

    def compress_leaf(self, base_leaf: torch.Tensor, ft_leaf: torch.Tensor, spec,
                      *, generator: Optional[torch.Generator] = None):
        raise NotImplementedError

    def reconstruct_dense(self, leaf) -> torch.Tensor:
        raise NotImplementedError

    def runtime_packed(self, leaf) -> PackedDelta:
        raise NotImplementedError

    def decode_values(self, leaf) -> torch.Tensor:
        """Kept values [..., G, K, O] of the runtime form."""
        return pack_lib.decode_values(self.runtime_packed(leaf))

    def storage_bits(self, leaf) -> dict:
        raise NotImplementedError

    def to_storage_parts(self, leaf) -> tuple[Any, dict]:
        """One matrix's leaf -> (host numpy parts, meta dict); a stacked
        leaf raises ValueError (the storage layer works per matrix)."""
        raise NotImplementedError

    def from_storage_parts(self, parts, meta: dict, *, device=None):
        """The inverse of :meth:`to_storage_parts`, onto ``device``
        (``cuda`` unless the caller names another)."""
        raise NotImplementedError

    def leaf_spec(self, leaf, spec):
        """The codec leaf that compressing a weight shaped like ``leaf``
        (a tensor or a ``(shape, dtype)`` spec) with ``spec`` gives, with
        ``(shape, dtype)`` pairs for its arrays: nothing is compressed."""
        raise NotImplementedError

    def leaf_axes(self, leaf, axes: tuple, spec, model_axis_size: int):
        """The codec leaf that compressing a weight shaped like ``leaf``
        with logical ``axes`` gives, with each array field's logical axes
        (a tuple of names or None per dimension) in its place."""
        raise NotImplementedError

    def planned_total_bits(self, shape: tuple, spec) -> Optional[float]:
        """``storage_bits(...)["total_bits"]`` of the leaf that compressing
        a weight of ``shape`` with ``spec`` would give, where the shapes
        alone fix it without compressing; None otherwise."""
        return None


# ---------------------------------------------------------------------------
# DeltaDQ (the first registered codec; leaf IS the runtime layout)
# ---------------------------------------------------------------------------
class DeltaDQCodec(DeltaCodec):
    """The paper's codec: group-wise dropout + separate quantization."""

    name = "deltadq"
    spec_cls = DeltaDQSpec
    leaf_cls = PackedDelta

    def default_spec(self):
        # the launcher's 128x deployment point (alpha 8, k4, m8)
        return DeltaDQSpec(alpha=8.0, k_bits=4, m=8, h_g=16)

    def compress_leaf(self, base_leaf: torch.Tensor, ft_leaf: torch.Tensor,
                      spec: DeltaDQSpec, *, u: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> PackedDelta:
        delta = ft_leaf.to(torch.float32) - base_leaf.to(torch.float32)
        hg = _pick_hg(delta.shape[-2], spec)
        return groupwise_dropout_pack(delta, h_g=hg, alpha=spec.alpha,
                                      k_bits=spec.k_bits, m=spec.m, u=u,
                                      generator=generator)

    def reconstruct_dense(self, leaf: PackedDelta) -> torch.Tensor:
        return pack_lib.reconstruct_dense(leaf)

    def runtime_packed(self, leaf: PackedDelta) -> PackedDelta:
        return leaf

    def storage_bits(self, leaf: PackedDelta) -> dict:
        stack = math.prod(leaf.stack_shape())
        vb = leaf.value_bits() * stack
        return {"value_bits": vb, "total_bits": vb + leaf.index_bits() * stack}

    def to_storage_parts(self, leaf: PackedDelta):
        _check_unstacked(leaf)
        meta = {"codec": self.name, "h_in": leaf.h_in, "h_out": leaf.h_out,
                "h_g": leaf.h_g, "keep": leaf.keep, "alpha": leaf.alpha,
                "k_bits": leaf.k_bits, "m": leaf.m,
                "scale": float(leaf.scale), "zero": int(leaf.zero)}
        if leaf.k_bits is None:
            parts = {"idx": leaf.idx.cpu().numpy(),
                     "values": leaf.codes.cpu().numpy()}
            return parts, meta
        return pack_lib.to_storage_parts(leaf), meta

    def from_storage_parts(self, parts, meta: dict, *, device=None) -> PackedDelta:
        dev = resolve_device(device)
        if meta["k_bits"] is None:
            hg = meta["h_g"]
            return PackedDelta(
                idx=torch.from_numpy(np.asarray(parts["idx"])).to(pack_lib.idx_dtype(hg)).to(dev),
                codes=torch.from_numpy(np.asarray(parts["values"], np.float32)).to(dev),
                scale=pack_lib.scalar_tensor(meta["scale"], torch.float32, dev),
                zero=pack_lib.scalar_tensor(meta["zero"], torch.int32, dev),
                h_in=meta["h_in"], h_out=meta["h_out"], h_g=hg,
                keep=meta["keep"], alpha=meta["alpha"], k_bits=None,
                m=meta["m"])
        return pack_lib.from_storage_parts(
            parts, h_in=meta["h_in"], h_out=meta["h_out"], h_g=meta["h_g"],
            keep=meta["keep"], alpha=meta["alpha"], k_bits=meta["k_bits"],
            scale=meta["scale"], zero=meta["zero"], device=dev)

    def leaf_spec(self, leaf, spec: DeltaDQSpec) -> PackedDelta:
        shape = _shape_of(leaf)
        lead, (h_in, h_out) = shape[:-2], shape[-2:]
        hg = _pick_hg(h_in, spec)
        # the helpers real packing uses (dropout.keep_count, quant.packed_len):
        # shape-only specs cannot drift from what packing produces
        keep = keep_count(hg, spec.alpha)
        G = h_in // hg
        if spec.k_bits is None:
            codes = ((*lead, G, keep, h_out), torch.float32)
        else:
            codes = ((*lead, G, quant.packed_len(keep, spec.k_bits), h_out), torch.uint8)
        return PackedDelta(
            idx=((*lead, G, keep, h_out), pack_lib.idx_dtype(hg)),
            codes=codes, scale=(lead, torch.float32), zero=(lead, torch.int32),
            h_in=h_in, h_out=h_out, h_g=hg, keep=keep, alpha=float(spec.alpha),
            k_bits=spec.k_bits, m=spec.m)

    def leaf_axes(self, leaf, axes: tuple, spec: DeltaDQSpec,
                  model_axis_size: int) -> PackedDelta:
        """idx/codes ``[lead..., G, K, O]``: O takes the weight's output
        axis; G its input axis only when group boundaries align with the
        shard boundaries (G divisible by the mesh axis), else replicated;
        scale/zero the lead axes (``repro/core/codecs.py:343``)."""
        d = self.leaf_spec(leaf, spec)
        lead_ax = tuple(axes[:-2])
        in_ax, out_ax = axes[-2], axes[-1]
        g_ax = in_ax if d.n_groups % max(model_axis_size, 1) == 0 else None
        arr_ax = (*lead_ax, g_ax, None, out_ax)
        return PackedDelta(idx=arr_ax, codes=arr_ax, scale=lead_ax, zero=lead_ax,
                           h_in=d.h_in, h_out=d.h_out, h_g=d.h_g, keep=d.keep,
                           alpha=d.alpha, k_bits=d.k_bits, m=d.m)


# ---------------------------------------------------------------------------
# BitDelta: sign bitmap + per-tensor scale (arXiv 2402.10193)
# ---------------------------------------------------------------------------
class BitDeltaCodec(DeltaCodec):
    name = "bitdelta"
    spec_cls = BitDeltaSpec
    leaf_cls = BitDeltaLeaf

    def compress_leaf(self, base_leaf, ft_leaf, spec: BitDeltaSpec, *,
                      generator=None) -> BitDeltaLeaf:
        delta = ft_leaf.to(torch.float32) - base_leaf.to(torch.float32)
        h_in, h_out = delta.shape[-2:]
        scale = torch.mean(torch.abs(delta), dim=(-2, -1))
        sign = (delta >= 0).to(torch.uint8)       # 1 = +scale, 0 = -scale
        packed = quant.pack_bits(sign, 1, axis=sign.ndim - 2)
        return BitDeltaLeaf(sign=packed, scale=scale.to(torch.float32),
                            h_in=h_in, h_out=h_out)

    @staticmethod
    def _sign_codes(leaf: BitDeltaLeaf) -> torch.Tensor:
        """Unpacked {0, 1} sign codes [..., h_in, h_out] int32."""
        return quant.unpack_bits(leaf.sign, 1, leaf.h_in, axis=leaf.sign.ndim - 2)

    def reconstruct_dense(self, leaf: BitDeltaLeaf) -> torch.Tensor:
        # EXACTLY the runtime decode math ((q - zero) * scale with
        # q = 2*sign, zero = 1) so the lowering is bit-faithful
        q = 2 * self._sign_codes(leaf)
        s = leaf.scale.to(torch.float32)
        if s.ndim:
            s = s.reshape(s.shape + (1, 1))
        return (q.to(torch.float32) - 1.0) * s

    def runtime_packed(self, leaf: BitDeltaLeaf) -> PackedDelta:
        lead = leaf.stack_shape()
        hg = _runtime_hg(leaf.h_in)
        G = leaf.h_in // hg

        def codes_of(one: BitDeltaLeaf) -> torch.Tensor:
            q = 2 * self._sign_codes(one)         # {0, 2}: (q - 1)*s = +/-s
            return quant.pack_bits(q.reshape(G, hg, leaf.h_out), 2, axis=1)

        return _dense_as_structured(
            _per_matrix(leaf, codes_of), leaf.scale.to(torch.float32),
            _lead_scalar(lead, 1, torch.int32, leaf.sign.device),
            leaf.h_in, leaf.h_out, hg, k_bits=2, codec=self.name)

    def storage_bits(self, leaf: BitDeltaLeaf) -> dict:
        stack = math.prod(leaf.stack_shape())
        vb = 1.0 * leaf.h_in * leaf.h_out * stack
        return {"value_bits": vb, "total_bits": vb + 32.0 * stack}

    def to_storage_parts(self, leaf: BitDeltaLeaf):
        _check_unstacked(leaf)
        parts = {"sign": leaf.sign.cpu().numpy()}
        meta = {"codec": self.name, "h_in": leaf.h_in, "h_out": leaf.h_out,
                "scale": float(leaf.scale)}
        return parts, meta

    def from_storage_parts(self, parts, meta: dict, *, device=None) -> BitDeltaLeaf:
        dev = resolve_device(device)
        return BitDeltaLeaf(
            sign=torch.from_numpy(np.asarray(parts["sign"], np.uint8)).to(dev),
            scale=pack_lib.scalar_tensor(meta["scale"], torch.float32, dev),
            h_in=meta["h_in"], h_out=meta["h_out"])

    def leaf_spec(self, leaf, spec: BitDeltaSpec) -> BitDeltaLeaf:
        shape = _shape_of(leaf)
        lead, (h_in, h_out) = shape[:-2], shape[-2:]
        return BitDeltaLeaf(sign=((*lead, quant.packed_len(h_in, 1), h_out), torch.uint8),
                            scale=(lead, torch.float32), h_in=h_in, h_out=h_out)

    def leaf_axes(self, leaf, axes: tuple, spec: BitDeltaSpec,
                  model_axis_size: int) -> BitDeltaLeaf:
        """sign ``[lead..., packed h_in, O]``: O takes the output axis; the
        packed input axis replicates (``repro/core/codecs.py:432``)."""
        d = self.leaf_spec(leaf, spec)
        lead_ax = tuple(axes[:-2])
        return BitDeltaLeaf(sign=(*lead_ax, None, axes[-1]), scale=lead_ax,
                            h_in=d.h_in, h_out=d.h_out)


# ---------------------------------------------------------------------------
# Low-rank residual: quantized dense core + rank-r f32 factors
# ---------------------------------------------------------------------------
class LowRankCodec(DeltaCodec):
    name = "lowrank"
    spec_cls = LowRankSpec
    leaf_cls = LowRankLeaf

    def compress_leaf(self, base_leaf, ft_leaf, spec: LowRankSpec, *,
                      generator=None) -> LowRankLeaf:
        delta = ft_leaf.to(torch.float32) - base_leaf.to(torch.float32)
        h_in, h_out = delta.shape[-2:]
        q, qp = quant.quantize(delta, spec.k_bits)
        core = (q.to(torch.float32) - qp.zero.to(torch.float32)) * qp.scale
        # residual factors via numpy's SVD on the host, as the reference
        # computes them: compression is offline, and the same numpy call
        # on the same f32 residual gives the same factors
        resid = (delta - core).cpu().numpy()
        U, S, Vt = np.linalg.svd(resid, full_matrices=False)
        r = spec.rank
        k = min(r, S.shape[0])
        us = np.zeros((h_in, r), np.float32)
        vs = np.zeros((r, h_out), np.float32)
        us[:, :k] = U[:, :k] * S[:k]               # u absorbs singular values
        vs[:k, :] = Vt[:k]
        codes = quant.pack_bits(q, quant.pack_width(spec.k_bits), axis=0)
        dev = delta.device
        return LowRankLeaf(
            codes=codes, scale=qp.scale, zero=qp.zero,
            u=torch.from_numpy(us).to(dev), v=torch.from_numpy(vs).to(dev),
            h_in=h_in, h_out=h_out, k_bits=spec.k_bits, rank=r)

    def reconstruct_dense(self, leaf: LowRankLeaf) -> torch.Tensor:
        q = quant.unpack_bits(leaf.codes, quant.pack_width(leaf.k_bits), leaf.h_in,
                              axis=leaf.codes.ndim - 2)
        s = leaf.scale.to(torch.float32)
        z = leaf.zero.to(torch.float32)
        if s.ndim:
            s = s.reshape(s.shape + (1, 1))
            z = z.reshape(z.shape + (1, 1))
        core = (q.to(torch.float32) - z) * s
        return core + leaf.u @ leaf.v

    def runtime_packed(self, leaf: LowRankLeaf) -> PackedDelta:
        # dense-as-structured f32 values (k_bits=None: decode is the
        # identity), computed ONCE at lowering time by the exact
        # reconstruction the reference path uses — bit-faithful
        lead = leaf.stack_shape()
        hg = _runtime_hg(leaf.h_in)
        G = leaf.h_in // hg
        vals = _per_matrix(leaf, lambda one: self.reconstruct_dense(one).reshape(
            G, hg, leaf.h_out))
        dev = leaf.codes.device
        return _dense_as_structured(
            vals.contiguous(), _lead_scalar(lead, 1.0, torch.float32, dev),
            _lead_scalar(lead, 0, torch.int32, dev),
            leaf.h_in, leaf.h_out, hg, k_bits=None, codec=self.name)

    @staticmethod
    def _bits(h_in: int, h_out: int, k_bits: int, rank: int, stack: int) -> dict:
        vb = (k_bits * h_in * h_out + 32.0 * rank * (h_in + h_out)) * stack
        return {"value_bits": vb, "total_bits": vb + 64.0 * stack}

    def storage_bits(self, leaf: LowRankLeaf) -> dict:
        return self._bits(leaf.h_in, leaf.h_out, leaf.k_bits, leaf.rank,
                          math.prod(leaf.stack_shape()))

    def to_storage_parts(self, leaf: LowRankLeaf):
        _check_unstacked(leaf)
        parts = {k: getattr(leaf, k).cpu().numpy() for k in ("codes", "u", "v")}
        meta = {"codec": self.name, "h_in": leaf.h_in, "h_out": leaf.h_out,
                "k_bits": leaf.k_bits, "rank": leaf.rank,
                "scale": float(leaf.scale), "zero": int(leaf.zero)}
        return parts, meta

    def from_storage_parts(self, parts, meta: dict, *, device=None) -> LowRankLeaf:
        dev = resolve_device(device)
        return LowRankLeaf(
            codes=torch.from_numpy(np.asarray(parts["codes"], np.uint8)).to(dev),
            scale=pack_lib.scalar_tensor(meta["scale"], torch.float32, dev),
            zero=pack_lib.scalar_tensor(meta["zero"], torch.int32, dev),
            u=torch.from_numpy(np.asarray(parts["u"], np.float32)).to(dev),
            v=torch.from_numpy(np.asarray(parts["v"], np.float32)).to(dev),
            h_in=meta["h_in"], h_out=meta["h_out"],
            k_bits=meta["k_bits"], rank=meta["rank"])

    def leaf_spec(self, leaf, spec: LowRankSpec) -> LowRankLeaf:
        shape = _shape_of(leaf)
        lead, (h_in, h_out) = shape[:-2], shape[-2:]
        return LowRankLeaf(
            codes=((*lead, quant.packed_len(h_in, spec.k_bits), h_out), torch.uint8),
            scale=(lead, torch.float32), zero=(lead, torch.int32),
            u=((*lead, h_in, spec.rank), torch.float32),
            v=((*lead, spec.rank, h_out), torch.float32),
            h_in=h_in, h_out=h_out, k_bits=spec.k_bits, rank=spec.rank)

    def leaf_axes(self, leaf, axes: tuple, spec: LowRankSpec,
                  model_axis_size: int) -> LowRankLeaf:
        """codes and v take the output axis, u the input axis, the packed
        and rank axes replicate (``repro/core/codecs.py:548``)."""
        d = self.leaf_spec(leaf, spec)
        lead_ax = tuple(axes[:-2])
        in_ax, out_ax = axes[-2], axes[-1]
        return LowRankLeaf(codes=(*lead_ax, None, out_ax), scale=lead_ax, zero=lead_ax,
                           u=(*lead_ax, in_ax, None), v=(*lead_ax, None, out_ax),
                           h_in=d.h_in, h_out=d.h_out, k_bits=d.k_bits, rank=d.rank)

    def planned_total_bits(self, shape: tuple, spec: LowRankSpec) -> float:
        return self._bits(shape[-2], shape[-1], spec.k_bits, spec.rank,
                          math.prod(shape[:-2]))["total_bits"]


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
_CODECS: dict[str, DeltaCodec] = {}
DEFAULT_CODEC = "deltadq"


def register_codec(codec: DeltaCodec) -> DeltaCodec:
    """Register a codec instance under ``codec.name`` (idempotent for the
    same instance; raises on a name collision with a different one)."""
    prev = _CODECS.get(codec.name)
    if prev is not None and prev is not codec:
        raise ValueError(f"codec {codec.name!r} is already registered")
    _CODECS[codec.name] = codec
    return codec


def get_codec(name: str) -> DeltaCodec:
    try:
        return _CODECS[name]
    except KeyError:
        raise KeyError(f"unknown codec {name!r}; registered: "
                       f"{sorted(_CODECS)}") from None


def codec_names() -> list[str]:
    """Registered codec names in registration order."""
    return list(_CODECS)


def codec_for_spec(spec) -> DeltaCodec:
    """The codec owning a spec instance (by spec class)."""
    for c in _CODECS.values():
        if isinstance(spec, c.spec_cls):
            return c
    raise TypeError(f"no registered codec accepts spec {type(spec).__name__}")


def codec_of_leaf(leaf) -> DeltaCodec:
    """The codec owning a compressed leaf (PackedDelta carries its codec
    tag; other leaf types resolve by class)."""
    if isinstance(leaf, PackedDelta):
        return get_codec(leaf.codec)
    for c in _CODECS.values():
        if type(leaf) is c.leaf_cls:
            return c
    raise TypeError(f"no registered codec owns leaf {type(leaf).__name__}")


def is_codec_leaf(x) -> bool:
    return isinstance(x, tuple(c.leaf_cls for c in _CODECS.values()))


def reconstruct_dense_any(leaf) -> torch.Tensor:
    """Dense f32 delta for any registered codec's leaf (incl. runtime
    PackedDelta forms)."""
    if isinstance(leaf, PackedDelta):
        return pack_lib.reconstruct_dense(leaf)
    return codec_of_leaf(leaf).reconstruct_dense(leaf)


def runtime_packed_leaf(leaf: Any) -> Any:
    """Lower one codec leaf to the PackedDelta runtime layout (identity on
    PackedDelta and on None)."""
    if leaf is None or isinstance(leaf, PackedDelta):
        return leaf
    return codec_of_leaf(leaf).runtime_packed(leaf)


def runtime_delta_tree(tree: Any) -> Any:
    """Lower every codec leaf of a deltas tree to its runtime PackedDelta
    form (idempotent). The serving engines call this at tenant
    registration, so model and kernel code only ever see PackedDelta."""
    return tree_map(runtime_packed_leaf, tree)


register_codec(DeltaDQCodec())
register_codec(BitDeltaCodec())
register_codec(LowRankCodec())
