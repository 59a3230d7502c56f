"""Carry weights and codec leaves across from numpy.

The JAX package's parameters, codec leaves (``PackedDelta``,
``BitDeltaLeaf``, ``LowRankLeaf``) and serving caches reach the port as
numpy arrays (the conversion *from* JAX arrays lives with the tests: the
port never imports jax). bf16 arrives as its raw uint16 bits, the way
``repro/checkpoint/ckpt.py:48-52`` stores it, with the dtype named in a
``bit_dtypes`` map keyed by leaf path.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch.core.codecs import BitDeltaLeaf, LowRankLeaf
from repro_torch.core.pack import PackedDelta
from repro_torch.utils import map_with_paths, resolve_device

_BIT_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def tensor_from_numpy(arr: np.ndarray, bit_dtype: Optional[str] = None,
                      device=None) -> torch.Tensor:
    """One array -> tensor; ``bit_dtype`` names the dtype whose raw bits
    ``arr`` (uint16) holds."""
    dev = resolve_device(device)
    arr = np.array(arr, order="C")     # a writable copy; keeps 0-d arrays 0-d
    if bit_dtype is None:
        return torch.from_numpy(arr).to(dev)
    if bit_dtype not in _BIT_DTYPES or arr.dtype.itemsize != 2:
        raise ValueError(f"cannot reinterpret {arr.dtype} bits as {bit_dtype}")
    bits = torch.from_numpy(arr.view(np.int16))
    return bits.view(_BIT_DTYPES[bit_dtype]).to(dev)


def params_from_numpy(tree: Any, bit_dtypes: Optional[Mapping[str, str]] = None,
                      device=None) -> Any:
    """A nested dict of numpy arrays -> the same dict of tensors."""
    bit_dtypes = bit_dtypes or {}
    return map_with_paths(
        lambda path, a: tensor_from_numpy(a, bit_dtypes.get(path), device), tree)


def packed_delta_from_numpy(arrays: Mapping[str, np.ndarray], meta: Mapping[str, Any],
                            device=None) -> PackedDelta:
    """One PackedDelta from its arrays (idx, codes, scale, zero) and static
    meta (h_in, h_out, h_g, keep, alpha, k_bits, m, codec)."""
    dev = resolve_device(device)
    return PackedDelta(
        idx=tensor_from_numpy(arrays["idx"], device=dev),
        codes=tensor_from_numpy(arrays["codes"], device=dev),
        scale=tensor_from_numpy(np.asarray(arrays["scale"], np.float32), device=dev),
        zero=tensor_from_numpy(np.asarray(arrays["zero"], np.int32), device=dev),
        h_in=int(meta["h_in"]), h_out=int(meta["h_out"]), h_g=int(meta["h_g"]),
        keep=int(meta["keep"]), alpha=float(meta["alpha"]),
        k_bits=None if meta["k_bits"] is None else int(meta["k_bits"]),
        m=int(meta["m"]), codec=str(meta.get("codec", "deltadq")))


def bitdelta_leaf_from_numpy(arrays: Mapping[str, np.ndarray], meta: Mapping[str, Any],
                             device=None) -> BitDeltaLeaf:
    """One BitDeltaLeaf from its arrays (sign, scale) and meta (h_in, h_out)."""
    dev = resolve_device(device)
    return BitDeltaLeaf(
        sign=tensor_from_numpy(arrays["sign"], device=dev),
        scale=tensor_from_numpy(np.asarray(arrays["scale"], np.float32), device=dev),
        h_in=int(meta["h_in"]), h_out=int(meta["h_out"]))


def lowrank_leaf_from_numpy(arrays: Mapping[str, np.ndarray], meta: Mapping[str, Any],
                            device=None) -> LowRankLeaf:
    """One LowRankLeaf from its arrays (codes, scale, zero, u, v) and meta
    (h_in, h_out, k_bits, rank)."""
    dev = resolve_device(device)
    return LowRankLeaf(
        codes=tensor_from_numpy(arrays["codes"], device=dev),
        scale=tensor_from_numpy(np.asarray(arrays["scale"], np.float32), device=dev),
        zero=tensor_from_numpy(np.asarray(arrays["zero"], np.int32), device=dev),
        u=tensor_from_numpy(np.asarray(arrays["u"], np.float32), device=dev),
        v=tensor_from_numpy(np.asarray(arrays["v"], np.float32), device=dev),
        h_in=int(meta["h_in"]), h_out=int(meta["h_out"]),
        k_bits=int(meta["k_bits"]), rank=int(meta["rank"]))


def cache_from_numpy(cfg, entries: list, bit_dtypes: Optional[Mapping[str, str]] = None,
                     device=None) -> list:
    """A serving cache (``models.lm.init_cache``'s layout) from numpy:
    ``entries`` holds one ``{field: array}`` per cache entry, in order —
    the decoder layers' (k/v/pos for attention, the SsmState / RecState
    fields for ssm / rec layers), then the cross caches' k/v. ``bit_dtypes``
    is keyed ``"<entry index>/<field>"``."""
    from repro_torch.models.lm import layer_plan
    from repro_torch.models.rglru import RecState
    from repro_torch.models.ssm import SsmState
    bit_dtypes = bit_dtypes or {}
    kinds = [kind for kind, _, _ in layer_plan(cfg)]
    out = []
    for i, fields in enumerate(entries):
        t = {k: tensor_from_numpy(a, bit_dtypes.get(f"{i}/{k}"), device)
             for k, a in fields.items()}
        kind = kinds[i] if i < len(kinds) else "cross"
        out.append(SsmState(**t) if kind == "ssm" else RecState(**t) if kind == "rec"
                   else t)
    return out
