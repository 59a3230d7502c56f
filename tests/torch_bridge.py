"""Test-side bridge from the JAX package to the PyTorch port.

Turns JAX pytrees (params, deltas trees of any codec's leaves) into the port's
tensors through numpy, with bf16 passed as raw uint16 bits the way
``repro/checkpoint/ckpt.py`` stores it. Only tests import both packages;
the port itself never imports jax.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.core import DeltaDQSpec as JaxDeltaDQSpec
from repro.core import compress as jax_compress
from repro.core.codecs import BitDeltaLeaf as JaxBitDeltaLeaf
from repro.core.codecs import LowRankLeaf as JaxLowRankLeaf
from repro.core.pack import PackedDelta as JaxPackedDelta
from repro.utils import flatten_with_paths

from repro_torch import convert
from repro_torch.core import codecs as tcodecs
from repro_torch.core.compress import compress_leaf_layerwise
from repro_torch.utils import map_with_paths

CPU = "cpu"


def to_numpy(a) -> tuple[np.ndarray, str | None]:
    """(array, bit_dtype): bf16 comes back as its uint16 bits."""
    arr = np.asarray(jax.device_get(a))
    if arr.dtype.name == "bfloat16":
        return arr.view(np.uint16), "bfloat16"
    return arr, None


def array_to_port(a, device=CPU):
    """One JAX array -> tensor (bf16 through its bits)."""
    arr, bd = to_numpy(a)
    return convert.tensor_from_numpy(arr, bd, device=device)


def params_to_port(params, device=CPU):
    """JAX params pytree (nested dicts) -> the port's dict of tensors."""
    flat = flatten_with_paths(params)
    bits = {}
    host = {}
    for path, leaf in flat.items():
        host[path], bd = to_numpy(leaf)
        if bd is not None:
            bits[path] = bd

    def nest(tree, prefix=""):
        return {k: nest(v, f"{prefix}/{k}" if prefix else k)
                if isinstance(v, dict) else host[f"{prefix}/{k}" if prefix else k]
                for k, v in tree.items()}

    return convert.params_from_numpy(nest(params), bits, device=device)


def cache_to_port(cfg, cache, device=CPU):
    """A JAX serving cache (list of dicts and SsmState/RecState tuples) ->
    the port's (``convert.cache_from_numpy``)."""
    entries, bits = [], {}
    for i, e in enumerate(cache):
        fields = e._asdict() if isinstance(e, tuple) else e
        host = {}
        for k, a in fields.items():
            host[k], bd = to_numpy(a)
            if bd is not None:
                bits[f"{i}/{k}"] = bd
        entries.append(host)
    return convert.cache_from_numpy(cfg, entries, bits, device=device)


def packed_to_port(d: JaxPackedDelta, device=CPU):
    arrays = {k: to_numpy(getattr(d, k))[0]
              for k in ("idx", "codes", "scale", "zero")}
    meta = {k: getattr(d, k) for k in
            ("h_in", "h_out", "h_g", "keep", "alpha", "k_bits", "m", "codec")}
    return convert.packed_delta_from_numpy(arrays, meta, device=device)


def packed_to_jax(d) -> JaxPackedDelta:
    """The port's PackedDelta -> the reference's (arrays copied through
    numpy: a JAX array may alias the numpy buffer, which a tensor later
    moved to shared memory would leave behind)."""
    arrays = {k: jnp.array(getattr(d, k).detach().cpu().numpy(), copy=True)
              for k in ("idx", "codes", "scale", "zero")}
    meta = {k: getattr(d, k) for k in
            ("h_in", "h_out", "h_g", "keep", "alpha", "k_bits", "m", "codec")}
    return JaxPackedDelta(**arrays, **meta)


def deltas_to_jax(tree):
    """The port's deltas tree (PackedDelta leaves / None) -> the reference's."""
    return map_with_paths(lambda _p, d: None if d is None else packed_to_jax(d), tree)


def _fields_to_port(d, arrays, meta):
    return ({k: to_numpy(getattr(d, k))[0] for k in arrays},
            {k: getattr(d, k) for k in meta})


def leaf_to_port(d, device=CPU):
    """Any JAX codec leaf (PackedDelta, BitDeltaLeaf, LowRankLeaf) or None."""
    if d is None:
        return None
    if isinstance(d, JaxPackedDelta):
        return packed_to_port(d, device)
    if isinstance(d, JaxBitDeltaLeaf):
        return convert.bitdelta_leaf_from_numpy(
            *_fields_to_port(d, ("sign", "scale"), ("h_in", "h_out")), device=device)
    if isinstance(d, JaxLowRankLeaf):
        return convert.lowrank_leaf_from_numpy(
            *_fields_to_port(d, ("codes", "scale", "zero", "u", "v"),
                             ("h_in", "h_out", "k_bits", "rank")), device=device)
    raise TypeError(f"no port counterpart for {type(d).__name__}")


def deltas_to_port(deltas, device=CPU):
    """JAX deltas tree (dicts with codec leaves / None) -> port tree."""
    return map_with_paths(lambda _p, d: leaf_to_port(d, device), deltas)


def xla_to_torch(rep: dict) -> dict:
    """A reference ``Metrics.report()`` under the port's path names: the
    reference labels its plain formulations ``*-xla``, the port
    ``*-torch`` (the same path under each framework's name)."""
    rep = dict(rep)
    if rep["decode_paths"]:
        rep["decode_paths"] = {k.replace("-xla", "-torch"): v
                               for k, v in rep["decode_paths"].items()}
    return rep


def check_codes(base, path, spec=JaxDeltaDQSpec(alpha=8.0, k_bits=4, m=8, h_g=16)):
    """The port's ``compress_leaf_layerwise`` at ``path`` of the reference's
    params ``base`` (a perturbed copy from key 1), given the reference's
    uniform draws, must pack the same bytes as the reference's ``compress``
    of that leaf (alone in a tree under the same path, so its key is the
    same)."""
    b = base
    for k in path.split("/"):
        b = b[k]
    f = b + 0.02 * jax.random.normal(jax.random.PRNGKey(1), b.shape,
                                     jnp.float32).astype(b.dtype)

    def nest(leaf):
        for k in reversed(path.split("/")):
            leaf = {k: leaf}
        return leaf

    want, _ = jax_compress(nest(b), nest(f), spec)
    for k in path.split("/"):
        want = want[k]
    leaf_key = jax.random.fold_in(jax.random.PRNGKey(spec.seed),
                                  zlib.crc32(path.encode()) & 0x7FFFFFFF)
    h_in, h_out = b.shape[-2:]
    u = np.array(jax.random.uniform(leaf_key, (b.shape[0], h_in // spec.h_g, spec.h_g,
                                               h_out)))
    tb_, tf_ = params_to_port({"b": b, "f": f}).values()
    got = compress_leaf_layerwise(
        tcodecs.DeltaDQCodec(), tcodecs.DeltaDQSpec(**dataclasses.asdict(spec)),
        tb_, lambda i: tf_[i], u_slice=lambda i: torch.from_numpy(u[i]))
    for fld in ("idx", "codes", "scale", "zero"):
        np.testing.assert_array_equal(getattr(got, fld).numpy(),
                                      np.asarray(getattr(want, fld)), err_msg=f"{path} {fld}")
