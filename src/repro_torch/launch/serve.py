"""Tenant synthesis for the serving launcher (port of the first part of
``repro/launch/serve.py``).

:data:`RATIO_SPECS` maps a target compression ratio to its DeltaDQ spec,
and :func:`synth_tenants` makes fine-tuned variants of a base model and
compresses their deltas. The CLI and its continuous-batching stream
come with the continuous engine.
"""
from __future__ import annotations

import torch

from repro_torch.core.codecs import DeltaDQSpec, codec_for_spec
from repro_torch.core.compress import (
    CompressionReport,
    compress_leaf_layerwise,
    is_compressible,
    leaf_generator,
)
from repro_torch.utils import map_with_paths

RATIO_SPECS = {
    8: DeltaDQSpec(alpha=8.0, k_bits=None, h_g=16),
    16: DeltaDQSpec(alpha=8.0, k_bits=8, m=1, h_g=16),
    32: DeltaDQSpec(alpha=8.0, k_bits=4, m=1, h_g=16),
    64: DeltaDQSpec(alpha=8.0, k_bits=4, m=4, h_g=16),
    128: DeltaDQSpec(alpha=8.0, k_bits=4, m=8, h_g=16),
}


def synth_tenants(cfg, base: dict, n: int, spec: DeltaDQSpec, seed: int = 0,
                  *, noise: float = 0.02) -> list:
    """Synthesize n fine-tuned variants and compress their deltas.

    Tenant t's weight matrix is ``w + noise * N(0, 1)`` (the noise cast to
    the weight's dtype first, as the reference does), drawn from a
    generator seeded with ``seed + 7 + t``. The fine-tuned weights are
    made one matrix at a time on the base's device and compressed at
    once, so no second full-size model is ever held. Leaves that stay
    dense (embeddings, norms) are not perturbed: their deltas would be
    dropped anyway. Returns ``[(name, deltas, report)]``.
    """
    codec = codec_for_spec(spec)
    out = []
    for t in range(n):
        report = CompressionReport(spec=spec)

        def fn(path: str, b: torch.Tensor, gen=None):
            if not is_compressible(path, b):
                report.skip(path)
                return None
            flat = b.reshape(-1, *b.shape[-2:])

            def ft_slice(i: int) -> torch.Tensor:
                z = torch.randn(flat.shape[1:], generator=gen, device=b.device,
                                dtype=torch.float32)
                return flat[i] + (noise * z).to(b.dtype)

            d = compress_leaf_layerwise(
                codec, spec, b, ft_slice,
                generator=leaf_generator(spec.seed, path, b.device))
            report.add_leaf(path, codec, d)
            return d

        noise_gen = torch.Generator(device=base["embed"]["tok"].device)
        noise_gen.manual_seed(seed + 7 + t)
        deltas = map_with_paths(lambda p, b: fn(p, b, noise_gen), base)
        out.append((f"tenant{t}", deltas, report))
    return out
