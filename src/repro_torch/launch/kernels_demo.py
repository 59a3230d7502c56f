"""Kernel demo: the port's four delta kernels against their oracles, and
the bytes arithmetic that makes the packed layout pay for memory-bound
decode (the port's twin of ``examples/kernels_demo.py``).

    PYTHONPATH=src python -m repro_torch.launch.kernels_demo               # on the card
    PYTHONPATH=src python -m repro_torch.launch.kernels_demo --device cpu  # plain versions
    PYTHONPATH=src python -m repro_torch.launch.kernels_demo --full        # the wi site

On the card each call launches its CUDA kernel (``kernels/csrc/``); on
the CPU it takes the kernel's plain torch version. The oracles are
``kernels/ref.py`` (dense reconstruction, then one matmul).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core.apply import stack_tenant_deltas
from repro_torch.core.dropout import groupwise_dropout_pack
from repro_torch.kernels import ops, ref
from repro_torch.serve.scheduler import tenant_segments

# NVIDIA H100 SXM data sheet: HBM3 bandwidth
H100_HBM_BYTES_PER_S = 3.35e12

# (T, h_in, h_out, h_g): the reference demo's shape, and the full-width
# wizard-llama2-7b MLP up projection at the 128x spec's group size
DEMO = (128, 2048, 512, 128)
FULL = (128, 4096, 11008, 16)
ALPHA, K_BITS = 8.0, 4
TOL = dict(atol=1e-4, rtol=1e-4)   # f32, sums in different orders
N_TENANTS = 4


def run(device, *, T: int, h_in: int, h_out: int, h_g: int,
        w_dtype=torch.float32, seed: int = 0, verbose: bool = True) -> dict:
    """Each kernel against its oracle on one packed delta (four for the
    segments kernel); returns {kernel: {"max_abs_err", "ok"}}."""
    say = print if verbose else (lambda *a: None)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def pack():
        delta = torch.randn((h_in, h_out), generator=gen, device=device) * 0.01
        return groupwise_dropout_pack(delta, h_g=h_g, alpha=ALPHA, k_bits=K_BITS, m=8,
                                      generator=gen)

    packed = pack()
    x = torch.randn((T, h_in), generator=gen, device=device)
    w = (torch.randn((h_in, h_out), generator=gen, device=device) * 0.05).to(w_dtype)
    stack = stack_tenant_deltas([{"w": packed}] + [{"w": pack()}
                                                   for _ in range(N_TENANTS - 1)])["w"]
    rows = torch.randint(0, N_TENANTS, (T,), generator=gen, device=device)
    seg = tenant_segments(rows.cpu().numpy()).to(device)
    xs = x.index_select(0, seg.order)

    def segments_oracle():
        y = torch.zeros((T, h_out), device=device)
        offs = seg.seg_offsets.tolist()
        for s, t in enumerate(seg.seg_rows.tolist()):
            if offs[s + 1] > offs[s]:
                y[offs[s]:offs[s + 1]] = ref.delta_spmm_ref(xs[offs[s]:offs[s + 1]],
                                                            stack.index(t))
        return y

    out = {}
    for name, got, want in [
        ("delta_spmm", lambda: ops.delta_spmm(x, packed),
         lambda: ref.delta_spmm_ref(x, packed)),
        ("delta_spmm_segments", lambda: ops.delta_spmm_segments(
            xs, stack, seg.seg_rows, seg.seg_offsets), segments_oracle),
        ("fused_base_delta", lambda: ops.fused_base_delta(x, w, packed),
         lambda: ref.fused_base_delta_ref(x, w, packed)),
        ("dequant", lambda: ops.dequant(packed), lambda: ref.dequant_tile_ref(packed)),
    ]:
        g, r = got(), want()
        err = (g - r).abs().max().item()
        ok = bool(torch.equal(g, r)) if name == "dequant" else \
            bool(torch.allclose(g, r, **TOL))
        out[name] = {"max_abs_err": err, "ok": ok}
        say(f"{name:20s} max|err| vs oracle = {err:.2e}"
            f"{'' if ok else '  (OUTSIDE TOLERANCE)'}")

    dense_bytes = h_in * h_out * 2                      # bf16 delta
    packed_bytes = packed.idx.numel() + packed.codes.numel()
    say(f"\ndevice bytes per matrix: dense bf16 delta {dense_bytes / 1e3:.0f} KB -> "
        f"packed {packed_bytes / 1e3:.0f} KB ({dense_bytes / packed_bytes:.1f}x less "
        f"traffic)")
    say(f"at the H100 SXM's HBM rate (data sheet, {H100_HBM_BYTES_PER_S / 1e12:.2f} "
        f"TB/s) that is {dense_bytes / H100_HBM_BYTES_PER_S * 1e6:.2f} us -> "
        f"{packed_bytes / H100_HBM_BYTES_PER_S * 1e6:.2f} us per matrix per step")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--full", action="store_true",
                    help="the wizard-llama2-7b wi site (4096 x 11008, bf16 W)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    T, h_in, h_out, h_g = FULL if args.full else DEMO
    out = run(args.device, T=T, h_in=h_in, h_out=h_out, h_g=h_g, seed=args.seed,
              w_dtype=torch.bfloat16 if args.full else torch.float32)
    return 0 if all(v["ok"] for v in out.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
