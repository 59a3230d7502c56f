"""``chip_smoke.py``'s ``[mesh]`` phase alone, on the card: build the
kernels, the full wizard-llama2-7b base and 3 tenants at 128x (as the
main path does), serve the ``[engine]`` stream once on one card for the
reference tokens, then run ``phase_mesh``. Writes the phase's report to
``build/mesh_phase.json`` and prints the launches it counted; exits 1 on
a failed check (``chip_smoke.fail``). Usage: ``python3 chip_mesh_phase.py``
from a checkout, on a machine with one NVIDIA card."""
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(HERE, "src")]
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import delta_spmm as kern
    from repro_torch.launch.serve import RATIO_SPECS, synth_tenants
    from repro_torch.models import lm
    from repro_torch.serve import ContinuousEngine, Engine, VirtualClock

    if not torch.cuda.is_available():
        print("chip_mesh_phase: this needs a GPU", file=sys.stderr)
        return 1
    t0 = time.time()
    report = {}
    with torch.inference_mode():
        print(cs.phase_device(torch), flush=True)
        cs.phase_build(kern)
        cfg = get_config(cs.ARCH)
        base = lm.init_params(cfg, 0, device="cuda")
        fleet = synth_tenants(cfg, base, 3, RATIO_SPECS[128], seed=0)
        eng = Engine(cfg, base, max_seq=96)
        for name, deltas, rep in fleet:
            eng.register_tenant(name, deltas, rep)
        del fleet
        stream = cs._engine_stream(cfg)
        ce = ContinuousEngine(cfg, base, n_slots=cs.ENGINE_SLOTS, max_seq=cs.ENGINE_MAX_SEQ,
                              store=eng.store, clock=VirtualClock(tick=cs.ENGINE_TICK))
        run = cs._engine_run(torch, kern, ce, stream, list(range(len(stream))), "single card")
        report["engine"] = {"tokens": {str(i): t.tolist() for i, t in run["tokens"].items()}}
        del ce
        print(f"setup {time.time() - t0:.1f} s, allocated "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)
        t1 = time.time()
        launches = cs.phase_mesh(torch, kern, {"cfg": cfg, "base": base, "eng": eng}, report)
        print(f"[phase] mesh {time.time() - t1:.1f} s", flush=True)
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with open(os.path.join(HERE, "build", "mesh_phase.json"), "w") as f:
        json.dump(report["mesh"], f, indent=1, default=str)
    print(json.dumps(launches), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
