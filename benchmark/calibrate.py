"""The readings that a cell's limits of `correct` are set from, at the
cell's own size, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds a,b,... \
        [--control-seeds c,d,e] [--fault-seeds f,g,h] [--faults half_batch,reward]

For each seed of `--seeds`: the program's first iterations (as a run's
set-up drives them) against the reference's, the numbers `compare` gives.
For each seed of `--control-seeds`: the control, the reference computed
with TF32 products in the program's place, against the float32 reference.
For each seed of `--fault-seeds` and each fault: the reference with the
fault planted (`reference/ppo.py::Learner`) in the program's place. One
JSON line each. The benchmark's own runs do not run this.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, default=[])
    p.add_argument("--control-seeds", type=seeds, default=[])
    p.add_argument("--fault-seeds", type=seeds, default=[])
    p.add_argument("--faults", default="half_batch,reward")
    args = p.parse_args(argv)

    import torch

    from benchmark import harness, spec

    cell = spec.load_cell(args.workload)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def emit(kind, seed, numbers, t):
        print(json.dumps({"cell": cell.name, "kind": kind, "seed": seed,
                          **numbers, "seconds": time.perf_counter() - t}),
              flush=True)

    refs = {}

    def reference(seed):
        if seed not in refs:
            refs[seed] = harness.reference_readings(cell, seed, "cuda")
        return refs[seed]

    for seed in args.seeds:
        t = time.perf_counter()
        learner, state, prog = harness.start_program(cell, seed, "cuda")
        del learner, state
        harness.free_device_memory()
        emit("program", seed, harness.compare(prog, reference(seed)), t)
    for seed in args.control_seeds:
        t = time.perf_counter()
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            ctl = harness.reference_readings(cell, seed, "cuda")
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        emit("control_tf32", seed, harness.compare(ctl, reference(seed)), t)
    for seed in args.fault_seeds:
        for fault in args.faults.split(","):
            t = time.perf_counter()
            bad = harness.reference_readings(cell, seed, "cuda", fault)
            emit(f"fault_{fault}", seed, harness.compare(bad, reference(seed)),
                 t)
        refs.pop(seed, None)
        harness.free_device_memory()


if __name__ == "__main__":
    main()
