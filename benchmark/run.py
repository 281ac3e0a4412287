"""Run one cell of the benchmark once, on the CUDA card this process sees.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the card, its power limit, whether float32 products may use TF32
and the world size, then, as the last line of standard output, one JSON
object: `correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with `--trace 1` its per-layer metrics), `device` and, when
traced, `breakdown`, then `checks`, each number the check compared beside
its limit (also the last lines of standard error). Exits non-zero, and
prints no result, without a CUDA card, with fewer cards than the cell asks
for, or when JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, "_cache")
# every build and kernel cache at a fixed path inside the checkout; the
# port's own kernels build into wheeledlab_torch/_build/
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "cuda")
os.environ["USE_FLAX"] = "0"
# one process, one host thread for PyTorch's and OpenMP's pools: the window
# is paced partly by the host, which other threads would share
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["MKL_NUM_THREADS"] = "1"
sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "wheeledlab_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30)
        return smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    import wheeledlab_torch  # noqa: F401  the system under test, or fail here
    from benchmark import harness, spec

    torch.set_num_threads(1)

    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark runs only on one", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, this process sees "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {power_limit()}")
    print(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}; world size: 1; "
          f"cell: {cell.name}; seed: {args.seed}", flush=True)
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda", T0)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    result["device"] = {"platform": "gpu",
                        "kind": torch.cuda.get_device_name(0),
                        **result["device"]}
    result = {**{k: v for k, v in result.items() if k != "checks"},
              "checks": result["checks"]}
    for k, v in result["checks"].items():
        print(f"{k} {v['value']:.6g} limit {v['limit']:.6g}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
