"""Check of the drift kernels' in-kernel random generator — the port of
`scripts/check_kernel_rng.py`.

    python -m wheeledlab_torch.scripts.check_kernel_rng [--device cuda]

Draws the (12, B) uniform and (14, B) normal blocks of B = 4096 envs exactly
as the in-kernel-RNG drift step draws them (`ops/kernel_rng.py::rng_blocks`:
the kernel `csrc/rng_blocks.cu` on CUDA, the plain version `philox_blocks`
with `--device cpu`) and asserts their moments and basic whiteness with the
reference's bounds. Exits non-zero on a violation. Run it after any change to
the generator or the extraction.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

NUM_ENVS = 4096


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)

    import torch

    from ..ops.kernel_rng import rng_blocks
    from ..utils.device import resolve_device

    device = resolve_device(args.device)

    def run(seed: int):
        u, n = rng_blocks(torch.tensor([seed], dtype=torch.int32,
                                       device=device), NUM_ENVS)
        return u.cpu().numpy(), n.cpu().numpy()

    u, n = run(1234)
    checks = []

    def check(name, val, lo, hi):
        ok = lo <= val <= hi
        checks.append(ok)
        print(f"{'ok ' if ok else 'FAIL'} {name}: {val:.4f} "
              f"(bounds [{lo}, {hi}])")

    def flag(name, ok):
        checks.append(ok)
        print(("ok " if ok else "FAIL") + " " + name)

    check("uniform mean", float(u.mean()), 0.49, 0.51)
    check("uniform std", float(u.std()), 0.283, 0.295)
    check("uniform min", float(u.min()), 0.0, 0.01)
    check("uniform max", float(u.max()), 0.99, 1.0)
    check("normal mean", float(n.mean()), -0.03, 0.03)
    check("normal std", float(n.std()), 0.98, 1.02)
    kurt = float(((n - n.mean()) ** 4).mean() / n.std() ** 4)
    check("normal kurtosis", kurt, 2.8, 3.2)
    lag1 = float(np.corrcoef(u.ravel()[:-1], u.ravel()[1:])[0, 1])
    check("uniform lag-1 corr", abs(lag1), 0.0, 0.03)
    # a stream per env (the reference: per grid block) and per seed
    flag("envs draw distinct streams",
         not np.array_equal(u[:, :1024], u[:, 1024:2048])
         and len(np.unique(u[0])) > NUM_ENVS // 2)
    u2, _ = run(99)
    flag("seeds draw distinct streams", not np.array_equal(u, u2))
    if not all(checks):
        print("KERNEL RNG CHECK FAILED")
        return 1
    print(f"kernel RNG check passed on {device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
