"""JAX's side of a lockstep case, recorded in a process of its own.

    python _torch_lockstep_recorder.py <case> <out.pkl> '<json kwargs>'

Runs `_torch_lockstep.record_jax(case, **kwargs)` on the CPU and pickles
the `JaxRecord` to `out.pkl`. `_torch_lockstep.record_in_subprocess`
starts it with `--xla_allow_excess_precision=false` in `XLA_FLAGS`, which
XLA reads when JAX's backend starts: so the flag holds for this recording
and for no other JAX program of the process that started it.
"""

import json
import os
import pickle
import sys


def main():
    case, path, kwargs = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import _torch_lockstep as L

    record = L.record_jax(case, **kwargs)
    with open(path + ".part", "wb") as f:
        pickle.dump(record, f)
    os.replace(path + ".part", path)


if __name__ == "__main__":
    main()
