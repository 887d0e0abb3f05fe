"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the run's log and, as its last lines, each number the check
compared beside its limit on standard error, and the result as one JSON
line on standard output. Exits non-zero, with no result, where no CUDA
device is present or fewer than the cell asks for, where the program
(``src/repro_torch``) is missing, and where JAX or the JAX package was
loaded. Kernels build into ``build/repro_torch_kernels/`` of this
checkout (the program's fixed directory), Triton's cache, where any,
into ``build/triton_cache/``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .cells import ROOT, resolve
from .harness import forbidden_loaded, log, process_age_s


def _args(argv):
    p = argparse.ArgumentParser(prog="python3 -m portbench.run", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = _args(argv)
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
    os.environ.setdefault("USE_FLAX", "0")
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        log(f"the program is missing: no {src / 'repro_torch'}")
        return 2
    sys.path.insert(0, str(src))
    cell = resolve(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"{cell.name} needs {cell.chips} CUDA device(s); {n} available")
        return 2
    from . import harness

    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    bad = forbidden_loaded()
    if bad:
        log(f"forbidden modules loaded in this process: {', '.join(bad)}")
        return 3
    log(f"run ended {process_age_s():.3f} s after the process started")
    print(f"correct {str(result['correct']).lower()}", file=sys.stderr)
    for name, n in result["check"].items():
        print(f"check {name} {n['value']!r} limit {n['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
