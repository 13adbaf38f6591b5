"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Exits with 2, printing no result, when no
CUDA card is present or fewer than the cell asks for, and with 3 when JAX
or the JAX package is loaded once the window has closed.  The last lines
of standard error name each number compared with its limit; the last line
of standard output is the result object.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _environment() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port's own kernel build directory is `build/kernels/` already), and
    one CPU thread for the math libraries: the host path is single-threaded
    numpy and driver code, and idle worker threads only contend with it on
    a shared host."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ.pop("DSM_CACHE_DIR", None)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment()
    import torch

    from benchmark import harness
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           t_start=T0)
    log, res = out["log"], out["result"]
    print(json.dumps(log), file=sys.stderr)
    if log["jax_modules"]:
        print(f"loaded once the window closed: {log['jax_modules']}",
              file=sys.stderr)
        return 3
    for name, v in res["compared"].items():
        print(f"{name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
