"""The check's control on the card: the reference computed in bfloat16 put
in the program's place, at a cell's own size, over several seeds in one
process.  It has to come out not correct; its readings set the upper end
of each limit (PERF.md).  The benchmark's own runs never run it.

    python3 -m benchmark.control --workload <name> --seeds 1,2,3 \
        --seconds <s>
"""

import argparse
import json
import sys

from benchmark import harness


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = harness.run_cell(cell, seed, args.seconds, False,
                               lowp_control=True)
        res = out["result"]
        print(json.dumps(dict(workload=cell.name, seed=seed,
                              correct=res["correct"],
                              compared=res["compared"],
                              samples=out["log"]["samples"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
