"""The readings that the limits of `correct` are set from (PERF.md §2): for
each seed, one run of the cell as the benchmark runs it (a short window),
with the numbers compared for the program and for the control, the
reference with bfloat16 planes put in the program's place, both against
the float32 reference from the same inputs.

    python3 framebench/tools/readings.py <cell> --seeds 1,2,3 [--seconds 2]
        [--control 3]

from the root of a checkout, on the card.  One process: the port's
library and the imports are paid once.  --control n reads the control on
the first n seeds only.  Prints one JSON line a seed, then the largest
program reading and the smallest control reading of each number.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cell")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args(argv)

    from fbench import harness, manifest

    cell = manifest.cell(manifest.load(os.getcwd()), args.cell)
    prog, ctrl = {}, {}
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = harness.run_cell(cell, seed, args.seconds, False, os.getcwd(),
                             t0, control_run=i < args.control)
        numbers = r["program"]
        for k, v in numbers.items():
            prog[k] = max(prog.get(k, v), v)
        for k, v in (r.get("control") or {}).items():
            ctrl[k] = min(ctrl.get(k, v), v)
        print(json.dumps(dict(seed=seed, correct=r["correct"],
                              frames=r["attempted"],
                              metrics={k: m["value"] for k, m in
                                       r["metrics"].items()},
                              program=numbers, control=r.get("control"),
                              seconds=time.perf_counter() - t0)),
              flush=True)
    print(json.dumps(dict(cell=args.cell, program_max=prog,
                          control_min=ctrl)))


if __name__ == "__main__":
    main()
