"""Read a cell's correctness numbers on many seeds in one process.

    python3 -m duckbench.probe --workload <cell> --seeds 1,2,3 [--control]
        [--rounding] [--fault <fault>] [--seconds S] [--trace 0|1]

For each seed a whole run of the cell (``run.run_cell``: set-up, the
window, the reference), one JSON line each: the numbers compared, with
``--control`` the control's numbers (the reference with TF32 products in
the program's place), with ``--rounding`` the rounding reading's (the
reference with its sums reordered in the program's place), with ``--fault``
a fault of ``faults.FAULTS`` planted in the program. These are the readings
the limits in ``limits/`` are set from; the benchmark's own runs do not
make them.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from duckbench import faults, manifest, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated whole numbers")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--rounding", action="store_true")
    ap.add_argument("--fault", choices=faults.FAULTS, default=None)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        run.log("[probe] no CUDA device")
        return 3
    bench = manifest.load()
    cell = manifest.workload(bench, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.monotonic()
        res = run.run_cell(bench, cell, seed, args.seconds, bool(args.trace), "cuda",
                           fault=args.fault, control=args.control,
                           rounding=args.rounding, t0=t0)
        line = {"workload": cell["name"], "seed": seed, "fault": args.fault,
                "correct": res["correct"],
                "numbers": {k: v["value"] for k, v in res["checks"].items()},
                "control": res.get("control"), "rounding": res.get("rounding"),
                "metrics": res["metrics"],
                "attempted": res["attempted"], "reference_s": res["reference_s"],
                "run_s": time.monotonic() - t0, "device": res["device"]}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
