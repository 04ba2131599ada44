"""Read a cell's correctness numbers on many seeds in one process.

    python3 -m duckbench.probe --workload <cell> --seeds 1,2,3 [--control]
        [--rounding] [--fault <fault>[,<fault>...]] [--follow-only] [--seconds S]
        [--trace 0|1]

For each seed a whole run of the cell (``run.run_cell``: set-up, the
window, the reference), and one with each fault named, one JSON line each:
the numbers compared; on the sound runs, with ``--control`` the control's
numbers (the reference with TF32 products in the program's place), with
``--rounding`` the rounding reading's (the reference with its sums
reordered in the program's place) and, on a cell of several cards, the
readings of ``run.rank_readings`` (the ranks' partials, the reference with
its own normalizer, each leaf's gaps); with ``--fault`` each fault of
``faults.FAULTS`` named planted in the program in turn after the sound
run. ``--follow-only`` leaves out the reference's own reset and first
physics steps (a training cell's env_gap), which take most of its time. A
cell on several cards runs as that many ranks (``ranks.py``), rank 0
printing the lines as they come. These are the readings the limits in
``limits/`` are set from; the benchmark's own runs do not make them.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from duckbench import faults, manifest, ranks, run

PER_RUN_S = 600.0  # a run's set-up and its references, on every rank
VARIANTS = ("control", "rounding", "partials", "unfollowed", "partials_unfollowed", "leaves")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated whole numbers")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--rounding", action="store_true")
    ap.add_argument("--follow-only", action="store_true")
    ap.add_argument("--fault", default=None,
                    help=f"comma-separated, of {', '.join(faults.FAULTS)}")
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = manifest.load()
    cell = manifest.workload(bench, args.workload)
    seeds = [int(x) for x in args.seeds.split(",")]
    fault_list = [None] + (args.fault.split(",") if args.fault else [])
    if any(f is not None and f not in faults.FAULTS for f in fault_list):
        run.log(f"[probe] --fault: of {faults.FAULTS}")
        return 2
    if not run.cards_for(cell):
        return 3
    if cell["chips"] > 1 and ranks.rank_t0() is None:
        limit = ranks.FIRST_RUN_S + PER_RUN_S * len(seeds) * len(fault_list)
        code, _ = ranks.launch([sys.executable, "-m", "duckbench.probe",
                                *run.launcher_argv(argv)], cell["chips"], limit,
                               time.monotonic(), capture=False)
        return code
    import torch

    torch.set_num_threads(1)
    shard = run.join(cell, ranks.rank_t0(), timeout_s=PER_RUN_S)
    try:
        for seed in seeds:
            for fault in fault_list:
                t0 = time.monotonic()
                res = run.run_cell(bench, cell, seed, args.seconds, bool(args.trace),
                                   "cuda" if shard is None else shard.device, fault=fault,
                                   control=args.control and fault is None,
                                   rounding=args.rounding and fault is None,
                                   follow_only=args.follow_only, t0=t0, shard=shard)
                if shard is not None and not shard.is_main:
                    continue
                line = {"workload": cell["name"], "seed": seed, "fault": fault,
                        "correct": res["correct"],
                        "numbers": {k: v["value"] for k, v in res["checks"].items()},
                        **{k: res[k] for k in VARIANTS if k in res}, "metrics": res["metrics"],
                        "attempted": res["attempted"], "reference_s": res["reference_s"],
                        "run_s": time.monotonic() - t0, "device": res["device"]}
                print(json.dumps(line), flush=True)
    finally:
        if shard is not None:
            ranks.leave()
    return 0


if __name__ == "__main__":
    sys.exit(main())
