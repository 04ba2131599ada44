"""One run of a benchmark cell with the port's tracer on or off, its
program spans read beside the harness's numbers, on one GPU.

    python3 scripts/span_window.py --workload <cell> --seed <n> --seconds 51 --tracer 1

Runs `duckbench.run.run_cell` as `python3 -m duckbench.run ... --trace 1`
does (set-up, window with the harness's CUDA events, the profiled units,
the reference check), with the benchmark's `--trace 1` reading of the
program's tracer that `duckbench/run.py` does not make yet, when
`--tracer 1`: `profiling.enable()` before the program is built (its graphs
capture their stamps), `profiling.reset()` at the start of the window,
`profiling.summary()` after it, the tracer left on for the profiled units
(the profiler's idle gaps then carry the program's names). From the
summary, per step or eval step (`program_metrics`): `rollout_physics_ms`
(device ms of the 20 `physics` spans inside one `ppo.rollout.replay`),
`rollout_env_ms` (the 20 `env.step` spans less their `physics`),
`host_step_ms` (host ms of `ppo.draws` + `ppo.training_step`),
`eval_physics_ms` (`physics` inside one `ppo.eval_step.replay`), the device
idle share from stamps and its gaps by host span, `dropped`; beside them
the profiler's fused-kernel time per unit from the harness's trace.

Once `duckbench/run.py` makes that reading, `program_metrics` becomes the
readers under `duckbench/metrics/` and this script goes.

Prints the harness's result line, then one JSON line with all of it, and
appends that line to `--out` (default build/span_window.jsonl).
Exits 3 without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

T0 = time.monotonic()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def _sum_paths(summary: dict, inside: str, suffix: str, key: str = "device_ms") -> tuple:
    """(sum of `key`, count) over the paths through a span named `inside`
    that end in `suffix`."""
    rows = [v for p, v in summary["paths"].items()
            if inside in p.split("/") and (p + "/").endswith("/" + suffix + "/")]
    return sum(r[key] for r in rows), sum(r["count"] for r in rows)


def program_metrics(s: dict, loop: str) -> dict:
    """The tracer's per-layer numbers of one window (module docstring)."""
    out = {"device_idle_pct": s["device_idle_pct"], "window_ms": s["window_ms"],
           "busy_ms": s["busy_ms"], "dropped": s["dropped"], "units": s["units"],
           "stamps": s["stamps"], "idle_by_span": s["idle_by_span"], "idle_gaps": s["idle_gaps"],
           "counters": s["counters"], "graphs": s["graphs"],
           "spans": {k: {a: round(b, 4) for a, b in v.items()} for k, v in s["spans"].items()}}
    if loop == "train":
        _, replays = _sum_paths(s, "ppo.rollout", "ppo.rollout.replay")
        phys, n_phys = _sum_paths(s, "ppo.rollout.replay", "env.step/physics")
        env, _ = _sum_paths(s, "ppo.rollout.replay", "env.step")
        steps = s["spans"].get("ppo.training_step", {}).get("count", 0)
        host = sum(s["spans"].get(k, {}).get("host_ms", 0.0)
                   for k in ("ppo.draws", "ppo.training_step"))
        out.update(replays=replays, physics_per_replay=n_phys / max(replays, 1),
                   rollout_physics_ms=phys / replays if replays else None,
                   rollout_env_ms=(env - phys) / replays if replays else None,
                   host_step_ms=host / steps if steps else None)
    else:
        _, replays = _sum_paths(s, "ppo.eval_step", "ppo.eval_step.replay")
        phys, n_phys = _sum_paths(s, "ppo.eval_step.replay", "env.step/physics")
        out.update(replays=replays, physics_per_replay=n_phys / max(replays, 1),
                   eval_physics_ms=phys / replays if replays else None)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--tracer", type=int, choices=(0, 1), default=1)
    ap.add_argument("--out", default=os.path.join("build", "span_window.jsonl"))
    args = ap.parse_args(argv)

    import torch

    from duckbench import manifest, program
    from duckbench import run as bench
    from open_duck_playground_tpu_torch.utils import profiling

    if not torch.cuda.is_available():
        print("[span_window] no CUDA device", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    on = bool(args.tracer)
    seen: dict = {}
    make, window, traced = program.program, bench.window, bench.traced

    def make_traced(*a, **k):
        if on:
            profiling.enable()
        return make(*a, **k)

    def window_traced(*a, **k):
        if on:
            profiling.reset()
        seen["window"] = window(*a, **k)
        if on:
            seen["summary"] = profiling.summary()
        return seen["window"]

    def traced_kept(*a, **k):
        seen["trace"] = traced(*a, **k)
        return seen["trace"]

    program.program, bench.window, bench.traced = make_traced, window_traced, traced_kept

    bm = manifest.load()
    cell = manifest.workload(bm, args.workload)
    card = _card()
    result = bench.run_cell(bm, cell, args.seed, args.seconds, True, "cuda", t0=T0)
    print(json.dumps(result), flush=True)
    win, tr = seen["window"], seen["trace"]
    loop = "train" if "train" in args.workload else "eval"
    line = {"workload": args.workload, "seed": args.seed, "tracer": on, "card": card,
            "correct": result["correct"],
            "metrics": {k: v["value"] for k, v in result["metrics"].items()},
            "window_rate": win["env_steps"] / win["window_s"], "window": win,
            "trace": {k: tr[k] for k in ("kernel_s", "kernel_launches", "units", "busy_s",
                                         "window_s")},
            "kernel_ms_per_unit": 1e3 * tr["kernel_s"] / tr["units"],
            "idle_gaps_traced": result["breakdown"]["idle_gaps"]}
    if on:
        line["program"] = program_metrics(seen["summary"], loop)
    text = json.dumps(line)
    print(text, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as f:
        f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
