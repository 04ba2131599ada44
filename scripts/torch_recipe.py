"""Train one of the two shipping recipes of the JAX package on the card
through the PyTorch port, then gate its final ONNX policy sim-to-sim.

    python scripts/torch_recipe.py --recipe joystick|standing --output_dir DIR

The recipes are the JAX package's own commands:
  joystick: --env joystick --task flat_terrain_backlash --num_timesteps 300000000
            --num_envs 8192 --num_evals 16 (RESULTS.md, "Reference winning recipe")
  standing: --env standing --task flat_terrain_backlash --num_timesteps 100000000
            --num_envs 8192 (README.md, the standing command)
Both run with --auto_resume: a second call into the same DIR continues the
run from its last full state (`full_<epoch>.npz`), bit for bit.

The port's runner (`train/runner.py`) trains in this process, writing its
metrics.jsonl, a (normalizer, params) checkpoint and an ONNX policy at every
eval, and the rotated full states into DIR. After each eval this script
appends one line to DIR/readings.jsonl: the wall clock, the card's peak
allocated memory since the previous eval (the peak is then reset), its
reserved memory, and the fused physics kernel's launches on the train and
the eval env. Everything printed also goes to DIR/train.log. Then it runs
`deploy.sim2sim_check --own_only --device cuda` (with --standing for the
standing recipe) on the last ONNX, and writes DIR/summary.json, which it
prints: the eval curve, training/sps and memory per epoch, the launches,
the wall time split, the gate's JSON lines with its bars, the card
(nvidia-smi's name and power limit), and the checks below.

Exit code 0 if every check holds: the run reached its num_timesteps, every
eval is finite, an ONNX exists for every eval, no epoch after the first
reads below SPS_FLOOR of the median training/sps, the peak allocated memory
grows by at most PEAK_GROWTH over those epochs, the kernel launches equal
the count the code gives, and the gate passes. Else 1. Without a CUDA
device it raises.

Assets: $OPEN_DUCK_ASSETS if set, else the generated stand-in duck
(tests/duck_standin.py), written into build/standin_assets/; the assets,
the card's line and the launch count come from chip_smoke.py's helpers.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import re
import statistics
import sys
import time
from typing import Dict, List, Optional, Sequence

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

RECIPES = {
    "joystick": ("--env", "joystick", "--task", "flat_terrain_backlash",
                 "--num_timesteps", "300000000", "--num_envs", "8192", "--num_evals", "16"),
    "standing": ("--env", "standing", "--task", "flat_terrain_backlash",
                 "--num_timesteps", "100000000", "--num_envs", "8192"),
}
GATE_FLAGS = {"joystick": (), "standing": ("--standing",)}
# over the epochs after the first (the first holds the rollout and SGD captures)
SPS_FLOOR = 0.9
PEAK_GROWTH = 0.01
_EVAL_RE = re.compile(r"^\[ppo\] eval rollout done in ([0-9.]+)s")
_SAVE_RE = re.compile(r"^\[ppo\] full-state save epoch \d+: host copy ([0-9.]+)s write ([0-9.]+)s")
_CAPTURE_RE = re.compile(r"^\[ppo\] (rollout|SGD step|eval step) captured: (\{.*\})$")
_EXPORT_RE = re.compile(r"^\[recipe\] checkpoint and ONNX at step \d+: ([0-9.]+) s$")
_STEP_RE = re.compile(r"_(\d+)\.onnx$")


class _Tee(io.TextIOBase):
    """A text stream that writes to every stream it holds."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, s: str) -> int:
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self) -> None:
        for st in self.streams:
            st.flush()


def _jsonl(path: str) -> List[dict]:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _by_step(lines: List[dict]) -> List[dict]:
    """One line per step, the last one written (a resumed run repeats the
    epoch whose full state a lost call did not save), in step order."""
    return sorted({line["step"]: line for line in lines}.values(), key=lambda d: d["step"])


def expected_launches(session: List[dict]) -> Dict[str, int]:
    """The fused kernel's launches one process of the runner makes, from its
    readings (chip_smoke.fused_launches, counted from the runner's
    construction): one rollout per training step, one eval per reading. A
    fresh run evaluates at step 0 before it trains; a resumed one does
    not."""
    first = session[0]
    epochs = len(session) - (1 if first["step"] == 0 else 0)
    return chip_smoke.fused_launches(first["unroll_length"], epochs * first["steps_per_epoch"],
                                     len(session), first["episode_length"], sized=True)


def summarize(out_dir: str, num_timesteps: int, gate: Optional[dict] = None) -> dict:
    """The run in `out_dir` (metrics.jsonl, readings.jsonl, train.log and the
    ONNX files the runner and this script wrote) as one dict with its
    checks; `gate`: {"rc": ..., "lines": [...]} of sim2sim_check."""
    metrics = _by_step(_jsonl(os.path.join(out_dir, "metrics.jsonl")))
    raw = _jsonl(os.path.join(out_dir, "readings.jsonl"))
    readings = {r["step"]: r for r in raw}
    curve = [{"step": m["step"], "eval/episode_reward": m["eval/episode_reward"],
              "eval/episode_reward_std": m["eval/episode_reward_std"],
              "eval/avg_episode_length": m["eval/avg_episode_length"]} for m in metrics]
    epochs = []
    for prev, m in zip(metrics, metrics[1:]):
        r = readings.get(m["step"], {})
        epochs.append({"step": m["step"], "training/sps": m["training/sps"],
                       "epoch_s": (m["step"] - prev["step"]) / m["training/sps"],
                       "peak_allocated_bytes": r.get("peak_allocated_bytes"),
                       "reserved_bytes": r.get("reserved_bytes")})
    later = epochs[1:]
    sps = [e["training/sps"] for e in later]
    sps_ratio = min(sps) / statistics.median(sps) if sps else None
    peaks = [e["peak_allocated_bytes"] for e in later if e["peak_allocated_bytes"] is not None]
    peak_growth = max(peaks) / peaks[0] - 1.0 if peaks else None

    onnx_steps = sorted({int(m.group(1)) for f in os.listdir(out_dir)
                         if (m := _STEP_RE.search(f))})
    sessions: Dict[float, List[dict]] = {}
    for r in raw:
        sessions.setdefault(r["session"], []).append(r)
    launches = [{"launches": s[-1]["launches"], "want": expected_launches(s),
                 "first_step": s[0]["step"], "last_step": s[-1]["step"]}
                for s in sessions.values()]

    split = {"evals_s": 0.0, "full_state_saves_s": 0.0, "exports_s": 0.0, "captures": {}}
    log_path = os.path.join(out_dir, "train.log")
    if os.path.exists(log_path):
        with open(log_path) as f:
            for line in f:
                line = line.rstrip("\n")
                if m := _EVAL_RE.match(line):
                    split["evals_s"] += float(m.group(1))
                elif m := _SAVE_RE.match(line):
                    split["full_state_saves_s"] += float(m.group(1)) + float(m.group(2))
                elif m := _EXPORT_RE.match(line):
                    split["exports_s"] += float(m.group(1))
                elif m := _CAPTURE_RE.match(line):
                    info = json.loads(m.group(2))
                    split["captures"].setdefault(m.group(1), []).append(
                        round(info["warmup_s"] + info["capture_s"] + info["instantiate_s"], 4))
    split["training_s"] = sum(e["epoch_s"] for e in epochs)
    split["captures_s"] = sum(sum(v) for v in split["captures"].values())
    split["total_s"] = sum(s[-1]["wall_s"] for s in sessions.values())
    split["gate_s"] = gate.get("seconds") if gate else None

    finite = bool(metrics) and all(
        math.isfinite(v) for m in metrics for k, v in m.items()
        if k.startswith(("eval/", "training/")) and isinstance(v, (int, float)))
    last_step = metrics[-1]["step"] if metrics else 0
    bar = gate["lines"][-1] if gate and gate.get("lines") else None
    checks = {
        "steps": last_step >= num_timesteps,
        "finite": finite,
        "onnx_at_every_eval": onnx_steps == [m["step"] for m in metrics],
        "sps": sps_ratio is not None and sps_ratio >= SPS_FLOOR,
        "peak_memory": peak_growth is not None and peak_growth <= PEAK_GROWTH,
        "launches": bool(launches) and all(s["launches"] == s["want"] for s in launches),
        "gate": bool(bar and bar.get("pass")),
    }
    return {
        "num_timesteps": num_timesteps, "last_step": last_step, "curve": curve,
        "epochs": epochs, "sps_min_over_median": sps_ratio, "sps_floor": SPS_FLOOR,
        "peak_growth": peak_growth, "peak_growth_limit": PEAK_GROWTH,
        "onnx_steps": onnx_steps, "launches": launches, "wall": split, "gate": gate,
        "checks": checks, "ok": all(checks.values()),
    }


def train(recipe: str, out_dir: str) -> int:
    """Train `recipe` into `out_dir` (resuming), return num_timesteps."""
    import torch

    from open_duck_playground_tpu_torch.train import runner as rn

    args = rn.build_parser().parse_args(
        [*RECIPES[recipe], "--output_dir", out_dir, "--auto_resume"])
    runner = rn.OpenDuckMiniV2Runner(args)
    kw = runner.train_kwargs()
    T, B = kw["unroll_length"], kw["num_envs"]
    steps_per_epoch = math.ceil(kw["num_timesteps"] / (max(kw["num_evals"] - 1, 1) * B * T))
    session, t0 = time.time(), time.perf_counter()
    readings = os.path.join(runner.output_dir, "readings.jsonl")
    report, save = runner.progress_callback, runner.policy_params_fn

    def progress(num_steps, metrics):
        report(num_steps, metrics)
        line = {"step": num_steps, "session": session, "wall_s": time.perf_counter() - t0,
                "peak_allocated_bytes": torch.cuda.max_memory_allocated(runner.device),
                "reserved_bytes": torch.cuda.memory_reserved(runner.device),
                "launches": {"train_env": runner.env.physics.launches,
                             "eval_env": runner.eval_env.physics.launches},
                "unroll_length": T, "episode_length": kw["episode_length"],
                "steps_per_epoch": steps_per_epoch}
        torch.cuda.reset_peak_memory_stats(runner.device)
        with open(readings, "a") as f:
            f.write(json.dumps(line) + "\n")

    def policy_params(current_step, make_policy, params):
        t = time.perf_counter()
        save(current_step, make_policy, params)
        print(f"[recipe] checkpoint and ONNX at step {current_step}: "
              f"{time.perf_counter() - t:.3f} s", flush=True)

    runner.progress_callback, runner.policy_params_fn = progress, policy_params
    runner.train()
    return kw["num_timesteps"]


def run_gate(recipe: str, out_dir: str) -> dict:
    """sim2sim_check on the card on the last ONNX of `out_dir`: its exit
    code, its JSON lines (the last one the bar) and its seconds."""
    from open_duck_playground_tpu_torch.deploy import sim2sim_check

    onnx = max((f for f in os.listdir(out_dir) if _STEP_RE.search(f)),
               key=lambda f: int(_STEP_RE.search(f).group(1)))
    argv = ["-o", os.path.join(out_dir, onnx), "--own_only", "--device", "cuda",
            *GATE_FLAGS[recipe]]
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
        rc = sim2sim_check.main(argv)
    lines = [json.loads(s) for s in buf.getvalue().splitlines() if s.startswith("{")]
    return {"onnx": onnx, "argv": argv, "rc": rc, "lines": lines,
            "seconds": time.perf_counter() - t}


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--recipe", required=True, choices=sorted(RECIPES))
    p.add_argument("--output_dir", required=True)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the recipes train on the card")
    chip_smoke.asset_root()
    out_dir = os.path.abspath(args.output_dir)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "train.log"), "a") as log, \
            contextlib.redirect_stdout(_Tee(sys.stdout, log)):
        num_timesteps = train(args.recipe, out_dir)
        gate = run_gate(args.recipe, out_dir)
    summary = {"recipe": args.recipe, "flags": list(RECIPES[args.recipe]) + ["--auto_resume"],
               "gpu": chip_smoke.gpu_line(), "device": torch.cuda.get_device_name(0),
               **summarize(out_dir, num_timesteps, gate)}
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    if not summary["ok"]:
        failed = [k for k, v in summary["checks"].items() if not v]
        print(f"[recipe] FAILED {args.recipe}: {', '.join(failed)}", file=sys.stderr)
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
