"""A/B of the trainer and the env step against an earlier version of the port, on one GPU.

    git archive <commit> | tar -x -C build/parent
    python3 scripts/sgd_graph_ab.py --parent build/parent

`--parent` is a directory holding a whole earlier checkout (its
`open_duck_playground_tpu_torch` package and its `chip_smoke.py`). Each run
is a process of its own on one version, in turns: parent, new, new,
parent. A run trains with chip_smoke's phase 4 configuration (the runner's
recipe on `flat_terrain_backlash`: 8192 DR envs, batch 256 x 32
minibatches, unroll 20, 4 updates, (512, 256, 128) networks, 2 epochs of 2
training steps, phase 4's eval env of 1024 envs; training/sps counts
rollout and SGD only) through `ppo.train(..., profile_breakdown=True)`,
and then times the flat main path's env step untraced (`flat_terrain`,
4096 DR envs, 20 steps after 10), eagerly and, in a checkout that has it,
through the env-step program (`wrapper.EnvStepProgram`, or
`wrapper.CapturedEnvStep` in an older checkout). Prints each run's
`profile_breakdown` (`rollout_s`, `sgd_s`, `training_step_s`, `eval_s`),
`training/sps` per epoch and ms per env step, the card's name and power
limit and the host CPU, and writes them all to `build/sgd_graph_ab.json`
of this checkout.
Exits non-zero if CUDA is unavailable or a run fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(root: str) -> int:
    """One run on the checkout at `root`; prints one "AB_RESULT {json}" line."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs  # the checkout's own: its recipe and helpers
    from open_duck_playground_tpu_torch.envs import randomize, wrapper
    from open_duck_playground_tpu_torch.envs.joystick import Joystick
    from open_duck_playground_tpu_torch.envs.wrapper import TrainEnv
    from open_duck_playground_tpu_torch.train import ppo
    from open_duck_playground_tpu_torch.train import runner as rn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.asset_root()
    out_dir = os.path.join(root, "build", "ab_run")
    cli = rn.build_parser().parse_args(["--output_dir", out_dir, *cs.TRAINER_ARGS])
    runner = rn.OpenDuckMiniV2Runner(cli)
    sps = []
    kw = runner.train_kwargs()
    progress = kw["progress_fn"]

    def recorded(step, metrics):
        if "training/sps" in metrics:
            sps.append(metrics["training/sps"])
        progress(step, metrics)

    kw["progress_fn"] = recorded
    t0 = time.perf_counter()
    ppo.train(environment=runner.env, eval_env=runner.eval_env, **kw, profile_breakdown=True)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    bd = ppo.LAST_PROFILE_BREAKDOWN

    dev = torch.device("cuda")
    task, B = cs.FLAT_MAIN
    env = Joystick(task, device=dev, seed=0)
    te = TrainEnv(env, num_envs=B, episode_length=1000,
                  randomization_fn=randomize.domain_randomize,
                  randomization_generator=torch.Generator(device=dev).manual_seed(0))
    g = torch.Generator(device=dev).manual_seed(2)
    n_warm, n = cs.PROFILE_WARMUP, cs.PROFILE_STEPS
    actions = torch.rand((n_warm + n, B, env.action_size), generator=g, device=dev) * 2 - 1
    state = te.reset(torch.Generator(device=dev).manual_seed(1))
    for i in range(n_warm):
        state = te.step(state, actions[i])
    steps = {"eager": te.step}
    # the env-step program's name in this checkout (an older one calls it CapturedEnvStep)
    graphed = getattr(wrapper, "EnvStepProgram", getattr(wrapper, "CapturedEnvStep", None))
    if graphed is not None:
        steps["graph"] = graphed(te)
        steps["graph"].capture(state, actions[0])
    env_step_ms = {}
    for name, step in steps.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n_warm, n_warm + n):
            state = step(state, actions[i])
        torch.cuda.synchronize()
        env_step_ms[name] = (time.perf_counter() - t0) * 1e3 / n
    print("AB_RESULT " + json.dumps({
        "root": root, "gpu": cs.gpu_line(), "host_cpu": cs.cpu_line(), "train_s": train_s,
        "training_sps": sps, "breakdown": bd, "env_step_ms": env_step_ms}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("sgd_graph_ab: CUDA is not available", file=sys.stderr)
        return 2
    if args.worker:
        return worker(args.worker)
    if not args.parent:
        ap.error("--parent is required")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    env = dict(os.environ, OPEN_DUCK_ASSETS=cs.asset_root())
    runs = []
    for name, root in (("parent", os.path.abspath(args.parent)), ("new", ROOT),
                       ("new", ROOT), ("parent", os.path.abspath(args.parent))):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root],
                              cwd=root, env=env, capture_output=True, text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB_RESULT ")]
        sys.stdout.write("".join(f"[{name}] {ln}\n" for ln in proc.stdout.splitlines()
                                 if ln.startswith("[ppo]")))
        if proc.returncode or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            print(f"sgd_graph_ab: the {name} run failed (exit {proc.returncode})", file=sys.stderr)
            return 1
        res = json.loads(lines[-1][len("AB_RESULT "):])
        res["version"] = name
        runs.append(res)
        bd = res["breakdown"]
        print(f"[ab] {name}: sgd_s {bd['sgd_s']}, rollout_s {bd['rollout_s']}, training_step_s "
              f"{bd['training_step_s']}, eval_s {bd['eval_s']}, training/sps "
              f"{res['training_sps']}, env step ms (flat 4096, untraced) "
              f"{json.dumps(res['env_step_ms'])}; {res['gpu']}; {res['host_cpu']}", flush=True)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "sgd_graph_ab.json"), "w") as f:
        json.dump(runs, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
