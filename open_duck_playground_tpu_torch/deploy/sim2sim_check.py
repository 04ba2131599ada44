"""Sim-to-sim acceptance gate: the exported policy must meet its task bar
in both engines, the port's own physics (engine ``own``: the fused physics
step at one env, the kernel on the card, its plain version with
``--device cpu``) and the MuJoCo C engine (engine ``mujoco``, where the
``mujoco`` package imports).

Joystick (default): rolls the ONNX policy for `--seconds` under a forward
velocity command and enforces
  - upright the whole run (up_z > 0 throughout; no fall)
  - achieved forward speed >= --min_track_frac of the commanded vx
    (default 0.7; 70% command tracking in clean sim is the proxy for the
    reference's acceptance, the robot walking)

Standing (--standing): two phases, both must pass:
  - plain: upright the whole run (up_z >= --min_up_z, 0.9), base
    translation <= --max_drift_m (0.15 m). Head-joint angles against the
    command are reported, not judged: the reference's head_pos cost is
    gated on locomotion, which standing never samples, so head tracking
    carries no reward pressure (a quirk kept for parity).
  - pushed: a directional push battery, --push_dirs independent rollouts,
    each with one base-velocity kick of --push_mag m/s (0.6, inside the
    U(0.1, 1.0) training range) in direction 2*pi*k/n after 1 s of
    settling, then 3 s to recover; the policy must survive
    >= --min_survival of them. The survival fraction over directions is
    the discriminative statistic: one long rollout with a push sequence is
    chaotic in the magnitude.

Prints one JSON line per engine and phase plus a final bar line; main()
returns 0 if the bar is met, else 1.

Usage:
  python -m open_duck_playground_tpu_torch.deploy.sim2sim_check -o policy.onnx \
      [--task flat_terrain_backlash] [--vx 0.12] [--seconds 10] [--device cuda|cpu]
  python -m open_duck_playground_tpu_torch.deploy.sim2sim_check -o standing.onnx \
      --standing [--head 0.2 0.2 0.5 0.0] [--max_drift_m 0.15]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import sys
from typing import Optional, Sequence

import numpy as np


def make_engine(kind: str, model_path: str, reference_data: str,
                onnx_path: str, standing: bool, device: str = "cuda"):
    if kind == "mujoco":
        from open_duck_playground_tpu_torch.deploy.mujoco_infer import MjInfer

        return MjInfer(model_path, reference_data, onnx_path, standing)
    from open_duck_playground_tpu_torch.deploy.sim_infer import SimInfer

    return SimInfer(model_path, reference_data, onnx_path, standing, device)


def apply_push(inf, vx: float, vy: float) -> None:
    """Overwrite the base planar velocity, as the training push does
    (reference joystick.py:381-399 writes qvel[x, y]): in MuJoCo's MjData,
    or in place in the port's (1, nv) qvel on its device."""
    if hasattr(inf, "_mujoco"):
        inf.data.qvel[0] = vx
        inf.data.qvel[1] = vy
    else:
        qvel = inf.data.qvel
        qvel[0, 0:2] = qvel.new_tensor([vx, vy])


def run_push_battery(kind: str, model_path: str, reference_data: str,
                     onnx_path: str, command, standing: bool,
                     push_mag: float, n_dirs: int = 8,
                     settle_s: float = 1.0, recover_s: float = 3.0, device: str = "cuda"):
    """Directional push battery: n_dirs independent rollouts, each with ONE
    base-velocity kick of `push_mag` m/s in direction 2*pi*k/n_dirs after a
    settle period; count survivals (up_z > 0 throughout)."""
    per_dir = []
    survived = 0
    for k in range(n_dirs):
        theta = 2.0 * math.pi * k / n_dirs
        inf = make_engine(kind, model_path, reference_data, onnx_path, standing, device)
        inf.commands = list(command)
        min_up = 1.0
        n1 = int(settle_s * 50)
        n2 = int(recover_s * 50)
        with contextlib.redirect_stdout(io.StringIO()):
            for tick in range(n1 + n2):
                if tick == n1:
                    apply_push(inf, push_mag * math.cos(theta),
                               push_mag * math.sin(theta))
                targets = inf.control_step()
                inf.step_control(targets)
                min_up = min(min_up, float(inf.get_gravity(inf.data)[2]))
                if min_up < 0:
                    break
        ok = bool(min_up > 0)
        survived += ok
        per_dir.append({"deg": round(math.degrees(theta)),
                        "min_up_z": round(min_up, 3), "survived": ok})
    return {
        "engine": kind,
        "task": "standing" if standing else "joystick",
        "phase": f"push_battery_{push_mag}m/s",
        "n_dirs": n_dirs,
        "survived": survived,
        "survival_frac": round(survived / n_dirs, 3),
        "per_dir": per_dir,
    }


def run_engine(kind: str, model_path: str, reference_data: str,
               onnx_path: str, command, seconds: float, standing: bool,
               push_mag: float = 0.0, push_every_s: float = 3.0,
               phase_freq: float = 1.0, device: str = "cuda"):
    inf = make_engine(kind, model_path, reference_data, onnx_path, standing, device)
    inf.commands = list(command)
    inf.phase_frequency_factor = phase_freq

    start = np.asarray(inf.qpos[:2], float).copy()
    min_up = 1.0
    n_ticks = int(seconds * 50)
    push_every = max(1, int(push_every_s * 50))
    push_rng = np.random.default_rng(0)  # deterministic direction sequence
    head_tail = []  # head-joint angles over the last 2 s
    with contextlib.redirect_stdout(io.StringIO()):
        for tick in range(n_ticks):
            if push_mag > 0.0 and tick > 0 and tick % push_every == 0:
                theta = push_rng.uniform(0.0, 2.0 * np.pi)
                apply_push(inf, push_mag * np.cos(theta),
                           push_mag * np.sin(theta))
            targets = inf.control_step()
            inf.step_control(targets)
            min_up = min(min_up, float(inf.get_gravity(inf.data)[2]))
            if min_up < 0:
                break
            if standing and tick >= n_ticks - 100:
                head_tail.append(
                    np.asarray(inf.get_actuator_joints_qpos(inf.data.qpos))[5:9]
                )
    end = np.asarray(inf.qpos[:2], float).copy()
    dist = float(np.linalg.norm(end - start))
    fwd = float(end[0] - start[0])
    vx = command[0]
    out = {
        "engine": kind,
        "task": "standing" if standing else "joystick",
        "phase": f"pushed_{push_mag}m/s" if push_mag > 0.0 else "plain",
        "seconds": seconds,
        "walked_m": round(dist, 3),
        "forward_m": round(fwd, 3),
        "min_up_z": round(min_up, 3),
        "fell": min_up < 0,
    }
    if standing:
        out["command_head"] = [round(c, 3) for c in command[3:]]
        if head_tail:
            out["achieved_head"] = [
                round(float(v), 3) for v in np.mean(head_tail, axis=0)
            ]
    else:
        out["command_vx"] = vx
        out["achieved_vx"] = round(fwd / seconds, 4)
        out["track_frac"] = round(fwd / seconds / vx, 3) if vx else None
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("-o", "--onnx_model_path", required=True)
    p.add_argument("--task", default="flat_terrain_backlash")
    p.add_argument("--vx", type=float, default=0.12)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--min_track_frac", type=float, default=0.7)
    p.add_argument("--standing", action="store_true")
    p.add_argument("--head", type=float, nargs=4, default=[0.2, 0.2, 0.5, 0.0],
                   help="neck_pitch head_pitch head_yaw head_roll (--standing)")
    p.add_argument("--max_drift_m", type=float, default=0.15)
    p.add_argument("--min_up_z", type=float, default=0.9,
                   help="uprightness floor for --standing (plain phase)")
    p.add_argument("--push_mag", type=float, default=0.6,
                   help="push-battery kick magnitude, m/s (0 disables the "
                        "pushed phase; training samples U(0.1, 1.0))")
    p.add_argument("--push_dirs", type=int, default=8,
                   help="directions in the push battery")
    p.add_argument("--min_survival", type=float, default=0.75,
                   help="required survival fraction over the push battery")
    # gait-clock scaling, the reference's own p/m teleop control
    # (mujoco_infer.py:105-154)
    p.add_argument("--phase_freq", type=float, default=1.0,
                   help="gait clock scale (reference p/m keys)")
    p.add_argument("--skip_own", action="store_true",
                   help="only the MuJoCo engine")
    p.add_argument("--own_only", action="store_true",
                   help="only the port's engine (no mujoco package needed; for "
                        "heightfield scenes, where MuJoCo's prism collider is "
                        "pathological for thin foot meshes)")
    p.add_argument("--device", default="cuda",
                   help="the own engine's device: 'cuda' (the fused kernel) or "
                        "'cpu' (its plain version)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    from open_duck_playground_tpu_torch.models.open_duck_mini_v2 import constants

    model_path = constants.task_to_xml(args.task)
    reference_data = constants.reference_motion_path()

    if args.standing:
        command = [0.0, 0.0, 0.0] + list(args.head)
    else:
        command = [args.vx, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]

    results = []
    pushed = []
    if args.own_only:
        engines = ["own"]
    elif args.skip_own:
        engines = ["mujoco"]
    else:
        engines = ["mujoco", "own"]
    for kind in engines:
        r = run_engine(kind, model_path, reference_data,
                       args.onnx_model_path, command, args.seconds,
                       args.standing, phase_freq=args.phase_freq, device=args.device)
        results.append(r)
        print(json.dumps(r), flush=True)
        if args.standing and args.push_mag > 0.0:
            r = run_push_battery(kind, model_path, reference_data,
                                 args.onnx_model_path, command,
                                 args.standing, push_mag=args.push_mag,
                                 n_dirs=args.push_dirs, device=args.device)
            pushed.append(r)
            print(json.dumps(r), flush=True)

    if args.standing:
        ok_plain = all(
            (not r["fell"]) and r["min_up_z"] >= args.min_up_z
            and r["walked_m"] <= args.max_drift_m
            for r in results
        )
        ok_pushed = all(
            r["survival_frac"] >= args.min_survival for r in pushed
        )
        ok = ok_plain and ok_pushed
        bar = {"pass": ok, "plain_pass": ok_plain,
               "pushed_pass": ok_pushed if pushed else None,
               "min_up_z": args.min_up_z, "max_drift_m": args.max_drift_m,
               "push_mag": args.push_mag,
               "min_survival": args.min_survival}
    else:
        ok = all(
            (not r["fell"]) and r["track_frac"] is not None
            and r["track_frac"] >= args.min_track_frac
            for r in results
        )
        bar = {"pass": ok, "min_track_frac": args.min_track_frac}
    print(json.dumps(bar), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
