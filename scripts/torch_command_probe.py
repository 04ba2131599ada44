"""Roll a trained joystick policy in the training env under one fixed
command, on the card: how fast it walks where it learned to.

    python scripts/torch_command_probe.py --checkpoint DIR/<date>_<step>.npz [--vx 0.12]

The counterpart of the sim-to-sim gate's joystick rollout
(`deploy.sim2sim_check`: one env, 10 s at vx 0.12, the deterministic
policy) in the batched training env instead of the deploy loop:
TrainEnv(Joystick(TASK)) at NUM_ENVS envs through the fused kernel, no
domain randomization, no pushes, no observation noise, the command set to
(vx, 0, 0, 0, 0, 0, 0) in every env after the reset (the env resamples it
only past step 500), the policy of the runner's (normalizer, params)
checkpoint taken deterministically, SECONDS of 50 Hz control steps.
Prints one JSON line: the share of envs that fell (done before the end),
and over the others the mean forward displacement in the world frame, its
speed and that speed over vx (the gate's track_frac), and the quartiles of
the per-env speed.

Assets: $OPEN_DUCK_ASSETS if set, else the generated stand-in duck
(chip_smoke.asset_root).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

TASK = "flat_terrain_backlash"  # the joystick recipe's task
NUM_ENVS, SECONDS, SEED = 1024, 10.0, 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", required=True, help="the runner's <date>_<step>.npz")
    p.add_argument("--vx", type=float, default=0.12)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the probe runs on the card")
    chip_smoke.asset_root()

    from open_duck_playground_tpu_torch.envs.joystick import Joystick
    from open_duck_playground_tpu_torch.envs.wrapper import TrainEnv
    from open_duck_playground_tpu_torch.train import checkpoint as ckpt
    from open_duck_playground_tpu_torch.train import networks as nets

    dev = torch.device("cuda")
    env = Joystick(TASK, device=dev, config_overrides={
        "push_config.enable": False, "noise_config.level": 0.0})
    te = TrainEnv(env, num_envs=NUM_ENVS, episode_length=1000)
    obs_sizes = {k: v[0] for k, v in env.observation_size.items()}
    template = (nets.rs_init(obs_sizes, dev), nets.PPONetworks(obs_sizes, env.action_size,
                                                               device=dev))
    full_params = ckpt.load(args.checkpoint, template)
    policy = template[1].make_policy_fn(deterministic=True)

    state = te.reset(torch.Generator(device=dev).manual_seed(SEED))
    cmd = torch.zeros_like(state.info["command"])
    cmd[:, 0] = args.vx
    state.info["command"] = cmd
    start = state.data.qpos[:, :2].clone()
    fell = torch.zeros(NUM_ENVS, dtype=torch.bool, device=dev)
    for _ in range(int(SECONDS * 50)):
        action, _ = policy(full_params, state.obs)
        state = te.step(state, action)
        fell |= state.done.bool()
    up = ~fell
    fwd = (state.data.qpos[:, 0] - start[:, 0])[up]
    speed = fwd / SECONDS
    q = torch.quantile(speed, torch.tensor([0.25, 0.5, 0.75], device=dev)).tolist() if len(
        speed) else [None] * 3
    out = {"checkpoint": os.path.basename(args.checkpoint), "task": TASK,
           "num_envs": NUM_ENVS, "seconds": SECONDS, "command_vx": args.vx,
           "fell_frac": float(fell.float().mean()),
           "forward_m": float(fwd.mean()) if len(fwd) else None,
           "achieved_vx": float(speed.mean()) if len(speed) else None,
           "track_frac": float(speed.mean()) / args.vx if len(speed) and args.vx else None,
           "achieved_vx_q25_q50_q75": q,
           "launches": env.physics.launches,
           "device": torch.cuda.get_device_name(dev)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
