"""Sim-to-sim policy validation on the port's own engine.

Rolls an exported ONNX policy through the port's fused physics step at one
env (the hand-written kernel on the card, one launch per 50 Hz tick; its
plain PyTorch version with ``--device cpu``) with CLEAN observations (no
training noise or delays, but with the deploy-side +1.3 m/s^2
accelerometer x-bias the reference applies), the same 50 Hz control /
500 Hz physics decimation, action scaling and motor speed-limit clamping.
Saves the obs trace to mujoco_saved_obs.pkl, like upstream.

The control loop is shared with deploy/mujoco_infer.py (the MuJoCo C
engine) via deploy/policy_loop.py: run both and diff the obs traces to
localize engine gaps.

Headless by default; `--interactive` enables terminal keyboard teleop
(same key map as the reference's viewer callback, deploy/teleop.py), and
`--render` records the rollout, re-posed in MuJoCo from the engine's qpos
(deploy/render.py: needs ``mujoco`` and PIL or OpenCV, and fails before
the engine is built where they are missing).

Usage:
  python -m open_duck_playground_tpu_torch.deploy.sim_infer -o policy.onnx \
      [--task flat_terrain_backlash] [--standing] [--seconds 10] \
      [--command vx vy wz np hp hy hr] [--device cuda|cpu] [--interactive] \
      [--render rollout.gif]
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from open_duck_playground_tpu_torch.deploy.policy_loop import PolicyLoopMixin
from open_duck_playground_tpu_torch.deploy.sim_infer_base import SimInferBase
from open_duck_playground_tpu_torch.models.open_duck_mini_v2 import constants


class SimInfer(PolicyLoopMixin, SimInferBase):
    def __init__(self, model_path: str, reference_data: str,
                 onnx_model_path: str, standing: bool = False, device="cuda"):
        SimInferBase.__init__(self, model_path, device)
        self.init_policy_loop(reference_data, onnx_model_path, standing)


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("-o", "--onnx_model_path", type=str, required=True)
    parser.add_argument("--task", type=str, default="flat_terrain")
    parser.add_argument("--model_path", type=str, default=None)
    parser.add_argument("--reference_data", type=str, default=None)
    parser.add_argument("--standing", action="store_true")
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument(
        "--command", type=float, nargs=7,
        default=[0.1, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
        help="vx vy wz neck_pitch head_pitch head_yaw head_roll",
    )
    parser.add_argument("--interactive", action="store_true",
                        help="terminal keyboard teleop (see deploy/teleop.py)")
    parser.add_argument("--save_obs", type=str, default="mujoco_saved_obs.pkl")
    parser.add_argument("--render", type=str, default=None,
                        help="record the rollout to a .gif/.mp4 (EGL offscreen; "
                             "frames re-posed in MuJoCo from the engine's qpos)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (the fused kernel) or 'cpu' (its plain version)")
    args = parser.parse_args(argv)

    model_path = args.model_path or constants.task_to_xml(args.task)
    reference_data = args.reference_data or constants.reference_motion_path()
    video = None
    if args.render:  # before the engine: a missing mujoco fails here
        from open_duck_playground_tpu_torch.deploy.render import MjVideoRenderer

        video = MjVideoRenderer(model_path)
    infer = SimInfer(model_path, reference_data, args.onnx_model_path,
                     args.standing, args.device)
    infer.commands = list(args.command)
    teleop = None
    if args.interactive:
        from open_duck_playground_tpu_torch.deploy.teleop import StdinTeleop

        teleop = StdinTeleop()
    try:
        infer.run(seconds=args.seconds, save_path=args.save_obs, teleop=teleop,
                  video=video)
    finally:
        if teleop is not None:
            teleop.close()
        if video is not None and video.frames:
            video.save(args.render)


if __name__ == "__main__":
    main()
