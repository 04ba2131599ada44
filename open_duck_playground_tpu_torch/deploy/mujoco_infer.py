"""Sim-to-sim policy validation in the MuJoCo C engine.

Parity with the reference's mujoco_infer.py (open_duck_mini_v2/
mujoco_infer.py:156-241): the exported ONNX policy, trained on the port's
own physics, rolls out in CPU MuJoCo with clean observations, the same
50 Hz control / 500 Hz physics decimation, action scaling and motor
speed-limit clamping. MuJoCo is an engine this project did not write, so a
policy that walks here validates the training physics end to end. Needs
the ``mujoco`` package.

Headless by default; `--interactive` enables terminal keyboard teleop
(same key map as the reference's viewer callback, deploy/teleop.py);
`--viewer` opens the live mujoco.viewer window (a display; `--joystick`
adds pygame sticks, deploy/viewer.py); `--render` records an offscreen
video (deploy/render.py, PIL or OpenCV).

Usage:
  python -m open_duck_playground_tpu_torch.deploy.mujoco_infer -o policy.onnx \
      [--task flat_terrain_backlash] [--standing] [--seconds 10] \
      [--command vx vy wz np hp hy hr] [--interactive] \
      [--viewer [--joystick]] [--render rollout.gif]
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from open_duck_playground_tpu_torch.deploy.mujoco_infer_base import MJInferBase
from open_duck_playground_tpu_torch.deploy.policy_loop import PolicyLoopMixin
from open_duck_playground_tpu_torch.models.open_duck_mini_v2 import constants


class MjInfer(PolicyLoopMixin, MJInferBase):
    def __init__(self, model_path: str, reference_data: str,
                 onnx_model_path: str, standing: bool = False):
        MJInferBase.__init__(self, model_path)
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
    parser.add_argument("--viewer", action="store_true",
                        help="live mujoco.viewer window with GLFW keyboard "
                             "teleop (reference mujoco_infer.py:156-241); "
                             "needs a display")
    parser.add_argument("--joystick", action="store_true",
                        help="pygame joystick command input (with --viewer)")
    parser.add_argument("--save_obs", type=str, default="mujoco_saved_obs.pkl")
    parser.add_argument("--render", type=str, default=None,
                        help="record the rollout to a .gif/.mp4 (EGL offscreen)")
    args = parser.parse_args(argv)

    model_path = args.model_path or constants.task_to_xml(args.task)
    reference_data = args.reference_data or constants.reference_motion_path()
    infer = MjInfer(model_path, reference_data, args.onnx_model_path, args.standing)
    infer.commands = list(args.command)
    if args.viewer:
        from open_duck_playground_tpu_torch.deploy.viewer import (
            PygameJoystickTeleop, run_viewer)

        joystick = PygameJoystickTeleop(infer.commands) if args.joystick else None
        run_viewer(infer, save_path=args.save_obs, joystick=joystick)
        return
    video = None
    if args.render:
        from open_duck_playground_tpu_torch.deploy.render import MjVideoRenderer

        video = MjVideoRenderer(model_path)
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
