"""Reference-gait playback (parity with reference ref_motion_viewer.py).

Kinematically replays the polynomial gait library by writing reference
joint targets into the `home` keyframe's qpos for each 50 Hz tick and
running forward kinematics. The reference uses the interactive MuJoCo
viewer (+ optional pygame joysticks); headless, playback renders the foot
trajectories to a PNG (--out, matplotlib), an offscreen MuJoCo video
(--render), and --print dumps per-tick foot positions.

The port's playback runs the kinematics on `device` (the card unless given
``--device cpu``): the ticks' qpos are stacked into one (T, nq) batch and go
through ``ops/smooth.py``'s ``kinematics`` and ``site_kinematics`` on the
model there, with one host copy of the feet at the end. ``--viewer`` is the
live passive-viewer playback (``mujoco``, a display; ``--joystick`` adds
pygame sticks). matplotlib, ``mujoco`` (with PIL or OpenCV for the video)
and pygame are imported only by the options that use them.

Usage:
  python -m open_duck_playground_tpu_torch.deploy.ref_motion_viewer \
      [--command dx dy dtheta] [--periods 3] [--out ref_motion.png] \
      [--render ref_motion.gif] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
from typing import Union

import numpy as np
import torch

from open_duck_playground_tpu_torch.deploy.poly_reference_motion_numpy import (
    PolyReferenceMotion,
)
from open_duck_playground_tpu_torch.mjcf import compile_mjcf
from open_duck_playground_tpu_torch.models.open_duck_mini_v2 import constants
from open_duck_playground_tpu_torch.ops import smooth

# reference joint frame indices 0..15 map to the 14 actuators by name order
# (left leg 5, neck/head 4, right leg 5; the 2 antenna slots, ref dims 9 and
# 10, are dropped)
REF_TO_ACT = [0, 1, 2, 3, 4, 5, 6, 7, 8, 11, 12, 13, 14, 15]


def playback(command=(0.1, 0.0, 0.0), periods=3, out="ref_motion.png",
             verbose=False, render=None, device: Union[str, torch.device] = "cuda"):
    """Replay `periods` gait periods at `command`; returns the feet's
    world positions per tick, (T, 6) float64: left xyz, right xyz."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: playback runs on the card unless given "
                           "device='cpu'")
    prm = PolyReferenceMotion(constants.reference_motion_path())
    xml = constants.task_to_xml("flat_terrain")
    model = compile_mjcf(xml)
    video = None
    if render:
        from open_duck_playground_tpu_torch.deploy.render import MjVideoRenderer

        video = MjVideoRenderer(xml)

    act_qpos_addr = [int(model.jnt_qposadr.np[model.joint(n)])
                     for n in model.names.list("actuator")]
    n = prm.nb_steps_in_period * periods
    qpos = np.tile(np.asarray(model.keyframe("home").qpos, np.float64), (n, 1))
    for i in range(n):
        qpos[i, act_qpos_addr] = prm.get_reference_motion(*command, i)[REF_TO_ACT]

    m = model.to(dev)
    xpos, xquat, _, _, _ = smooth.kinematics(
        m, torch.as_tensor(qpos, dtype=torch.float32, device=dev))
    site_xpos, _ = smooth.site_kinematics(m, xpos, xquat)
    feet = smooth.index([model.site(s) for s in constants.FEET_SITES], dev)
    foot_traj = site_xpos[:, feet].reshape(n, 6).cpu().numpy().astype(np.float64)

    for i in range(n):
        if video is not None and i % 2 == 0:  # 50 Hz -> 25 fps
            video.add_qpos_frame(qpos[i])
        if verbose:
            print(f"i={i:3d} Lfoot={np.round(foot_traj[i, :3], 3)} "
                  f"Rfoot={np.round(foot_traj[i, 3:], 3)}")
    if video is not None and video.frames:
        video.save(render)
    if out:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, 2, figsize=(10, 4))
        axes[0].plot(foot_traj[:, 2], label="left foot z")
        axes[0].plot(foot_traj[:, 5], label="right foot z")
        axes[0].set_xlabel("tick")
        axes[0].legend()
        axes[1].plot(foot_traj[:, 0], foot_traj[:, 1], label="left foot xy")
        axes[1].plot(foot_traj[:, 3], foot_traj[:, 4], label="right foot xy")
        axes[1].legend()
        fig.suptitle(f"reference gait, cmd={command}")
        fig.tight_layout()
        fig.savefig(out, dpi=110)
        print(f"wrote {out}")
    return foot_traj


def live_view(command=(0.1, 0.0, 0.0), joystick=False, launch=None,
              pygame_module=None, max_seconds=None):
    """Live gait playback in a passive mujoco.viewer window with optional
    dual pygame joystick command input (reference ref_motion_viewer.py:
    67-86, 141-161, 176-207). Kinematic: reference joint targets are
    written into qpos each 50 Hz tick and mj_forward'd — no dynamics."""
    import time

    import mujoco

    from open_duck_playground_tpu_torch.deploy.mujoco_infer_base import load_mj_model
    from open_duck_playground_tpu_torch.deploy.viewer import PygameJoystickTeleop

    if launch is None:
        import mujoco.viewer

        launch = mujoco.viewer.launch_passive
    prm = PolyReferenceMotion(constants.reference_motion_path())
    model = load_mj_model(constants.task_to_xml("flat_terrain"))
    data = mujoco.MjData(model)
    kid = mujoco.mj_name2id(model, mujoco.mjtObj.mjOBJ_KEY, "home")
    mujoco.mj_resetDataKeyframe(model, data, kid)

    command = list(command)
    sticks = PygameJoystickTeleop(command, pygame_module) if joystick else None
    act_qpos_addr = [
        model.jnt_qposadr[mujoco.mj_name2id(model, mujoco.mjtObj.mjOBJ_JOINT,
                                            mujoco.mj_id2name(
                                                model, mujoco.mjtObj.mjOBJ_ACTUATOR, a))]
        for a in range(model.nu)
    ]
    i, ticks = 0, 0
    with launch(model, data) as viewer:
        while viewer.is_running():
            t0 = time.perf_counter()
            if sticks is not None:
                sticks.poll()
            frame = prm.get_reference_motion(*command, i)
            for k, a in enumerate(REF_TO_ACT):
                data.qpos[act_qpos_addr[k]] = frame[a]
            mujoco.mj_forward(model, data)
            viewer.sync()
            i = (i + 1) % prm.nb_steps_in_period
            ticks += 1
            if max_seconds is not None and ticks >= int(max_seconds * 50):
                break
            leftover = 0.02 - (time.perf_counter() - t0)
            if leftover > 0:
                time.sleep(leftover)
    return ticks


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--command", type=float, nargs=3, default=[0.1, 0.0, 0.0])
    parser.add_argument("--periods", type=int, default=3)
    parser.add_argument("--out", type=str, default="ref_motion.png")
    parser.add_argument("--print", dest="verbose", action="store_true")
    parser.add_argument("--render", type=str, default=None,
                        help="also write a .gif/.mp4 of the playback (EGL)")
    parser.add_argument("--viewer", action="store_true",
                        help="live mujoco.viewer playback (needs a display)")
    parser.add_argument("--joystick", action="store_true",
                        help="pygame joystick command input (with --viewer)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="where playback runs the kinematics: 'cuda' or 'cpu'")
    args = parser.parse_args(argv)
    if args.viewer:
        live_view(tuple(args.command), joystick=args.joystick)
        return
    playback(tuple(args.command), args.periods, args.out, args.verbose,
             args.render, args.device)


if __name__ == "__main__":
    main()
