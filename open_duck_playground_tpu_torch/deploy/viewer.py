"""Live interactive deploy surfaces: mujoco.viewer window + pygame joysticks.

Parity targets:
  - the reference's interactive sim2sim loop — a passive mujoco.viewer
    window with GLFW keyboard teleop and real-time pacing
    (open_duck_mini_v2/mujoco_infer.py:156-241)
  - the reference gait viewer's dual pygame joystick command input
    (open_duck_mini_v2/ref_motion_viewer.py:67-86,
    141-161)

Both need hardware a CI image lacks (a display / joysticks), so every
entry point takes injectable handles (`launch`, `pygame_module`) and the
logic is covered by fakes in tests/test_torch_tools.py; on a workstation the
real window and sticks work with no extra flags beyond --viewer /
--joystick.
"""

from __future__ import annotations

import time

import numpy as np

# command ranges (reference joystick.py:94-101 / mujoco_infer.py:24-31)
COMMANDS_RANGE_X = [-0.15, 0.15]
COMMANDS_RANGE_Y = [-0.2, 0.2]
COMMANDS_RANGE_THETA = [-1.0, 1.0]
NECK_PITCH_RANGE = [-0.34, 1.1]
HEAD_PITCH_RANGE = [-0.78, 0.78]
HEAD_YAW_RANGE = [-1.5, 1.5]
HEAD_ROLL_RANGE = [-0.5, 0.5]

# GLFW keycodes as the reference's key_callback receives them
# (mujoco_infer.py:105-154)
_KEY_UP, _KEY_DOWN, _KEY_LEFT, _KEY_RIGHT = 265, 264, 263, 262
_KEY_A, _KEY_E, _KEY_H, _KEY_P, _KEY_M = 81, 69, 72, 80, 59


class ViewerKeyTeleop:
    """mujoco.viewer key_callback with the reference's exact semantics:
    a pressed key SETS the command to its range extreme, any other key
    press resets the locomotion commands to zero (reference
    mujoco_infer.py:105-154 rebuilds commands[0:3] on every callback)."""

    def __init__(self, host):
        self.host = host
        self.head_control_mode = False

    def __call__(self, keycode: int) -> None:
        host = self.host
        if keycode == _KEY_H:
            self.head_control_mode = not self.head_control_mode
        lin_vel_x = lin_vel_y = ang_vel = 0.0
        if not self.head_control_mode:
            if keycode == _KEY_UP:
                lin_vel_x = COMMANDS_RANGE_X[1]
            if keycode == _KEY_DOWN:
                lin_vel_x = COMMANDS_RANGE_X[0]
            if keycode == _KEY_LEFT:
                lin_vel_y = COMMANDS_RANGE_Y[1]
            if keycode == _KEY_RIGHT:
                lin_vel_y = COMMANDS_RANGE_Y[0]
            if keycode == _KEY_A:
                ang_vel = COMMANDS_RANGE_THETA[1]
            if keycode == _KEY_E:
                ang_vel = COMMANDS_RANGE_THETA[0]
            if keycode == _KEY_P:
                host.phase_frequency_factor += 0.1
            if keycode == _KEY_M:
                host.phase_frequency_factor -= 0.1
        else:
            neck_pitch = head_pitch = head_yaw = head_roll = 0.0
            if keycode == _KEY_UP:
                head_pitch = NECK_PITCH_RANGE[1]
            if keycode == _KEY_DOWN:
                head_pitch = NECK_PITCH_RANGE[0]
            if keycode == _KEY_LEFT:
                head_yaw = HEAD_YAW_RANGE[1]
            if keycode == _KEY_RIGHT:
                head_yaw = HEAD_YAW_RANGE[0]
            if keycode == _KEY_A:
                head_roll = HEAD_ROLL_RANGE[1]
            if keycode == _KEY_E:
                head_roll = HEAD_ROLL_RANGE[0]
            host.commands[3] = neck_pitch
            host.commands[4] = head_pitch
            host.commands[5] = head_yaw
            host.commands[6] = head_roll
        host.commands[0] = lin_vel_x
        host.commands[1] = lin_vel_y
        host.commands[2] = ang_vel


class PygameJoystickTeleop:
    """Dual-joystick command input (reference ref_motion_viewer.py:67-86,
    141-161): stick 1 left axes -> vx/vy, stick 2 axis 0 -> wz.

    `pygame_module` is injectable for tests; command is any mutable
    sequence with at least 3 slots (the gait viewer's dx/dy/dtheta or a
    policy host's 7-d commands list).
    """

    def __init__(self, command, pygame_module=None):
        self.command = command
        self.pg = pygame_module
        if self.pg is None:
            import pygame

            self.pg = pygame
        self.joystick1 = self.joystick2 = None
        self.pg.init()
        self.pg.joystick.init()
        if self.pg.joystick.get_count() > 0:
            self.joystick1 = self.pg.joystick.Joystick(0)
            self.joystick1.init()
            for i in range(3):
                self.command[i] = 0.0
            print("Joystick initialized:", self.joystick1.get_name())
            if self.pg.joystick.get_count() > 1:
                self.joystick2 = self.pg.joystick.Joystick(1)
                self.joystick2.init()
                print("Joystick 2 (theta) initialized:",
                      self.joystick2.get_name())
            else:
                print("Only one joystick detected; theta via second joystick "
                      "will be disabled.")
        else:
            print("No joystick found!")

    def poll(self, host=None) -> None:
        if self.joystick1 is None:
            return
        self.pg.event.pump()
        joy_y = self.joystick1.get_axis(1)
        joy_x = self.joystick1.get_axis(0)
        joy_z = self.joystick2.get_axis(0) if self.joystick2 is not None else 0.0
        # reference's asymmetric-range mapping (ref_motion_viewer.py:146-155)
        if joy_y < 0:
            lin_vel_x = (-joy_y) * COMMANDS_RANGE_X[1]
        else:
            lin_vel_x = -joy_y * abs(COMMANDS_RANGE_X[0])
        self.command[0] = lin_vel_x
        self.command[1] = -joy_x * COMMANDS_RANGE_Y[1]
        self.command[2] = -joy_z * COMMANDS_RANGE_THETA[1]


def run_viewer(host, save_path: str = "mujoco_saved_obs.pkl",
               max_seconds: float | None = None, launch=None,
               joystick=None) -> list:
    """Interactive policy rollout in a passive mujoco.viewer window.

    Real-time paced at the 50 Hz control rate; closes when the window
    closes (or after max_seconds, for tests). `launch` defaults to
    mujoco.viewer.launch_passive and is injectable for headless tests.
    """
    if launch is None:
        import mujoco.viewer

        launch = mujoco.viewer.launch_passive
    teleop = ViewerKeyTeleop(host)
    ctrl_dt = host.sim_dt * host.decimation
    ticks = 0
    with launch(host.model, host.data, key_callback=teleop) as viewer:
        while viewer.is_running():
            t0 = time.perf_counter()
            if joystick is not None:
                joystick.poll(host)
            targets = host.control_step()
            host.step_control(targets)
            viewer.sync()
            ticks += 1
            if max_seconds is not None and ticks >= int(max_seconds * 50):
                break
            leftover = ctrl_dt - (time.perf_counter() - t0)
            if leftover > 0:
                time.sleep(leftover)
    if save_path:
        import pickle

        with open(save_path, "wb") as f:
            pickle.dump(host.saved_obs, f)
        print(f"saved {len(host.saved_obs)} obs to {save_path}")
    return host.saved_obs
