"""Terminal keyboard teleop for the sim-to-sim harnesses.

The reference drives commands through mujoco.viewer's key callback
(open_duck_mini_v2/mujoco_infer.py:105-154); without a window the same
key map reads raw keys from the terminal instead (cbreak mode,
non-blocking):

  arrows      vx / vy (or head pitch/yaw when head mode is on)
  a / e       turn left / right (wz)
  h           toggle head-control mode
  p / m       gait phase frequency +/- 0.1
  0           zero all commands
"""

from __future__ import annotations

import os
import select
import sys

COMMANDS_RANGE_X = [-0.15, 0.15]
COMMANDS_RANGE_Y = [-0.2, 0.2]
COMMANDS_RANGE_THETA = [-1.0, 1.0]
HEAD_RANGE_PITCH = [-0.34, 1.1]
HEAD_RANGE_YAW = [-1.0, 1.0]


class StdinTeleop:
    def __init__(self):
        self._fd = sys.stdin.fileno()
        self._old = None
        if os.isatty(self._fd):
            import termios
            import tty

            self._termios = termios
            self._old = termios.tcgetattr(self._fd)
            tty.setcbreak(self._fd)
        self.head_mode = False

    def close(self):
        if self._old is not None:
            self._termios.tcsetattr(
                self._fd, self._termios.TCSADRAIN, self._old)

    def _read_key(self):
        if not select.select([sys.stdin], [], [], 0)[0]:
            return None
        ch = sys.stdin.read(1)
        if ch == "\x1b":  # escape sequence (arrows)
            if select.select([sys.stdin], [], [], 0)[0]:
                ch2 = sys.stdin.read(1)
                if ch2 == "[" and select.select([sys.stdin], [], [], 0)[0]:
                    return {"A": "up", "B": "down", "C": "right",
                            "D": "left"}.get(sys.stdin.read(1))
            return None
        return ch

    def poll(self, host) -> None:
        """Apply pending keys to host.commands (7-d joystick layout)."""
        while (key := self._read_key()) is not None:
            c = list(host.commands)
            if key == "h":
                self.head_mode = not self.head_mode
                print(f"head mode: {self.head_mode}")
            elif key == "p":
                host.phase_frequency_factor += 0.1
            elif key == "m":
                host.phase_frequency_factor -= 0.1
            elif key == "0":
                c = [0.0] * 7
            elif not self.head_mode:
                if key == "up":
                    c[0] = min(c[0] + 0.05, COMMANDS_RANGE_X[1])
                elif key == "down":
                    c[0] = max(c[0] - 0.05, COMMANDS_RANGE_X[0])
                elif key == "left":
                    c[1] = min(c[1] + 0.05, COMMANDS_RANGE_Y[1])
                elif key == "right":
                    c[1] = max(c[1] - 0.05, COMMANDS_RANGE_Y[0])
                elif key == "a":
                    c[2] = min(c[2] + 0.1, COMMANDS_RANGE_THETA[1])
                elif key == "e":
                    c[2] = max(c[2] - 0.1, COMMANDS_RANGE_THETA[0])
            else:
                if key == "up":
                    c[4] = min(c[4] + 0.1, HEAD_RANGE_PITCH[1])
                elif key == "down":
                    c[4] = max(c[4] - 0.1, HEAD_RANGE_PITCH[0])
                elif key == "left":
                    c[5] = min(c[5] + 0.1, HEAD_RANGE_YAW[1])
                elif key == "right":
                    c[5] = max(c[5] - 0.1, HEAD_RANGE_YAW[0])
            host.commands = c
