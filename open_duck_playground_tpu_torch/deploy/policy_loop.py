"""Engine-agnostic 50 Hz policy control loop for sim-to-sim validation.

Shared by deploy/sim_infer.py (the port's own engine: its fused physics
step at one env) and deploy/mujoco_infer.py (the MuJoCo C engine), so the
observation layout, action scaling, speed-limit clamping and obs-trace
saving are the same loop the reference runs (mujoco_infer.py:156-241):
only the physics underneath differs.

The host provides the accessor API of SimInferBase / MJInferBase:
  data, the ``qpos`` property (numpy), get_actuator_joints_qpos(data.qpos),
  get_actuator_joints_qvel(data.qvel), get_gyro / get_accelerometer /
  get_gravity / get_feet_contacts (numpy), default_actuator,
  motor_targets / prev_motor_targets, num_dofs, sim_dt, decimation and
  step_control().
"""

from __future__ import annotations

import pickle

import numpy as np

from open_duck_playground_tpu_torch.envs.gait_clock import phase_frequency_from_command

USE_MOTOR_SPEED_LIMITS = True  # reference joystick.py:46


class PolicyLoopMixin:
    """Policy inference + control-loop logic over an engine base class."""

    def init_policy_loop(self, reference_data, onnx_model_path, standing):
        from open_duck_playground_tpu_torch.deploy.poly_reference_motion_numpy import (
            PolyReferenceMotion,
        )
        from open_duck_playground_tpu_torch.export.onnx_infer import OnnxInfer

        self.standing = standing
        self.dof_vel_scale = 0.05
        self.action_scale = 0.25
        self.max_motor_velocity = 5.24  # rad/s (joystick.py)
        self.phase_frequency_factor = 1.0

        if not self.standing:
            self.PRM = PolyReferenceMotion(reference_data)
        self.policy = OnnxInfer(onnx_model_path, awd=True)
        # command-conditioned gait-clock law, trained in and carried via
        # ONNX metadata (envs/joystick.py phase_frequency_from_command);
        # absent on reference-parity exports -> disabled (factor 1.0)
        md = self.policy.metadata
        self.phase_freq_vx_ref = float(md.get("phase_frequency_vx_ref", 0.0))
        self.phase_freq_max = float(md.get("phase_frequency_max", 1.4))
        if self.phase_freq_vx_ref > 0.0:
            print(f"gait-clock command law from ONNX metadata: "
                  f"clip(|vx|/{self.phase_freq_vx_ref}, 1, {self.phase_freq_max})")

        self.last_action = np.zeros(self.num_dofs)
        self.last_last_action = np.zeros(self.num_dofs)
        self.last_last_last_action = np.zeros(self.num_dofs)
        self.commands = [0.0] * 7
        self.imitation_i = 0.0
        self.imitation_phase = np.array([0.0, 0.0])
        self.saved_obs = []

    def get_obs(self, data, command) -> np.ndarray:
        """Clean actor obs: 101-d joystick (reference mujoco_infer.py:67-103)
        or 85-d standing (standing.py's state: no motor_targets, no
        imitation phase; the reference's own mujoco_infer builds the
        joystick layout even with --standing, which cannot feed the 85-d
        standing policy, so this is fixed rather than mirrored)."""
        gyro = self.get_gyro(data)
        accelerometer = np.array(self.get_accelerometer(data))
        accelerometer[0] += 1.3  # deploy-side IMU bias (mujoco_infer.py:74)
        joint_angles = self.get_actuator_joints_qpos(data.qpos)
        joint_vel = self.get_actuator_joints_qvel(data.qvel)
        contacts = self.get_feet_contacts(data)
        parts = [
            gyro,
            accelerometer,
            command,
            joint_angles - self.default_actuator,
            joint_vel * self.dof_vel_scale,
            self.last_action,
            self.last_last_action,
            self.last_last_last_action,
        ]
        if self.standing:
            parts += [contacts]
        else:
            parts += [self.motor_targets, contacts, self.imitation_phase]
        return np.concatenate(parts)

    def control_step(self) -> np.ndarray:
        """One 50 Hz control tick: obs -> policy -> clamped motor targets."""
        if not self.standing:
            # the one clock law, shared with training (constants from the
            # ONNX metadata)
            cmd_factor = float(phase_frequency_from_command(
                self.commands[0], self.phase_freq_vx_ref, self.phase_freq_max
            ))
            self.imitation_i = (
                self.imitation_i + 1.0 * self.phase_frequency_factor * cmd_factor
            ) % self.PRM.nb_steps_in_period
            phase = self.imitation_i / self.PRM.nb_steps_in_period * 2 * np.pi
            self.imitation_phase = np.array([np.cos(phase), np.sin(phase)])

        obs = self.get_obs(self.data, self.commands)
        self.saved_obs.append(obs)
        action = self.policy.infer(obs.astype(np.float32))

        self.last_last_last_action = self.last_last_action.copy()
        self.last_last_action = self.last_action.copy()
        self.last_action = np.array(action).copy()

        self.motor_targets = (
            self.default_actuator + np.array(action) * self.action_scale
        )
        if USE_MOTOR_SPEED_LIMITS:
            lim = self.max_motor_velocity * (self.sim_dt * self.decimation)
            self.motor_targets = np.clip(
                self.motor_targets,
                self.prev_motor_targets - lim,
                self.prev_motor_targets + lim,
            )
            self.prev_motor_targets = self.motor_targets.copy()
        return self.motor_targets

    def run(self, seconds: float = 10.0, save_path: str = "mujoco_saved_obs.pkl",
            teleop=None, video=None):
        """Roll the policy for `seconds` at 50 Hz. `teleop.poll(self)` runs
        before each tick's obs (it may replace self.commands); `video`
        gets every second tick's qpos (25 fps) through add_qpos_frame,
        from the ``qpos`` property: the tick's one host copy, no second
        device sync (the JAX loop passes np.asarray(self.data.qpos))."""
        n_ticks = int(seconds * 50)
        try:
            for tick in range(n_ticks):
                if teleop is not None:
                    teleop.poll(self)
                targets = self.control_step()
                self.step_control(targets)
                if video is not None and tick % 2 == 0:  # 50 Hz -> 25 fps
                    video.add_qpos_frame(self.qpos)
                up_z = self.get_gravity(self.data)[2]
                if tick % 50 == 0:
                    print(
                        f"t={tick / 50:5.1f}s base_z={float(self.qpos[2]):.3f} "
                        f"up_z={up_z:.2f} cmd={np.round(self.commands, 2)}",
                        flush=True,
                    )
                if up_z < 0:
                    print("robot fell, stopping")
                    break
        except KeyboardInterrupt:
            pass
        if save_path:
            with open(save_path, "wb") as f:
                pickle.dump(self.saved_obs, f)
            print(f"saved {len(self.saved_obs)} obs to {save_path}")
        return self.saved_obs
