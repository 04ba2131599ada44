"""Joystick-command walking task, batched over envs.

Counterpart of the JAX package's ``envs/joystick.py``: the same config keys,
observation layout (101-d actor / 212-d critic), reward terms and scales,
action/IMU delays, random pushes, command resampling and termination rule.
Every state tensor has a leading env dim; every draw comes from a
``torch.Generator`` (the env's own, or the one passed to reset).

Reference quirks kept on purpose, as in the JAX package:
- the +1.3 m/s^2 accelerometer x-bias is a discarded no-op in training, so
  it is not applied;
- one noise draw serves the gravity noise and the IMU-delay index;
- ``stand_still`` uses ignore_head=False.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Union

import torch

from duckbench.ref.envs import base as duck_base
from duckbench.ref.envs import rewards as rw
from duckbench.ref.envs.gait_clock import phase_frequency_from_command
from duckbench.ref.envs.imitation import reward_imitation
from duckbench.ref.envs.reference_motion import PolyReferenceMotion
from duckbench.ref.envs.types import State
from duckbench.ref.models.open_duck_mini_v2 import constants
from duckbench.ref.ops.types import Data, Model
from duckbench.ref.utils.config import Config

USE_IMITATION_REWARD = True
USE_MOTOR_SPEED_LIMITS = True


def default_config() -> Config:
    return Config(
        ctrl_dt=0.02,
        sim_dt=0.002,
        episode_length=1000,
        action_repeat=1,
        action_scale=0.25,
        dof_vel_scale=0.05,
        history_len=0,
        soft_joint_pos_limit_factor=0.95,
        max_motor_velocity=5.24,  # rad/s
        noise_config=dict(
            level=1.0,
            action_min_delay=0,  # env steps
            action_max_delay=3,
            imu_min_delay=0,
            imu_max_delay=3,
            scales=dict(
                hip_pos=0.03,
                knee_pos=0.05,
                ankle_pos=0.08,
                joint_vel=2.5,
                gravity=0.1,
                linvel=0.1,
                gyro=0.1,
                accelerometer=0.05,
            ),
        ),
        reward_config=dict(
            scales=dict(
                tracking_lin_vel=2.5,
                tracking_ang_vel=6.0,
                torques=-1.0e-3,
                action_rate=-0.5,
                stand_still=-0.2,
                alive=20.0,
                imitation=1.0,
            ),
            tracking_sigma=0.01,
        ),
        push_config=dict(
            enable=True,
            interval_range=[5.0, 10.0],
            magnitude_range=[0.1, 1.0],
        ),
        # gait-clock conditioning; the defaults keep the reference's integer
        # clock (factor 1.0)
        phase_frequency_range=[1.0, 1.0],
        phase_frequency_vx_ref=0.0,
        phase_frequency_max=1.4,
        lin_vel_x=[-0.15, 0.15],
        lin_vel_y=[-0.2, 0.2],
        ang_vel_yaw=[-1.0, 1.0],
        neck_pitch_range=[-0.34, 1.1],
        head_pitch_range=[-0.78, 0.78],
        head_yaw_range=[-1.5, 1.5],
        head_roll_range=[-0.5, 0.5],
        head_range_factor=1.0,
    )


class Joystick(duck_base.OpenDuckMiniV2Env):
    """Track a joystick command (vx, vy, wz, 4 head joint targets)."""

    def __init__(
        self,
        task: str = "flat_terrain",
        config: Optional[Config] = None,
        config_overrides: Optional[Dict[str, Union[str, int, list]]] = None,
        device: Union[str, torch.device] = "cuda",
        seed: int = 0,
    ):
        super().__init__(
            xml_path=constants.task_to_xml(task),
            config=config or default_config(),
            config_overrides=config_overrides,
            device=device,
            seed=seed,
        )
        self._post_init()

    def _post_init(self) -> None:
        self._task_tables()
        if USE_IMITATION_REWARD:
            self.PRM = PolyReferenceMotion(constants.reference_motion_path(), device=self.device)

    # ------------------------------------------------------------------
    def reset_with_model(self, model: Model, num_envs: int,
                         generator: Optional[torch.Generator] = None) -> State:
        g = generator if generator is not None else self.generator
        B, dev = num_envs, self.device
        qpos, qvel = self._jitter_reset(model, B, g)
        ctrl = self.get_actuator_joints_qpos(qpos)
        data = self.physics_init(model, qpos, qvel, ctrl)

        cmd = self.sample_command(B, g)
        fr = tuple(self._config.phase_frequency_range)
        if fr != (1.0, 1.0):
            imitation_freq = self._uniform((B,), fr[0], fr[1], g)
        else:
            imitation_freq = torch.ones(B, device=dev)
        info = self._base_info(model, B, cmd, g)

        if USE_IMITATION_REWARD:
            current_reference_motion = self.PRM.get_reference_motion(
                cmd[:, 0], cmd[:, 1], cmd[:, 2], 0)
        else:
            current_reference_motion = torch.zeros(B, 0, device=dev)
        info.update({
            "imitation_i": torch.zeros(B, device=dev),
            "imitation_freq": imitation_freq,
            "current_reference_motion": current_reference_motion,
            "imitation_phase": torch.zeros(B, 2, device=dev),
        })

        contact = self._feet_contact(model, data)
        obs = self._get_obs(data, info, contact, g)
        return State(data, obs, torch.zeros(B, device=dev), torch.zeros(B, device=dev),
                     self._zero_metrics(B), info)

    # ------------------------------------------------------------------
    def step_with_model(self, model: Model, state: State, action: torch.Tensor) -> State:
        g = self.generator
        info = dict(state.info)
        B = action.shape[0]

        if USE_IMITATION_REWARD:
            freq = info["imitation_freq"] * phase_frequency_from_command(
                info["command"][:, 0],
                float(self._config.phase_frequency_vx_ref),
                float(self._config.phase_frequency_max),
            )
            imitation_i = torch.remainder(info["imitation_i"] + freq,
                                          self.PRM.nb_steps_in_period)
            info["imitation_i"] = imitation_i
            phase = (imitation_i / self.PRM.nb_steps_in_period) * 2 * math.pi
            info["imitation_phase"] = torch.stack([torch.cos(phase), torch.sin(phase)], dim=1)
            cmd = info["command"]
            info["current_reference_motion"] = self.PRM.get_reference_motion(
                cmd[:, 0], cmd[:, 1], cmd[:, 2], imitation_i)
        else:
            info["imitation_i"] = torch.zeros(B, device=self.device)
            info["current_reference_motion"] = torch.zeros(B, 0, device=self.device)

        # action delay (a uniform random slot of the rolled history), then the
        # random push
        action_w_delay = self._delayed_action(info, action, g)
        data, push = self._push(state.data, info, g)

        motor_targets = self._default_actuator + action_w_delay * self._config.action_scale
        if USE_MOTOR_SPEED_LIMITS:
            prev = info["motor_targets"]
            lim = self._config.max_motor_velocity * self.dt
            motor_targets = torch.clamp(motor_targets, prev - lim, prev + lim)

        data = self.physics_step(model, data, motor_targets)
        info["motor_targets"] = motor_targets

        contact, first_contact = self._feet_update(model, data, info)
        obs = self._get_obs(data, info, contact, g)
        done = self._get_termination(data)
        rewards = self._get_reward(data, action, info, done, first_contact, contact)
        return self._finish_step(state, data, obs, done, rewards, info, action, push,
                                 contact, g)

    # ------------------------------------------------------------------
    def _get_obs(self, data: Data, info: Dict[str, Any], contact: torch.Tensor,
                 g: torch.Generator):
        # the reference's +1.3 accelerometer x-bias is a discarded no-op; not
        # applied
        r = self._readings(data, info, g)
        linvel = self.get_local_linvel(data)
        contact_f = contact.to(torch.float32)

        state = torch.cat(
            [
                r["noisy_gyro"],  # 3
                r["noisy_accelerometer"],  # 3
                info["command"],  # 7
                r["noisy_joint_angles"] - self._default_actuator,  # 14
                r["noisy_joint_vel"] * self._config.dof_vel_scale,  # 14
                info["last_act"],  # 14
                info["last_last_act"],  # 14
                info["last_last_last_act"],  # 14
                info["motor_targets"],  # 14
                contact_f,  # 2
                info["imitation_phase"],  # 2
            ],
            dim=1,
        )

        privileged_state = torch.cat(
            [
                state,
                r["gyro"],  # 3
                r["accelerometer"],  # 3
                r["gravity"],  # 3
                linvel,  # 3
                self.get_global_angvel(data),  # 3
                r["joint_angles"] - self._default_actuator,  # 14
                r["joint_vel"],  # 14
                r["root_height"],  # 1
                data.actuator_force,  # 14
                contact_f,  # 2
                r["feet_vel"],  # 6
                info["feet_air_time"],  # 2
                info["current_reference_motion"],  # 40
                info["imitation_i"][:, None],  # 1
                info["imitation_phase"],  # 2
            ],
            dim=1,
        )
        return {"state": state, "privileged_state": privileged_state}

    def _get_reward(self, data, action, info, done, first_contact, contact):
        del done, first_contact
        rc = self._config.reward_config
        return {
            "tracking_lin_vel": rw.reward_tracking_lin_vel(
                info["command"], self.get_local_linvel(data), rc.tracking_sigma),
            "tracking_ang_vel": rw.reward_tracking_ang_vel(
                info["command"], self.get_gyro(data), rc.tracking_sigma),
            "torques": rw.cost_torques(data.actuator_force),
            "action_rate": rw.cost_action_rate(action, info["last_act"]),
            "alive": rw.reward_alive(action.shape[0], self.device),
            "imitation": reward_imitation(
                self.get_floating_base_qpos(data.qpos),
                self.get_floating_base_qvel(data.qvel),
                self.get_actuator_joints_qpos(data.qpos),
                self.get_actuator_joints_qvel(data.qvel),
                contact,
                info["current_reference_motion"],
                info["command"],
                USE_IMITATION_REWARD,
            ),
            "stand_still": rw.cost_stand_still(
                info["command"],
                self.get_actuator_joints_qpos(data.qpos),
                self.get_actuator_joints_qvel(data.qvel),
                self._default_actuator,
                ignore_head=False,
            ),
        }

    def sample_command(self, num_envs: int, g: torch.Generator) -> torch.Tensor:
        cfg = self._config
        f = cfg.head_range_factor
        B = num_envs
        cols = [
            self._uniform((B,), cfg.lin_vel_x[0], cfg.lin_vel_x[1], g),
            self._uniform((B,), cfg.lin_vel_y[0], cfg.lin_vel_y[1], g),
            self._uniform((B,), cfg.ang_vel_yaw[0], cfg.ang_vel_yaw[1], g),
        ]
        zero_cmd = self._rand((B,), g) < 0.1
        for r in (cfg.neck_pitch_range, cfg.head_pitch_range, cfg.head_yaw_range,
                  cfg.head_roll_range):
            cols.append(self._uniform((B,), r[0] * f, r[1] * f, g))
        cmd = torch.stack(cols, dim=1)
        return torch.where(zero_cmd[:, None], torch.zeros_like(cmd), cmd)
