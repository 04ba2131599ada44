"""Standing / head-tracking task, batched over envs.

Counterpart of the JAX package's ``envs/standing.py``: the same config keys,
observation layout (85-d actor / 153-d critic), reward terms and scales,
action/IMU delays, random pushes, command resampling and termination rule.
Differences from Joystick, as in the reference: the rewards are
orientation, torques, action_rate, stand_still (ignore_head), alive and
head_pos; no imitation reward (an empty reference-motion slot); no motor
speed limit; locomotion commands are 0; gyro / accelerometer noise scales
0.05 / 0.005; head_yaw range +-2.7.

Reference quirks kept on purpose, as in the JAX package:
- ``cost_orientation`` reads the gravity sensor (the upvector), not the
  torso z-axis;
- ``cost_head_pos`` is gated on a locomotion command, which standing never
  samples, so it is 0 in training.
Every draw goes through ``parallel.dist.draw`` (the base's helpers), so the
sharded trainer takes this task unchanged.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from open_duck_playground_tpu_torch.envs import base as duck_base
from open_duck_playground_tpu_torch.envs import rewards as rw
from open_duck_playground_tpu_torch.envs.types import State
from open_duck_playground_tpu_torch.models.open_duck_mini_v2 import constants
from open_duck_playground_tpu_torch.ops.types import Data, Model
from open_duck_playground_tpu_torch.utils.config import Config


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
                gyro=0.05,
                accelerometer=0.005,
            ),
        ),
        reward_config=dict(
            scales=dict(
                orientation=-0.5,
                torques=-1.0e-3,
                action_rate=-0.375,
                stand_still=-0.3,
                alive=20.0,
                head_pos=-2.0,
            ),
            tracking_sigma=0.01,
        ),
        push_config=dict(
            enable=True,
            interval_range=[5.0, 10.0],
            magnitude_range=[0.1, 1.0],
        ),
        neck_pitch_range=[-0.34, 1.1],
        head_pitch_range=[-0.78, 0.78],
        head_yaw_range=[-2.7, 2.7],
        head_roll_range=[-0.5, 0.5],
        head_range_factor=1.0,
    )


class Standing(duck_base.OpenDuckMiniV2Env):
    """Stand still while tracking head-joint commands."""

    def __init__(
        self,
        task: str = "flat_terrain",
        config: Optional[Config] = None,
        config_overrides: Optional[Dict[str, Union[str, int, list]]] = None,
        device: Union[str, torch.device] = "cuda",
        seed: int = 0,
        physics: str = "kernel",
    ):
        super().__init__(
            xml_path=constants.task_to_xml(task),
            config=config or default_config(),
            config_overrides=config_overrides,
            device=device,
            seed=seed,
            physics=physics,
        )
        self._task_tables()

    # ------------------------------------------------------------------
    def reset_with_model(self, model: Model, num_envs: int,
                         generator: Optional[torch.Generator] = None) -> State:
        g = generator if generator is not None else self.generator
        B, dev = num_envs, self.device
        qpos, qvel = self._jitter_reset(model, B, g)
        ctrl = self.get_actuator_joints_qpos(qpos)
        data = self.physics_init(model, qpos, qvel, ctrl)

        cmd = self.sample_command(B, g)
        info = self._base_info(model, B, cmd, g)
        info.update({
            "imitation_i": torch.zeros(B, dtype=torch.int32, device=dev),
            "current_reference_motion": torch.zeros(B, 0, device=dev),
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

        action_w_delay = self._delayed_action(info, action, g)
        data, push = self._push(state.data, info, g)
        # no motor speed limit (unlike Joystick)
        motor_targets = self._default_actuator + action_w_delay * self._config.action_scale
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
        r = self._readings(data, info, g)
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
                contact_f,  # 2
                info["current_reference_motion"],  # 0
            ],
            dim=1,
        )
        privileged_state = torch.cat(
            [
                state,
                r["gyro"],  # 3
                r["accelerometer"],  # 3
                r["gravity"],  # 3
                self.get_local_linvel(data),  # 3
                self.get_global_angvel(data),  # 3
                r["joint_angles"] - self._default_actuator,  # 14
                r["joint_vel"],  # 14
                r["root_height"],  # 1
                data.actuator_force,  # 14
                contact_f,  # 2
                r["feet_vel"],  # 6
                info["feet_air_time"],  # 2
                info["current_reference_motion"],  # 0
            ],
            dim=1,
        )
        return {"state": state, "privileged_state": privileged_state}

    def _get_reward(self, data, action, info, done, first_contact, contact):
        del done, first_contact, contact
        joints_qpos = self.get_actuator_joints_qpos(data.qpos)
        joints_qvel = self.get_actuator_joints_qvel(data.qvel)
        return {
            "orientation": rw.cost_orientation(self.get_gravity(data)),
            "torques": rw.cost_torques(data.actuator_force),
            "action_rate": rw.cost_action_rate(action, info["last_act"]),
            "alive": rw.reward_alive(action.shape[0], self.device),
            "stand_still": rw.cost_stand_still(info["command"], joints_qpos, joints_qvel,
                                               self._default_actuator, ignore_head=True),
            "head_pos": rw.cost_head_pos(joints_qpos, joints_qvel, info["command"]),
        }

    def sample_command(self, num_envs: int, g: torch.Generator) -> torch.Tensor:
        """A zero command with p=0.1, else [0, 0, 0, neck_pitch, head_pitch,
        head_yaw, head_roll] over the config's ranges times
        head_range_factor."""
        cfg = self._config
        f = cfg.head_range_factor
        B = num_envs
        zero_cmd = self._rand((B,), g) < 0.1
        cols = [torch.zeros(B, device=self.device)] * 3
        for r in (cfg.neck_pitch_range, cfg.head_pitch_range, cfg.head_yaw_range,
                  cfg.head_roll_range):
            cols.append(self._uniform((B,), r[0] * f, r[1] * f, g))
        cmd = torch.stack(cols, dim=1)
        return torch.where(zero_cmd[:, None], torch.zeros_like(cmd), cmd)
