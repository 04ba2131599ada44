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

import numpy as np
import torch

from open_duck_playground_tpu_torch.envs import base as duck_base
from open_duck_playground_tpu_torch.envs import rewards as rw
from open_duck_playground_tpu_torch.envs.gait_clock import phase_frequency_from_command
from open_duck_playground_tpu_torch.envs.imitation import reward_imitation
from open_duck_playground_tpu_torch.envs.reference_motion import PolyReferenceMotion
from open_duck_playground_tpu_torch.envs.types import State
from open_duck_playground_tpu_torch.models.open_duck_mini_v2 import constants
from open_duck_playground_tpu_torch.ops import math3d as m3
from open_duck_playground_tpu_torch.ops.types import Data, Model
from open_duck_playground_tpu_torch.parallel.dist import draw
from open_duck_playground_tpu_torch.utils.config import Config

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
        m = self._model
        dev = self.device
        kf = m.keyframe("home")
        self._init_q = torch.tensor(kf.qpos, dtype=torch.float32, device=dev)
        self._default_actuator = torch.tensor(kf.ctrl, dtype=torch.float32, device=dev)

        if USE_IMITATION_REWARD:
            self.PRM = PolyReferenceMotion(constants.reference_motion_path(), device=dev)

        self._site_id = m.site("imu")
        self._feet_site_id = torch.as_tensor([m.site(n) for n in constants.FEET_SITES],
                                             device=dev)
        self._floor_geom_id = m.geom("floor")
        self._feet_geom_id = [m.geom(n) for n in constants.FEET_GEOMS]

        adr = []
        for site in constants.FEET_SITES:
            sid = m.sensor(f"{site}_global_linvel")
            s_adr = int(m.sensor_adr[sid])
            adr.extend(range(s_adr, s_adr + int(m.sensor_dim[sid])))
        self._foot_linvel_sensor_adr = torch.as_tensor(adr, device=dev)

        qpos_noise_scale = np.zeros(m.nu, np.float32)
        joints = constants.JOINTS_ORDER_NO_HEAD
        sc = self._config.noise_config.scales
        qpos_noise_scale[[i for i, j in enumerate(joints) if "_hip" in j]] = sc.hip_pos
        qpos_noise_scale[[i for i, j in enumerate(joints) if "_knee" in j]] = sc.knee_pos
        qpos_noise_scale[[i for i, j in enumerate(joints) if "_ankle" in j]] = sc.ankle_pos
        self._qpos_noise_scale = torch.as_tensor(qpos_noise_scale, device=dev)

    # -- draws -------------------------------------------------------------
    # every draw has a leading env dim; with a shard it is made at the
    # global shape and cut to this process's rows (parallel.dist.draw)
    def _rand(self, shape, g: torch.Generator) -> torch.Tensor:
        return draw(self.shard, torch.rand, shape, generator=g, device=self.device)

    def _uniform(self, shape, lo, hi, g: torch.Generator) -> torch.Tensor:
        u = self._rand(shape, g)
        return lo + (hi - lo) * u

    def _randint(self, n: int, lo: int, hi: int, g: torch.Generator) -> torch.Tensor:
        return draw(self.shard, lambda s, **kw: torch.randint(lo, hi, s, **kw), (n,),
                    generator=g, device=self.device)

    # ------------------------------------------------------------------
    def reset_with_model(self, model: Model, num_envs: int,
                         generator: Optional[torch.Generator] = None) -> State:
        g = generator if generator is not None else self.generator
        B, dev = num_envs, self.device
        qpos = self._init_q.expand(B, -1).clone()
        qvel = torch.zeros(B, model.nv, device=dev)

        # base xy jitter +-5 cm
        a = self._floating_base_qpos_addr
        qpos[:, a : a + 2] += self._uniform((B, 2), -0.05, 0.05, g)
        # yaw jitter U(-pi, pi)
        yaw = self._uniform((B,), -3.14, 3.14, g)
        quat = m3.axis_angle_to_quat(torch.tensor([0.0, 0.0, 1.0], device=dev), yaw)
        qpos[:, a + 3 : a + 7] = m3.quat_mul(qpos[:, a + 3 : a + 7], quat)
        # joint scale noise *U(0.5, 1.5)
        qpos[:, self._actuator_qpos_addr] = self.get_actuator_joints_qpos(
            qpos) * self._uniform((B, model.nu), 0.5, 1.5, g)
        # base velocity noise U(-0.05, 0.05)
        v = self._floating_base_qvel_addr
        qvel[:, v : v + 6] = self._uniform((B, 6), -0.05, 0.05, g)

        ctrl = self.get_actuator_joints_qpos(qpos)
        data = self.physics_init(model, qpos, qvel, ctrl)

        cmd = self.sample_command(B, g)
        fr = tuple(self._config.phase_frequency_range)
        if fr != (1.0, 1.0):
            imitation_freq = self._uniform((B,), fr[0], fr[1], g)
        else:
            imitation_freq = torch.ones(B, device=dev)
        pc = self._config.push_config
        push_interval = self._uniform((B,), pc.interval_range[0], pc.interval_range[1], g)
        push_interval_steps = torch.round(push_interval / self.dt).to(torch.int32)

        if USE_IMITATION_REWARD:
            current_reference_motion = self.PRM.get_reference_motion(
                cmd[:, 0], cmd[:, 1], cmd[:, 2], 0)
        else:
            current_reference_motion = torch.zeros(B, 0, device=dev)

        zeros = lambda *s, dtype=torch.float32: torch.zeros(*s, dtype=dtype, device=dev)  # noqa: E731
        nc = self._config.noise_config
        info = {
            "step": zeros(B, dtype=torch.int32),
            "command": cmd,
            "last_act": zeros(B, model.nu),
            "last_last_act": zeros(B, model.nu),
            "last_last_last_act": zeros(B, model.nu),
            "motor_targets": self._default_actuator.expand(B, -1).clone(),
            "feet_air_time": zeros(B, 2),
            "last_contact": zeros(B, 2, dtype=torch.bool),
            "swing_peak": zeros(B, 2),
            "push": zeros(B, 2),
            "push_step": zeros(B, dtype=torch.int32),
            "push_interval_steps": push_interval_steps,
            "action_history": zeros(B, nc.action_max_delay * model.nu),
            "imu_history": zeros(B, nc.imu_max_delay * 3),
            "imitation_i": zeros(B),
            "imitation_freq": imitation_freq,
            "current_reference_motion": current_reference_motion,
            "imitation_phase": zeros(B, 2),
        }

        metrics = {}
        for k, v in self._config.reward_config.scales.items():
            if v != 0:
                metrics[f"reward/{k}" if v > 0 else f"cost/{k}"] = zeros(B)
        metrics["swing_peak"] = zeros(B)

        contact = self._feet_contact(model, data)
        obs = self._get_obs(data, info, contact, g)
        return State(data, obs, zeros(B), zeros(B), metrics, info)

    def _feet_contact(self, model: Model, data: Data) -> torch.Tensor:
        return torch.stack([
            duck_base.geoms_colliding(model, data, gid, self._floor_geom_id)
            for gid in self._feet_geom_id
        ], dim=1)

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

        # action delay: rolled history, uniform random delay slot
        nu = model.nu
        nc = self._config.noise_config
        action_history = torch.roll(info["action_history"], nu, dims=1)
        action_history[:, :nu] = action
        info["action_history"] = action_history
        action_idx = self._randint(B, nc.action_min_delay, nc.action_max_delay, g)
        action_w_delay = action_history.reshape(B, -1, nu)[torch.arange(B, device=self.device),
                                                           action_idx]

        # random push: overwrite base xy velocity every push_interval steps
        pc = self._config.push_config
        push_theta = self._uniform((B,), 0.0, 2 * math.pi, g)
        push_magnitude = self._uniform((B,), pc.magnitude_range[0], pc.magnitude_range[1], g)
        push = torch.stack([torch.cos(push_theta), torch.sin(push_theta)], dim=1)
        push = push * (torch.remainder(info["push_step"] + 1,
                                       info["push_interval_steps"]) == 0)[:, None]
        push = push * float(pc.enable)
        a = self._floating_base_qvel_addr
        qvel = state.data.qvel.clone()
        qvel[:, a : a + 2] = push * push_magnitude[:, None] + qvel[:, a : a + 2]
        data = state.data.replace(qvel=qvel)

        motor_targets = self._default_actuator + action_w_delay * self._config.action_scale
        if USE_MOTOR_SPEED_LIMITS:
            prev = info["motor_targets"]
            lim = self._config.max_motor_velocity * self.dt
            motor_targets = torch.clamp(motor_targets, prev - lim, prev + lim)

        data = self.physics_step(model, data, motor_targets)
        info["motor_targets"] = motor_targets

        contact = self._feet_contact(model, data)
        contact_filt = contact | info["last_contact"]
        first_contact = (info["feet_air_time"] > 0.0) * contact_filt
        info["feet_air_time"] = info["feet_air_time"] + self.dt
        p_fz = data.site_xpos[:, self._feet_site_id, 2]
        info["swing_peak"] = torch.maximum(info["swing_peak"], p_fz)

        obs = self._get_obs(data, info, contact, g)
        done = self._get_termination(data)

        rewards = self._get_reward(data, action, info, done, first_contact, contact)
        scales = self._config.reward_config.scales
        rewards = {k: v * scales[k] for k, v in rewards.items()}
        reward = torch.clamp(sum(rewards.values()) * self.dt, 0.0, 10000.0)

        info["push"] = push
        info["step"] = info["step"] + 1
        info["push_step"] = info["push_step"] + 1
        info["last_last_last_act"] = info["last_last_act"]
        info["last_last_act"] = info["last_act"]
        info["last_act"] = action
        info["command"] = torch.where((info["step"] > 500)[:, None],
                                      self.sample_command(B, g), info["command"])
        info["step"] = torch.where(done | (info["step"] > 500),
                                   torch.zeros_like(info["step"]), info["step"])
        info["feet_air_time"] = info["feet_air_time"] * ~contact
        info["last_contact"] = contact
        info["swing_peak"] = info["swing_peak"] * ~contact

        metrics = dict(state.metrics)
        for k, v in rewards.items():
            scale = scales[k]
            if scale != 0:
                if scale > 0:
                    metrics[f"reward/{k}"] = v
                else:
                    metrics[f"cost/{k}"] = -v
        metrics["swing_peak"] = torch.mean(info["swing_peak"], dim=1)

        return state.replace(data=data, obs=obs, reward=reward, done=done.to(reward.dtype),
                             metrics=metrics, info=info)

    # ------------------------------------------------------------------
    def _get_termination(self, data: Data) -> torch.Tensor:
        fall = self.get_gravity(data)[:, -1] < 0.0
        return fall | torch.isnan(data.qpos).any(dim=1) | torch.isnan(data.qvel).any(dim=1)

    def _noise(self, x: torch.Tensor, scale, g: torch.Generator) -> torch.Tensor:
        level = self._config.noise_config.level
        u = self._rand(x.shape, g)
        return (2.0 * u - 1.0) * level * scale

    def _get_obs(self, data: Data, info: Dict[str, Any], contact: torch.Tensor,
                 g: torch.Generator):
        cfg = self._config.noise_config
        B = data.qpos.shape[0]

        gyro = self.get_gyro(data)
        noisy_gyro = gyro + self._noise(gyro, cfg.scales.gyro, g)

        accelerometer = self.get_accelerometer(data)
        # the reference's +1.3 x-bias is a discarded no-op; not applied
        noisy_accelerometer = accelerometer + self._noise(
            accelerometer, cfg.scales.accelerometer, g)

        R = data.site_xmat[:, self._site_id]
        down = torch.tensor([0.0, 0.0, -1.0], device=self.device)
        gravity = torch.matmul(R.transpose(1, 2), down)
        noisy_gravity = gravity + self._noise(gravity, cfg.scales.gravity, g)

        # IMU delay
        imu_history = torch.roll(info["imu_history"], 3, dims=1)
        imu_history[:, :3] = noisy_gravity
        info["imu_history"] = imu_history
        imu_idx = self._randint(B, cfg.imu_min_delay, cfg.imu_max_delay, g)
        noisy_gravity = imu_history.reshape(B, -1, 3)[torch.arange(B, device=self.device),
                                                      imu_idx]

        # backlash folding: observed joint angle = actuator + backlash dof
        joint_angles = self.get_actuator_joints_qpos(data.qpos)
        backlash = torch.cat([self.get_actuator_backlash_qpos(data.qpos),
                              torch.zeros(B, 1, device=self.device)], dim=1)
        joint_angles = joint_angles + backlash[:, self._backlash_fold]

        noisy_joint_angles = joint_angles + self._noise(
            joint_angles, self._qpos_noise_scale, g)

        joint_vel = self.get_actuator_joints_qvel(data.qvel)
        noisy_joint_vel = joint_vel + self._noise(joint_vel, cfg.scales.joint_vel, g)

        linvel = self.get_local_linvel(data)
        contact_f = contact.to(torch.float32)

        state = torch.cat(
            [
                noisy_gyro,  # 3
                noisy_accelerometer,  # 3
                info["command"],  # 7
                noisy_joint_angles - self._default_actuator,  # 14
                noisy_joint_vel * self._config.dof_vel_scale,  # 14
                info["last_act"],  # 14
                info["last_last_act"],  # 14
                info["last_last_last_act"],  # 14
                info["motor_targets"],  # 14
                contact_f,  # 2
                info["imitation_phase"],  # 2
            ],
            dim=1,
        )

        global_angvel = self.get_global_angvel(data)
        feet_vel = data.sensordata[:, self._foot_linvel_sensor_adr]
        root_height = data.qpos[:, self._floating_base_qpos_addr + 2 : self._floating_base_qpos_addr + 3]

        privileged_state = torch.cat(
            [
                state,
                gyro,  # 3
                accelerometer,  # 3
                gravity,  # 3
                linvel,  # 3
                global_angvel,  # 3
                joint_angles - self._default_actuator,  # 14
                joint_vel,  # 14
                root_height,  # 1
                data.actuator_force,  # 14
                contact_f,  # 2
                feet_vel,  # 6
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
