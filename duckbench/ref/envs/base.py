"""Env base for the Open Duck Mini v2, batched over envs.

Counterpart of the JAX package's ``envs/base.py``: joint-topology discovery
by name (actuators vs backlash vs floating base), qpos/qvel address tables,
named sensor getters, config-driven sim/ctrl timing. Every accessor takes
and returns tensors with a leading env dim.

The tasks (``joystick.py``, ``standing.py``) share the pieces below the
"tasks" line: the home pose and noise tables, the draws, the delayed action
and the push, the IMU and joint readings with their noise and delay, the
feet bookkeeping, the termination rule and the end of a step.

A frozen copy of the port's ``envs/base.py`` for the benchmark's plain
reference: physics (``physics_step`` / ``physics_init``) is always the fused
step's plain PyTorch version (``ops/twin.py``) on the env's device; the
port's kernel, general pipeline and env sharding are left out.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from duckbench.ref.envs.types import State
from duckbench.ref.mjcf import compile_mjcf
from duckbench.ref.models.open_duck_mini_v2 import constants
from duckbench.ref.ops import math3d as m3
from duckbench.ref.ops.twin import TwinPhysics, flatten_dr_fields
from duckbench.ref.ops.types import Contact, Data, JointType, Model
from duckbench.ref.utils.config import Config


def geoms_colliding(model: Model, data: Data, geom1: int, geom2: int) -> torch.Tensor:
    """(B,) True where the static pair (geom1, geom2) has a penetrating contact."""
    p = model.find_pair(geom1, geom2)
    return (data.contact.dist[:, p * 4 : (p + 1) * 4] < 0).any(dim=1)


def is_randomized(model: Model) -> bool:
    """True for a model whose DR fields carry a leading env dim."""
    return model.body_mass.dim() == 2


class OpenDuckMiniV2Env:
    """Base class: model compilation + joint topology + sensors."""

    def __init__(
        self,
        xml_path: str,
        config: Config,
        config_overrides: Optional[Dict[str, Union[str, int, list]]] = None,
        device: Union[str, torch.device] = "cuda",
        seed: int = 0,
    ) -> None:
        self._config = config
        if config_overrides:
            self._config.update_from_flattened_dict(config_overrides)
        self.device = torch.device(device)
        # the env's own stream of draws (noise, pushes, delays, commands)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._observation_size = None
        # (randomized model, its flat DR fields), flattened once per model
        self._dr_cache = None

        model_cpu = compile_mjcf(xml_path, timestep=self._config.sim_dt)
        self._model = model_cpu.to(self.device)
        self._xml_path = xml_path
        self.physics = TwinPhysics(model_cpu)
        m = model_cpu

        jnt_names = m.names.list("joint")
        self.floating_base_name = [
            jnt_names[j] for j in range(m.njnt) if int(m.jnt_type[j]) == JointType.FREE
        ][0]
        self.actuator_names = m.names.list("actuator")
        self.joint_names = jnt_names
        self.backlash_joint_names = [
            j
            for j in jnt_names
            if j not in self.actuator_names and j not in self.floating_base_name
        ]
        self.actuator_joint_ids = [m.joint(n) for n in self.actuator_names]
        self.backlash_joint_ids = [m.joint(n) for n in self.backlash_joint_names]

        jq = m.jnt_qposadr.np
        jv = m.jnt_dofadr.np
        idx = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=self.device)  # noqa: E731
        self._actuator_qpos_addr = idx([jq[i] for i in self.actuator_joint_ids])
        self._actuator_qvel_addr = idx([jv[i] for i in self.actuator_joint_ids])
        self._backlash_qpos_addr = idx([jq[i] for i in self.backlash_joint_ids])

        free_j = [j for j in range(m.njnt) if int(m.jnt_type[j]) == JointType.FREE][0]
        self._floating_base_qpos_addr = int(jq[free_j])
        self._floating_base_qvel_addr = int(jv[free_j])

        # actuator indices with no backlash twin (head joints): zeros go in
        # there when folding backlash into joint angles
        self.backlash_idx_to_add = [
            i
            for i, name in enumerate(self.actuator_names)
            if name + "_backlash" not in self.backlash_joint_names
        ]
        # the same insertion as one gather from [backlash..., 0]
        order = list(range(len(self.backlash_joint_ids)))
        for i in self.backlash_idx_to_add:
            order.insert(i, len(self.backlash_joint_ids))
        self._backlash_fold = idx(order)

        self._sensor_slices = {}
        for name, sid in m.names.sensor.items():
            adr, dim = int(m.sensor_adr[sid]), int(m.sensor_dim[sid])
            self._sensor_slices[name] = (adr, dim)

    # --- timing -----------------------------------------------------------
    @property
    def dt(self) -> float:
        return self._config.ctrl_dt

    @property
    def sim_dt(self) -> float:
        return self._config.sim_dt

    @property
    def n_substeps(self) -> int:
        return int(round(self._config.ctrl_dt / self._config.sim_dt))

    # --- physics dispatch ---------------------------------------------------
    def _dr(self, model: Model):
        if not is_randomized(model):
            return None
        if self._dr_cache is None or self._dr_cache[0] is not model:
            self._dr_cache = (model, flatten_dr_fields(model))
        return self._dr_cache[1]

    def _data(self, data_time, qpos, qvel, ctrl, out) -> Data:
        B = qpos.shape[0]
        m = self._model
        return Data(
            qpos=qpos, qvel=qvel, ctrl=ctrl, qacc_warmstart=out["qacc_warmstart"],
            time=data_time,
            site_xpos=out["site_xpos"].reshape(B, m.nsite, 3),
            site_xmat=out["site_xmat"].reshape(B, m.nsite, 3, 3),
            actuator_force=out["actuator_force"], sensordata=out["sensordata"],
            contact=Contact(dist=out["contact_dist"]),
        )

    def physics_step(self, model: Model, data: Data, ctrl: torch.Tensor) -> Data:
        """n_substeps of physics with ctrl held fixed (mjx_env.step)."""
        ctrl = ctrl.contiguous()
        out = self.physics(data.qpos.contiguous(), data.qvel.contiguous(),
                           data.qacc_warmstart.contiguous(), ctrl, self.n_substeps,
                           self._dr(model))
        time = data.time + self.n_substeps * model.opt.timestep
        return self._data(time, out["qpos"], out["qvel"], ctrl, out)

    def physics_init(self, model: Model, qpos, qvel, ctrl) -> Data:
        """mjx_env.init: derived fields of the given state, no integration
        (the kernel at one substep, its integration thrown away)."""
        qpos, qvel, ctrl = qpos.contiguous(), qvel.contiguous(), ctrl.contiguous()
        warm = torch.zeros_like(qvel)
        out = self.physics(qpos, qvel, warm, ctrl, 1, self._dr(model))
        time = torch.zeros(qpos.shape[0], device=qpos.device)
        return self._data(time, qpos, qvel, ctrl, out)

    # --- model ------------------------------------------------------------
    @property
    def model(self) -> Model:
        return self._model

    @property
    def xml_path(self) -> str:
        return self._xml_path

    @property
    def action_size(self) -> int:
        return self._model.nu

    @property
    def observation_size(self) -> Dict[str, tuple]:
        """{obs key: per-env shape}, from one reset of one env on the env's
        device (a throwaway generator, so the env's own stream is
        untouched), computed once."""
        if self._observation_size is None:
            g = torch.Generator(device=self.device).manual_seed(0)
            obs = self.reset(1, g).obs
            self._observation_size = {k: tuple(v.shape[1:]) for k, v in obs.items()}
        return self._observation_size

    # --- qpos/qvel accessors ------------------------------------------------
    def get_floating_base_qpos(self, qpos: torch.Tensor) -> torch.Tensor:
        a = self._floating_base_qpos_addr
        return qpos[:, a : a + 7]

    def get_floating_base_qvel(self, qvel: torch.Tensor) -> torch.Tensor:
        a = self._floating_base_qvel_addr
        return qvel[:, a : a + 6]

    def set_floating_base_qpos(self, new_qpos: torch.Tensor, qpos: torch.Tensor) -> torch.Tensor:
        """`qpos` with its floating base's 7 coordinates set (a new tensor)."""
        a = self._floating_base_qpos_addr
        out = qpos.clone()
        out[:, a : a + 7] = new_qpos
        return out

    def set_floating_base_qvel(self, new_qvel: torch.Tensor, qvel: torch.Tensor) -> torch.Tensor:
        a = self._floating_base_qvel_addr
        out = qvel.clone()
        out[:, a : a + 6] = new_qvel
        return out

    def get_actuator_joints_qpos(self, qpos: torch.Tensor) -> torch.Tensor:
        return qpos[:, self._actuator_qpos_addr]

    def set_actuator_joints_qpos(self, new_qpos: torch.Tensor, qpos: torch.Tensor) -> torch.Tensor:
        out = qpos.clone()
        out[:, self._actuator_qpos_addr] = new_qpos
        return out

    def get_actuator_joints_qvel(self, qvel: torch.Tensor) -> torch.Tensor:
        return qvel[:, self._actuator_qvel_addr]

    def set_actuator_joints_qvel(self, new_qvel: torch.Tensor, qvel: torch.Tensor) -> torch.Tensor:
        out = qvel.clone()
        out[:, self._actuator_qvel_addr] = new_qvel
        return out

    def get_actuator_backlash_qpos(self, qpos: torch.Tensor) -> torch.Tensor:
        return qpos[:, self._backlash_qpos_addr]

    # --- sensors ------------------------------------------------------------
    def get_sensor_data(self, data: Data, name: str) -> torch.Tensor:
        adr, dim = self._sensor_slices[name]
        return data.sensordata[:, adr : adr + dim]

    def get_gravity(self, data: Data) -> torch.Tensor:
        return self.get_sensor_data(data, constants.GRAVITY_SENSOR)

    def get_global_linvel(self, data: Data) -> torch.Tensor:
        return self.get_sensor_data(data, constants.GLOBAL_LINVEL_SENSOR)

    def get_global_angvel(self, data: Data) -> torch.Tensor:
        return self.get_sensor_data(data, constants.GLOBAL_ANGVEL_SENSOR)

    def get_local_linvel(self, data: Data) -> torch.Tensor:
        return self.get_sensor_data(data, constants.LOCAL_LINVEL_SENSOR)

    def get_accelerometer(self, data: Data) -> torch.Tensor:
        return self.get_sensor_data(data, constants.ACCELEROMETER_SENSOR)

    def get_gyro(self, data: Data) -> torch.Tensor:
        return self.get_sensor_data(data, constants.GYRO_SENSOR)

    def get_feet_pos(self, data: Data) -> torch.Tensor:
        """(B, 2, 3): each foot's position sensor, in FEET_POS_SENSOR order
        (the JAX package stacks them as rows of (2, 3) per env)."""
        return torch.stack([self.get_sensor_data(data, n) for n in constants.FEET_POS_SENSOR],
                           dim=1)

    # --- tasks: tables and draws ------------------------------------------------
    def _task_tables(self) -> None:
        """The home keyframe, the IMU site, the feet, the joint noise scales
        and the world's up and down axes, on the env's device (made once: a
        tensor built from a Python list is a host copy and a host wait on
        every step that builds it)."""
        m = self._model
        dev = self.device
        kf = m.keyframe("home")
        self._init_q = torch.tensor(kf.qpos, dtype=torch.float32, device=dev)
        self._z_axis = torch.tensor([0.0, 0.0, 1.0], device=dev)
        self._down = torch.tensor([0.0, 0.0, -1.0], device=dev)
        self._default_actuator = torch.tensor(kf.ctrl, dtype=torch.float32, device=dev)
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

    # every draw has a leading env dim
    def _rand(self, shape, g: torch.Generator) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=g, device=self.device)

    def _uniform(self, shape, lo, hi, g: torch.Generator) -> torch.Tensor:
        u = self._rand(shape, g)
        return lo + (hi - lo) * u

    def _randint(self, n: int, lo: int, hi: int, g: torch.Generator) -> torch.Tensor:
        return torch.randint(lo, hi, (n,), generator=g, device=self.device)

    def _noise(self, x: torch.Tensor, scale, g: torch.Generator) -> torch.Tensor:
        level = self._config.noise_config.level
        u = self._rand(x.shape, g)
        return (2.0 * u - 1.0) * level * scale

    # --- tasks: one step's pieces ---------------------------------------------
    def _jitter_reset(self, model: Model, B: int, g: torch.Generator):
        """The home pose with the reset jitter: base xy +-5 cm, yaw
        U(-3.14, 3.14), joints x U(0.5, 1.5), base velocity U(-0.05, 0.05);
        returns (qpos, qvel)."""
        dev = self.device
        qpos = self._init_q.expand(B, -1).clone()
        qvel = torch.zeros(B, model.nv, device=dev)
        a = self._floating_base_qpos_addr
        qpos[:, a : a + 2] += self._uniform((B, 2), -0.05, 0.05, g)
        yaw = self._uniform((B,), -3.14, 3.14, g)
        quat = m3.axis_angle_to_quat(self._z_axis, yaw)
        qpos[:, a + 3 : a + 7] = m3.quat_mul(qpos[:, a + 3 : a + 7], quat)
        qpos[:, self._actuator_qpos_addr] = self.get_actuator_joints_qpos(
            qpos) * self._uniform((B, model.nu), 0.5, 1.5, g)
        v = self._floating_base_qvel_addr
        qvel[:, v : v + 6] = self._uniform((B, 6), -0.05, 0.05, g)
        return qpos, qvel

    def _base_info(self, model: Model, B: int, cmd: torch.Tensor, g: torch.Generator) -> dict:
        """The info keys both tasks keep, at reset (the push interval drawn
        from `g`)."""
        pc = self._config.push_config
        push_interval = self._uniform((B,), pc.interval_range[0], pc.interval_range[1], g)
        nc = self._config.noise_config
        zeros = lambda *s, dtype=torch.float32: torch.zeros(*s, dtype=dtype, device=self.device)  # noqa: E731
        return {
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
            "push_interval_steps": torch.round(push_interval / self.dt).to(torch.int32),
            "action_history": zeros(B, nc.action_max_delay * model.nu),
            "imu_history": zeros(B, nc.imu_max_delay * 3),
        }

    def _zero_metrics(self, B: int) -> Dict[str, torch.Tensor]:
        metrics = {}
        for k, v in self._config.reward_config.scales.items():
            if v != 0:
                metrics[f"reward/{k}" if v > 0 else f"cost/{k}"] = torch.zeros(
                    B, device=self.device)
        metrics["swing_peak"] = torch.zeros(B, device=self.device)
        return metrics

    def _delayed_action(self, info: dict, action: torch.Tensor, g: torch.Generator):
        """Push `action` into the rolled history and serve the one a random
        delay slot holds."""
        B, nu = action.shape
        nc = self._config.noise_config
        action_history = torch.roll(info["action_history"], nu, dims=1)
        action_history[:, :nu] = action
        info["action_history"] = action_history
        action_idx = self._randint(B, nc.action_min_delay, nc.action_max_delay, g)
        return action_history.reshape(B, -1, nu)[torch.arange(B, device=self.device),
                                                 action_idx]

    def _push(self, data: Data, info: dict, g: torch.Generator):
        """The random push: overwrite the base xy velocity every
        push_interval steps; returns (data, push)."""
        B = data.qvel.shape[0]
        pc = self._config.push_config
        push_theta = self._uniform((B,), 0.0, 2 * math.pi, g)
        push_magnitude = self._uniform((B,), pc.magnitude_range[0], pc.magnitude_range[1], g)
        push = torch.stack([torch.cos(push_theta), torch.sin(push_theta)], dim=1)
        push = push * (torch.remainder(info["push_step"] + 1,
                                       info["push_interval_steps"]) == 0)[:, None]
        push = push * float(pc.enable)
        a = self._floating_base_qvel_addr
        qvel = data.qvel.clone()
        qvel[:, a : a + 2] = push * push_magnitude[:, None] + qvel[:, a : a + 2]
        return data.replace(qvel=qvel), push

    def _feet_contact(self, model: Model, data: Data) -> torch.Tensor:
        return torch.stack([
            geoms_colliding(model, data, gid, self._floor_geom_id)
            for gid in self._feet_geom_id
        ], dim=1)

    def _feet_update(self, model: Model, data: Data, info: dict):
        """Foot contact, first contact, air time and swing peak after a
        physics step; returns (contact, first_contact)."""
        contact = self._feet_contact(model, data)
        contact_filt = contact | info["last_contact"]
        first_contact = (info["feet_air_time"] > 0.0) * contact_filt
        info["feet_air_time"] = info["feet_air_time"] + self.dt
        p_fz = data.site_xpos[:, self._feet_site_id, 2]
        info["swing_peak"] = torch.maximum(info["swing_peak"], p_fz)
        return contact, first_contact

    def _get_termination(self, data: Data) -> torch.Tensor:
        fall = self.get_gravity(data)[:, -1] < 0.0
        return fall | torch.isnan(data.qpos).any(dim=1) | torch.isnan(data.qvel).any(dim=1)

    def _readings(self, data: Data, info: dict, g: torch.Generator) -> Dict[str, Any]:
        """The IMU and joint readings, clean and noisy, in the reference's
        draw order: gyro, accelerometer and gravity noise, the IMU delay
        (which rolls info["imu_history"]), joint angle and velocity noise.
        Joint angles have the backlash dofs folded in."""
        cfg = self._config.noise_config
        B = data.qpos.shape[0]
        r = {}
        r["gyro"] = self.get_gyro(data)
        r["noisy_gyro"] = r["gyro"] + self._noise(r["gyro"], cfg.scales.gyro, g)
        r["accelerometer"] = self.get_accelerometer(data)
        r["noisy_accelerometer"] = r["accelerometer"] + self._noise(
            r["accelerometer"], cfg.scales.accelerometer, g)

        R = data.site_xmat[:, self._site_id]
        r["gravity"] = torch.matmul(R.transpose(1, 2), self._down)
        noisy_gravity = r["gravity"] + self._noise(r["gravity"], cfg.scales.gravity, g)
        imu_history = torch.roll(info["imu_history"], 3, dims=1)
        imu_history[:, :3] = noisy_gravity
        info["imu_history"] = imu_history
        imu_idx = self._randint(B, cfg.imu_min_delay, cfg.imu_max_delay, g)
        r["noisy_gravity"] = imu_history.reshape(B, -1, 3)[torch.arange(B, device=self.device),
                                                           imu_idx]

        # backlash folding: observed joint angle = actuator + backlash dof
        joint_angles = self.get_actuator_joints_qpos(data.qpos)
        backlash = torch.cat([self.get_actuator_backlash_qpos(data.qpos),
                              torch.zeros(B, 1, device=self.device)], dim=1)
        r["joint_angles"] = joint_angles + backlash[:, self._backlash_fold]
        r["noisy_joint_angles"] = r["joint_angles"] + self._noise(
            r["joint_angles"], self._qpos_noise_scale, g)
        r["joint_vel"] = self.get_actuator_joints_qvel(data.qvel)
        r["noisy_joint_vel"] = r["joint_vel"] + self._noise(r["joint_vel"], cfg.scales.joint_vel, g)
        a = self._floating_base_qpos_addr
        r["root_height"] = data.qpos[:, a + 2 : a + 3]
        r["feet_vel"] = data.sensordata[:, self._foot_linvel_sensor_adr]
        return r

    def _finish_step(self, state: State, data: Data, obs, done, rewards: dict, info: dict,
                     action, push, contact, g: torch.Generator) -> State:
        """Scale and sum the rewards, advance the counters, resample the
        command past step 500 (drawn for every env, kept where step > 500,
        so the stream does not depend on the data) and fill the metrics."""
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
                                      self.sample_command(action.shape[0], g), info["command"])
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

    def sample_command(self, num_envs: int, g: torch.Generator) -> torch.Tensor:
        raise NotImplementedError

    # --- to be overridden ---------------------------------------------------
    def reset(self, num_envs: int, generator: Optional[torch.Generator] = None) -> State:
        return self.reset_with_model(self._model, num_envs, generator)

    def step(self, state: State, action: torch.Tensor) -> State:
        return self.step_with_model(self._model, state, action)

    def reset_with_model(self, model: Model, num_envs: int,
                         generator: Optional[torch.Generator] = None) -> State:
        raise NotImplementedError

    def step_with_model(self, model: Model, state: State, action: torch.Tensor) -> State:
        raise NotImplementedError
