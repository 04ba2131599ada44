"""Env base for the Open Duck Mini v2, batched over envs.

Counterpart of the JAX package's ``envs/base.py``: joint-topology discovery
by name (actuators vs backlash vs floating base), qpos/qvel address tables,
named sensor getters, config-driven sim/ctrl timing. Every accessor takes
and returns tensors with a leading env dim.

Physics dispatch (``physics_step`` / ``physics_init``): an env on a CUDA
device runs the fused CUDA kernel, an env on the CPU its plain PyTorch
version (``ops/cuda_step.FusedPhysics`` decides by the tensors' device).
There is no other path.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from open_duck_playground_tpu_torch.envs.types import State
from open_duck_playground_tpu_torch.mjcf import compile_mjcf
from open_duck_playground_tpu_torch.models.open_duck_mini_v2 import constants
from open_duck_playground_tpu_torch.ops.cuda_step import FusedPhysics, flatten_dr_fields
from open_duck_playground_tpu_torch.ops.types import Contact, Data, JointType, Model
from open_duck_playground_tpu_torch.parallel.dist import EnvShard
from open_duck_playground_tpu_torch.utils.config import Config


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
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the env runs on the card unless given "
                               "device='cpu' (physics then runs the kernel's plain version)")
        # the env's own stream of draws (noise, pushes, delays, commands)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        # which rows of a sharded global batch this process's envs are: with
        # a shard, every draw is made at the global shape and cut to them
        # (ppo.train sets it; None: the batch is the whole batch)
        self.shard: Optional[EnvShard] = None
        self._observation_size = None

        model_cpu = compile_mjcf(xml_path, timestep=self._config.sim_dt)
        self._model = model_cpu.to(self.device)
        self._xml_path = xml_path
        self.physics = FusedPhysics(model_cpu)
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
        return flatten_dr_fields(model) if is_randomized(model) else None

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

    def get_actuator_joints_qpos(self, qpos: torch.Tensor) -> torch.Tensor:
        return qpos[:, self._actuator_qpos_addr]

    def get_actuator_joints_qvel(self, qvel: torch.Tensor) -> torch.Tensor:
        return qvel[:, self._actuator_qvel_addr]

    def get_actuator_backlash_qpos(self, qpos: torch.Tensor) -> torch.Tensor:
        return qpos[:, self._backlash_qpos_addr]

    # --- sensors ------------------------------------------------------------
    def get_sensor_data(self, data: Data, name: str) -> torch.Tensor:
        adr, dim = self._sensor_slices[name]
        return data.sensordata[:, adr : adr + dim]

    def get_gravity(self, data: Data) -> torch.Tensor:
        return self.get_sensor_data(data, constants.GRAVITY_SENSOR)

    def get_global_angvel(self, data: Data) -> torch.Tensor:
        return self.get_sensor_data(data, constants.GLOBAL_ANGVEL_SENSOR)

    def get_local_linvel(self, data: Data) -> torch.Tensor:
        return self.get_sensor_data(data, constants.LOCAL_LINVEL_SENSOR)

    def get_accelerometer(self, data: Data) -> torch.Tensor:
        return self.get_sensor_data(data, constants.ACCELEROMETER_SENSOR)

    def get_gyro(self, data: Data) -> torch.Tensor:
        return self.get_sensor_data(data, constants.GYRO_SENSOR)

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
