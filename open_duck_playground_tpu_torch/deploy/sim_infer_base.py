"""Sim-to-sim inference base on the port's own engine: one env stepped
through the fused physics step, with a numpy accessor API.

Parity with the reference's mujoco_infer_base.py (MJInferBase): the joint
topology and sensor accessors over the simulation state, the `home`
keyframe init, sim_dt 0.002 with decimation 10, and foot-contact queries.
The engine underneath is the one that trained the policy: the fused
physics step of ``ops/cuda_step.FusedPhysics``, called as
``envs/base.py``'s ``physics_init`` / ``physics_step`` call it, at one env
(B=1) with domain randomization off. On the card that is the hand-written
kernel, one launch per control tick; with ``device="cpu"`` it is the
kernel's plain PyTorch version. (The JAX package steps its general XLA
pipeline here, jitted at one env. The port has that pipeline too,
``ops/forward.py``, but steps the kernel by choice: a pipeline control
step is ~43,000 small kernels whatever the batch, ~85 ms on an H100 even
replayed as one CUDA graph, beyond a 50 Hz tick's 20 ms; the kernel is
one launch.)

The state lives on the device as ``(1, ...)`` tensors (``self.data``). The
accessors return numpy from one host copy of the state per control tick
(qpos, qvel, sensordata and contact distances together), taken at the
first read and reused until the state changes.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from open_duck_playground_tpu_torch.mjcf import compile_mjcf
from open_duck_playground_tpu_torch.models.open_duck_mini_v2 import constants
from open_duck_playground_tpu_torch.ops.cuda_step import FusedPhysics
from open_duck_playground_tpu_torch.ops.types import Contact, Data, JointType

_HOST_FIELDS = ("qpos", "qvel", "sensordata", "contact_dist")


class SimInferBase:
    def __init__(self, model_path: str, device: Union[str, torch.device] = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the engine runs on the card unless given "
                               "device='cpu' (physics then runs the kernel's plain version)")
        self.sim_dt = 0.002
        self.decimation = 10

        self.model = compile_mjcf(model_path, timestep=self.sim_dt)
        m = self.model
        self.physics = FusedPhysics(m)

        jnt_names = m.names.list("joint")
        self.joint_names = jnt_names
        self.actuator_names = m.names.list("actuator")
        free = [j for j in range(m.njnt) if int(m.jnt_type[j]) == JointType.FREE][0]
        self.floating_base_name = jnt_names[free]
        self.backlash_joint_names = [
            n for n in jnt_names
            if n not in self.actuator_names and n not in self.floating_base_name
        ]
        jq, jv = m.jnt_qposadr.np, m.jnt_dofadr.np
        act_ids = [m.joint(n) for n in self.actuator_names]
        self._act_qpos_addr = np.asarray([jq[i] for i in act_ids])
        self._act_qvel_addr = np.asarray([jv[i] for i in act_ids])
        self.num_dofs = m.nu

        kf = m.keyframe("home")
        self.default_actuator = np.asarray(kf.ctrl, np.float64)
        self.motor_targets = self.default_actuator.copy()
        self.prev_motor_targets = self.default_actuator.copy()

        self._sensor = {
            name: (int(m.sensor_adr[sid]), int(m.sensor_dim[sid]))
            for name, sid in m.names.sensor.items()
        }
        self._feet_pairs = [
            m.find_pair(m.geom(g), m.geom("floor")) for g in constants.FEET_GEOMS
        ]
        self._widths = dict(qpos=m.nq, qvel=m.nv, sensordata=m.nsensordata,
                            contact_dist=m.ncon)
        self._host_of = None  # (data, qpos version, qvel version) of the host copy
        self._host = None

        # mjx_env.init: the derived fields of the keyframe state, no
        # integration (the kernel at one substep, its integration thrown away)
        dev = self.device
        qpos = torch.tensor(kf.qpos, dtype=torch.float32, device=dev)[None]
        qvel = torch.zeros((1, m.nv), dtype=torch.float32, device=dev)
        ctrl = torch.tensor(kf.ctrl, dtype=torch.float32, device=dev)[None]
        out = self.physics(qpos, qvel, torch.zeros_like(qvel), ctrl, 1, None)
        self.data = self._data(qpos, qvel, ctrl, out, torch.zeros(1, device=dev))

    def _data(self, qpos, qvel, ctrl, out, time) -> Data:
        m = self.model
        return Data(
            qpos=qpos, qvel=qvel, ctrl=ctrl, qacc_warmstart=out["qacc_warmstart"], time=time,
            site_xpos=out["site_xpos"].reshape(1, m.nsite, 3),
            site_xmat=out["site_xmat"].reshape(1, m.nsite, 3, 3),
            actuator_force=out["actuator_force"], sensordata=out["sensordata"],
            contact=Contact(dist=out["contact_dist"]),
        )

    # --- stepping ---------------------------------------------------------
    def step_control(self, motor_targets: np.ndarray) -> None:
        """Advance one control period: decimation physics substeps with the
        motor targets held, in one call of the fused step."""
        d = self.data
        ctrl = torch.as_tensor(np.asarray(motor_targets, np.float32).reshape(1, -1),
                               device=self.device)
        out = self.physics(d.qpos.contiguous(), d.qvel.contiguous(),
                           d.qacc_warmstart.contiguous(), ctrl, self.decimation, None)
        self.data = self._data(out["qpos"], out["qvel"], ctrl, out,
                               d.time + self.decimation * self.sim_dt)

    # --- the host copy ----------------------------------------------------
    def host(self, data) -> dict:
        """qpos, qvel, sensordata and contact_dist of `data` as 1-d numpy
        arrays, from one device-to-host copy, reused while `data` and its
        qpos / qvel are unchanged (an in-place push on qvel makes a new
        copy)."""
        src, vq, vv = self._host_of or (None, -1, -1)
        if not (data is src and data.qpos._version == vq and data.qvel._version == vv):
            flat = torch.cat([data.qpos, data.qvel, data.sensordata, data.contact.dist],
                             dim=1)[0].cpu().numpy()
            self._host, off = {}, 0
            for k in _HOST_FIELDS:
                self._host[k] = flat[off:off + self._widths[k]]
                off += self._widths[k]
            self._host_of = (data, data.qpos._version, data.qvel._version)
        return self._host

    def _vec(self, x, field: str) -> np.ndarray:
        if isinstance(x, torch.Tensor):
            if x is getattr(self.data, field):
                return self.host(self.data)[field]
            return x.detach().cpu().numpy().reshape(-1)
        return np.asarray(x)

    # --- state accessors ----------------------------------------------------
    @property
    def qpos(self) -> np.ndarray:
        return self.host(self.data)["qpos"]

    @property
    def qvel(self) -> np.ndarray:
        return self.host(self.data)["qvel"]

    def get_actuator_joints_qpos(self, qpos) -> np.ndarray:
        return self._vec(qpos, "qpos")[self._act_qpos_addr]

    def get_actuator_joints_qvel(self, qvel) -> np.ndarray:
        return self._vec(qvel, "qvel")[self._act_qvel_addr]

    def get_sensor(self, data, name: str) -> np.ndarray:
        adr, dim = self._sensor[name]
        return self.host(data)["sensordata"][adr : adr + dim]

    def get_gyro(self, data) -> np.ndarray:
        return self.get_sensor(data, constants.GYRO_SENSOR)

    def get_accelerometer(self, data) -> np.ndarray:
        return np.array(self.get_sensor(data, constants.ACCELEROMETER_SENSOR))

    def get_gravity(self, data) -> np.ndarray:
        return self.get_sensor(data, constants.GRAVITY_SENSOR)

    def get_linvel(self, data) -> np.ndarray:
        return self.get_sensor(data, constants.LOCAL_LINVEL_SENSOR)

    def get_feet_contacts(self, data) -> np.ndarray:
        """Per foot: 1.0 where its floor pair has a penetrating contact
        (``envs/base.geoms_colliding``)."""
        dist = self.host(data)["contact_dist"]
        return np.array(
            [(dist[p * 4 : p * 4 + 4] < 0).any() for p in self._feet_pairs],
            dtype=np.float64,
        )
