"""Deploy-side accessors over the REAL MuJoCo C engine.

Parity with the reference's mujoco_infer_base.py (MJInferBase,
open_duck_mini_v2/mujoco_infer_base.py:8-128): name-based joint topology
over `mujoco.MjModel`/`MjData`, the `home` keyframe init, sim_dt 0.002
with decimation 10, sensor getters, and foot-contact queries via iterating
`data.contact` (reference :259-283).

This is the INDEPENDENT engine for sim-to-sim validation: the policy is
trained on the port's own physics, then must walk here in the MuJoCo C
library, an engine this project did not write, as the reference validates
its MJX-trained policies in CPU MuJoCo. ``mujoco`` is imported inside the
functions that use it.
"""

from __future__ import annotations

import os

import numpy as np

from open_duck_playground_tpu_torch.models.open_duck_mini_v2 import constants


def load_mj_model(model_path: str):
    """mujoco.MjModel with an in-memory asset dict (reference base.py:31-38;
    from_xml_path mis-joins assetdir for the hfield PNG)."""
    import mujoco

    root = os.path.dirname(model_path)
    assets = {}
    asset_dir = os.path.join(root, "assets")
    if os.path.isdir(asset_dir):
        for dirpath, _, files in os.walk(asset_dir):
            for f in files:
                with open(os.path.join(dirpath, f), "rb") as fh:
                    assets[f] = fh.read()
    for f in os.listdir(root):
        if f.endswith(".xml"):
            with open(os.path.join(root, f), "rb") as fh:
                assets[f] = fh.read()
    with open(model_path) as fh:
        return mujoco.MjModel.from_xml_string(fh.read(), assets)


class MJInferBase:
    def __init__(self, model_path: str):
        import mujoco

        self._mujoco = mujoco
        self.sim_dt = 0.002
        self.decimation = 10

        self.model = load_mj_model(model_path)
        self.model.opt.timestep = self.sim_dt
        m = self.model
        self.data = mujoco.MjData(m)

        def jname(j):
            return mujoco.mj_id2name(m, mujoco.mjtObj.mjOBJ_JOINT, j)

        self.joint_names = [jname(j) for j in range(m.njnt)]
        self.actuator_names = [
            mujoco.mj_id2name(m, mujoco.mjtObj.mjOBJ_ACTUATOR, a)
            for a in range(m.nu)
        ]
        free = [j for j in range(m.njnt)
                if m.jnt_type[j] == mujoco.mjtJoint.mjJNT_FREE][0]
        self.floating_base_name = jname(free)
        self.backlash_joint_names = [
            n for n in self.joint_names
            if n not in self.actuator_names and n != self.floating_base_name
        ]
        act_jids = [
            mujoco.mj_name2id(m, mujoco.mjtObj.mjOBJ_JOINT, n)
            for n in self.actuator_names
        ]
        self._act_qpos_addr = np.asarray([m.jnt_qposadr[j] for j in act_jids])
        self._act_qvel_addr = np.asarray([m.jnt_dofadr[j] for j in act_jids])
        self.num_dofs = m.nu

        kid = mujoco.mj_name2id(m, mujoco.mjtObj.mjOBJ_KEY, "home")
        mujoco.mj_resetDataKeyframe(m, self.data, kid)
        self.default_actuator = np.asarray(m.key_ctrl[kid], np.float64).copy()
        self.motor_targets = self.default_actuator.copy()
        self.prev_motor_targets = self.default_actuator.copy()
        self.data.ctrl[:] = self.default_actuator
        mujoco.mj_forward(m, self.data)

        self._feet_geom_ids = [
            mujoco.mj_name2id(m, mujoco.mjtObj.mjOBJ_GEOM, g)
            for g in constants.FEET_GEOMS
        ]
        self._floor_geom_id = mujoco.mj_name2id(
            m, mujoco.mjtObj.mjOBJ_GEOM, "floor")

    # --- stepping ---------------------------------------------------------
    def step_control(self, motor_targets: np.ndarray) -> None:
        """Advance one control period (decimation mj_step substeps)."""
        self.data.ctrl[:] = motor_targets
        for _ in range(self.decimation):
            self._mujoco.mj_step(self.model, self.data)

    # --- state accessors --------------------------------------------------
    @property
    def qpos(self) -> np.ndarray:
        return np.asarray(self.data.qpos)

    @property
    def qvel(self) -> np.ndarray:
        return np.asarray(self.data.qvel)

    def get_actuator_joints_qpos(self, qpos) -> np.ndarray:
        return np.asarray(qpos)[self._act_qpos_addr]

    def get_actuator_joints_qvel(self, qvel) -> np.ndarray:
        return np.asarray(qvel)[self._act_qvel_addr]

    def get_sensor(self, data, name: str) -> np.ndarray:
        return np.asarray(data.sensor(name).data)

    def get_gyro(self, data) -> np.ndarray:
        return self.get_sensor(data, constants.GYRO_SENSOR)

    def get_accelerometer(self, data) -> np.ndarray:
        return np.array(self.get_sensor(data, constants.ACCELEROMETER_SENSOR))

    def get_gravity(self, data) -> np.ndarray:
        return self.get_sensor(data, constants.GRAVITY_SENSOR)

    def get_linvel(self, data) -> np.ndarray:
        return self.get_sensor(data, constants.LOCAL_LINVEL_SENSOR)

    def get_feet_contacts(self, data) -> np.ndarray:
        """Foot/floor contact flags via data.contact (reference :259-283)."""
        out = np.zeros(len(self._feet_geom_ids))
        for i in range(data.ncon):
            c = data.contact[i]
            pair = {int(c.geom1), int(c.geom2)}
            if self._floor_geom_id not in pair:
                continue
            for k, fg in enumerate(self._feet_geom_ids):
                if fg in pair and c.dist < 0:
                    out[k] = 1.0
        return out
