"""NumPy twin of envs/imitation.py (parity with custom_rewards_numpy.py)."""

from __future__ import annotations

import numpy as np

_W_LIN_VEL_XY = 1.0
_W_LIN_VEL_Z = 1.0
_W_ANG_VEL_XY = 0.5
_W_ANG_VEL_Z = 0.5
_W_JOINT_POS = 15.0
_W_JOINT_VEL = 1.0e-3
_W_CONTACT = 1.0


def reward_imitation(base_qpos, base_qvel, joints_qpos, joints_qvel, contacts,
                     reference_frame, cmd, use_imitation_reward=False):
    if not use_imitation_reward:
        return np.nan_to_num(0.0)

    cmd_norm = np.linalg.norm(cmd[:3])
    ref = np.asarray(reference_frame)

    ref_lin_vel = ref[34:37]
    ref_ang_vel = ref[37:40]
    base_lin_vel = base_qvel[:3]
    base_ang_vel = base_qvel[3:6]

    ref_joint_pos = np.concatenate([ref[0:16][:5], ref[0:16][11:]])
    ref_joint_vel = np.concatenate([ref[16:32][:5], ref[16:32][11:]])
    joint_pos = np.concatenate([joints_qpos[:5], joints_qpos[9:]])
    joint_vel = np.concatenate([joints_qvel[:5], joints_qvel[9:]])

    ref_contacts = np.where(ref[32:34] > 0.5, 1.0, 0.0)

    lin_vel_xy = np.exp(-8.0 * np.sum(np.square(base_lin_vel[:2] - ref_lin_vel[:2]))) * _W_LIN_VEL_XY
    lin_vel_z = np.exp(-8.0 * np.sum(np.square(base_lin_vel[2] - ref_lin_vel[2]))) * _W_LIN_VEL_Z
    ang_vel_xy = np.exp(-2.0 * np.sum(np.square(base_ang_vel[:2] - ref_ang_vel[:2]))) * _W_ANG_VEL_XY
    ang_vel_z = np.exp(-2.0 * np.sum(np.square(base_ang_vel[2] - ref_ang_vel[2]))) * _W_ANG_VEL_Z
    joint_pos_rew = -np.sum(np.square(joint_pos - ref_joint_pos)) * _W_JOINT_POS
    joint_vel_rew = -np.sum(np.square(joint_vel - ref_joint_vel)) * _W_JOINT_VEL
    contact_rew = np.sum(contacts == ref_contacts) * _W_CONTACT

    reward = (lin_vel_xy + lin_vel_z + ang_vel_xy + ang_vel_z
              + joint_pos_rew + joint_vel_rew + contact_rew)
    return np.nan_to_num(reward * (cmd_norm > 0.01))
