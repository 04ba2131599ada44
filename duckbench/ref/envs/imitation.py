"""Imitation reward against the polynomial reference gait, batched.

Compares base velocities, (headless) joint pos/vel and foot contacts against
a 40-dim reference frame (layout in envs/reference_motion.py), gated to zero
for near-zero commands.
"""

from __future__ import annotations

import torch

_JOINT_POS = slice(0, 16)
_JOINT_VEL = slice(16, 32)
_FOOT_CONTACTS = slice(32, 34)
_LIN_VEL = slice(34, 37)
_ANG_VEL = slice(37, 40)

_W_LIN_VEL_XY = 1.0
_W_LIN_VEL_Z = 1.0
_W_ANG_VEL_XY = 0.5
_W_ANG_VEL_Z = 0.5
_W_JOINT_POS = 15.0
_W_JOINT_VEL = 1.0e-3
_W_CONTACT = 1.0


def _drop_head(x16: torch.Tensor) -> torch.Tensor:
    """(B, 16) reference joints -> (B, 10) leg joints."""
    return torch.cat([x16[:, :5], x16[:, 11:]], dim=1)


def _drop_head_robot(x14: torch.Tensor) -> torch.Tensor:
    """(B, 14) robot joints -> (B, 10) leg joints."""
    return torch.cat([x14[:, :5], x14[:, 9:]], dim=1)


def reward_imitation(base_qpos, base_qvel, joints_qpos, joints_qvel, contacts,
                     reference_frame, cmd, use_imitation_reward: bool = False):
    if not use_imitation_reward:
        return torch.zeros(base_qpos.shape[0], device=base_qpos.device)

    cmd_norm = torch.linalg.norm(cmd[:, :3], dim=-1)

    ref_lin_vel = reference_frame[:, _LIN_VEL]
    ref_ang_vel = reference_frame[:, _ANG_VEL]
    base_lin_vel = base_qvel[:, :3]
    base_ang_vel = base_qvel[:, 3:6]

    ref_joint_pos = _drop_head(reference_frame[:, _JOINT_POS])
    ref_joint_vel = _drop_head(reference_frame[:, _JOINT_VEL])
    joint_pos = _drop_head_robot(joints_qpos)
    joint_vel = _drop_head_robot(joints_qvel)

    ref_contacts = torch.where(reference_frame[:, _FOOT_CONTACTS] > 0.5, 1.0, 0.0)

    lin_vel_xy_rew = torch.exp(
        -8.0 * torch.sum(torch.square(base_lin_vel[:, :2] - ref_lin_vel[:, :2]), dim=-1)
    ) * _W_LIN_VEL_XY
    lin_vel_z_rew = torch.exp(
        -8.0 * torch.square(base_lin_vel[:, 2] - ref_lin_vel[:, 2])
    ) * _W_LIN_VEL_Z
    ang_vel_xy_rew = torch.exp(
        -2.0 * torch.sum(torch.square(base_ang_vel[:, :2] - ref_ang_vel[:, :2]), dim=-1)
    ) * _W_ANG_VEL_XY
    ang_vel_z_rew = torch.exp(
        -2.0 * torch.square(base_ang_vel[:, 2] - ref_ang_vel[:, 2])
    ) * _W_ANG_VEL_Z

    joint_pos_rew = -torch.sum(torch.square(joint_pos - ref_joint_pos), dim=-1) * _W_JOINT_POS
    joint_vel_rew = -torch.sum(torch.square(joint_vel - ref_joint_vel), dim=-1) * _W_JOINT_VEL
    contact_rew = torch.sum(contacts.float() == ref_contacts, dim=-1) * _W_CONTACT

    reward = (
        lin_vel_xy_rew
        + lin_vel_z_rew
        + ang_vel_xy_rew
        + ang_vel_z_rew
        + joint_pos_rew
        + joint_vel_rew
        + contact_rew
    )
    return torch.nan_to_num(reward * (cmd_norm > 0.01))
