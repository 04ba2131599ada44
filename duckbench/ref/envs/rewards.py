"""Reward/cost term library, batched over envs (dim 0): the terms the
Joystick and Standing tasks wire up, and the rest of the JAX package's
``envs/rewards.py``, which the reference ships as a library.

Each term is NaN-guarded with nan_to_num like the reference (the NaN
termination guard relies on rewards staying finite).
"""

from __future__ import annotations

import math

import torch


def reward_tracking_lin_vel(commands, local_vel, tracking_sigma):
    """exp(-err/sigma) with a 0.1 m/s tolerance band on lateral velocity."""
    y_tol = 0.1
    err_x = torch.square(commands[:, 0] - local_vel[:, 0])
    err_y = torch.clamp(torch.abs(local_vel[:, 1] - commands[:, 1]) - y_tol, min=0.0)
    err = err_x + torch.square(err_y)
    return torch.nan_to_num(torch.exp(-err / tracking_sigma))


def reward_tracking_ang_vel(commands, ang_vel, tracking_sigma):
    err = torch.square(commands[:, 2] - ang_vel[:, 2])
    return torch.nan_to_num(torch.exp(-err / tracking_sigma))


# --- base motion ------------------------------------------------------------


def cost_lin_vel_z(global_linvel):
    return torch.nan_to_num(torch.square(global_linvel[:, 2]))


def cost_ang_vel_xy(global_angvel):
    return torch.nan_to_num(torch.sum(torch.square(global_angvel[:, :2]), dim=-1))


def cost_orientation(torso_zaxis):
    return torch.nan_to_num(torch.sum(torch.square(torso_zaxis[:, :2]), dim=-1))


def cost_base_height(base_height, base_height_target):
    return torch.nan_to_num(torch.square(base_height - base_height_target))


def reward_base_y_swing(base_y_speed, freq, amplitude, t, tracking_sigma):
    target = amplitude * torch.sin(2 * math.pi * freq * t)
    return torch.nan_to_num(torch.exp(-torch.square(target - base_y_speed) / tracking_sigma))


# --- energy -----------------------------------------------------------------


def cost_torques(torques):
    return torch.nan_to_num(torch.sum(torch.square(torques), dim=-1))


def cost_energy(qvel, qfrc_actuator):
    return torch.nan_to_num(torch.sum(torch.abs(qvel) * torch.abs(qfrc_actuator), dim=-1))


def cost_action_rate(act, last_act):
    return torch.nan_to_num(torch.sum(torch.square(act - last_act), dim=-1))


# --- pose / joints ----------------------------------------------------------


def cost_joint_pos_limits(qpos, soft_lowers, soft_uppers):
    out = -torch.clamp(qpos - soft_lowers, max=0.0)
    out = out + torch.clamp(qpos - soft_uppers, min=0.0)
    return torch.nan_to_num(torch.sum(out, dim=-1))


def cost_stand_still(commands, qpos, qvel, default_pose, ignore_head: bool = False):
    """L1 pose+velocity cost, gated on near-zero command (14-joint order:
    5 left leg, 4 head, 5 right leg)."""
    cmd_norm = torch.linalg.norm(commands[:, :3], dim=-1)
    if not ignore_head:
        pose_cost = torch.sum(torch.abs(qpos - default_pose), dim=-1)
        vel_cost = torch.sum(torch.abs(qvel), dim=-1)
    else:
        pose_cost = torch.sum(torch.abs(qpos[:, :5] - default_pose[:5]), dim=-1) + torch.sum(
            torch.abs(qpos[:, 9:] - default_pose[9:]), dim=-1
        )
        vel_cost = torch.sum(torch.abs(qvel[:, :5]), dim=-1) + torch.sum(
            torch.abs(qvel[:, 9:]), dim=-1)
    return torch.nan_to_num(pose_cost + vel_cost) * (cmd_norm < 0.01)


def cost_termination(done):
    return done


def reward_alive(batch: int, device) -> torch.Tensor:
    return torch.ones(batch, device=device)


def cost_head_pos(joints_qpos, joints_qvel, cmd):
    """Head-joint position tracking of the command, gated on a locomotion
    command (|cmd[:3]| > 0.01), as the reference gates it."""
    move_cmd_norm = torch.linalg.norm(cmd[:, :3], dim=-1)
    head_pos_error = torch.sum(torch.square(joints_qpos[:, 5:9] - cmd[:, 3:]), dim=-1)
    return torch.nan_to_num(head_pos_error) * (move_cmd_norm > 0.01)


def cost_joint_deviation_hip(qpos, cmd, hip_indices, default_pose):
    cost = torch.sum(torch.abs(qpos[:, hip_indices] - default_pose[hip_indices]), dim=-1)
    cost = cost * (torch.abs(cmd[:, 1]) > 0.1)
    return torch.nan_to_num(cost)


def cost_joint_deviation_knee(qpos, knee_indices, default_pose):
    return torch.nan_to_num(torch.sum(
        torch.abs(qpos[:, knee_indices] - default_pose[knee_indices]), dim=-1))


def cost_pose(qpos, default_pose, weights):
    return torch.nan_to_num(torch.sum(torch.square(qpos - default_pose) * weights, dim=-1))


# --- feet -------------------------------------------------------------------
# per env: contact (2,), velocities and positions (2, 3), one row per foot


def cost_feet_slip(contact, global_linvel):
    """`global_linvel` (B, 3): the base's velocity, the same for both feet
    (the JAX term's norm runs over its 2 xy components)."""
    body_vel = global_linvel[:, :2]
    return torch.nan_to_num(torch.sum(
        torch.linalg.norm(body_vel, dim=-1)[:, None] * contact, dim=-1))


def cost_feet_clearance(feet_vel, foot_pos, max_foot_height):
    vel_norm = torch.sqrt(torch.linalg.norm(feet_vel[..., :2], dim=-1))
    delta = torch.abs(foot_pos[..., -1] - max_foot_height)
    return torch.nan_to_num(torch.sum(delta * vel_norm, dim=-1))


def cost_feet_height(swing_peak, first_contact, max_foot_height):
    error = swing_peak / max_foot_height - 1.0
    return torch.nan_to_num(torch.sum(torch.square(error) * first_contact, dim=-1))


def reward_feet_air_time(air_time, first_contact, commands, threshold_min: float = 0.1,
                         threshold_max: float = 0.5):
    cmd_norm = torch.linalg.norm(commands[:, :3], dim=-1)
    air_time = (air_time - threshold_min) * first_contact
    air_time = torch.clamp(air_time, max=threshold_max - threshold_min)
    reward = torch.sum(air_time, dim=-1) * (cmd_norm > 0.01)
    return torch.nan_to_num(reward)


def reward_feet_phase(foot_pos, rz):
    """`rz`: the target foot heights, (B, 2), or (B,) for both feet."""
    rz = rz if rz.dim() > 1 else rz[:, None]
    error = torch.sum(torch.square(foot_pos[..., -1] - rz), dim=-1)
    return torch.nan_to_num(torch.exp(-error / 0.01))
