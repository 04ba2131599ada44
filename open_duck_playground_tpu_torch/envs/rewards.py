"""Reward/cost terms of the Joystick and Standing tasks, batched over envs
(dim 0).

Each term is NaN-guarded with nan_to_num like the reference (the NaN
termination guard relies on rewards staying finite).
"""

from __future__ import annotations

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


def cost_orientation(torso_zaxis):
    return torch.nan_to_num(torch.sum(torch.square(torso_zaxis[:, :2]), dim=-1))


def cost_torques(torques):
    return torch.nan_to_num(torch.sum(torch.square(torques), dim=-1))


def cost_action_rate(act, last_act):
    return torch.nan_to_num(torch.sum(torch.square(act - last_act), dim=-1))


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


def reward_alive(batch: int, device) -> torch.Tensor:
    return torch.ones(batch, device=device)


def cost_head_pos(joints_qpos, joints_qvel, cmd):
    """Head-joint position tracking of the command, gated on a locomotion
    command (|cmd[:3]| > 0.01), as the reference gates it."""
    move_cmd_norm = torch.linalg.norm(cmd[:, :3], dim=-1)
    head_pos_error = torch.sum(torch.square(joints_qpos[:, 5:9] - cmd[:, 3:]), dim=-1)
    return torch.nan_to_num(head_pos_error) * (move_cmd_norm > 0.01)
