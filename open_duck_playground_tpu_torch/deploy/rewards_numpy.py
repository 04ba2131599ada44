"""NumPy twin of envs/rewards.py (parity with reference common/rewards_numpy.py).

Used by the deploy path and as a cross-implementation check of the batched
reward math (the reference maintains the same split).
"""

from __future__ import annotations

import numpy as np


def reward_tracking_lin_vel(commands, local_vel, tracking_sigma):
    y_tol = 0.1
    err_x = np.square(commands[0] - local_vel[0])
    err_y = np.clip(np.abs(local_vel[1] - commands[1]) - y_tol, 0.0, None)
    err = err_x + np.square(err_y)
    return np.nan_to_num(np.exp(-err / tracking_sigma))


def reward_tracking_ang_vel(commands, ang_vel, tracking_sigma):
    return np.nan_to_num(np.exp(-np.square(commands[2] - ang_vel[2]) / tracking_sigma))


def cost_lin_vel_z(global_linvel):
    return np.nan_to_num(np.square(global_linvel[2]))


def cost_ang_vel_xy(global_angvel):
    return np.nan_to_num(np.sum(np.square(global_angvel[:2])))


def cost_orientation(torso_zaxis):
    return np.nan_to_num(np.sum(np.square(torso_zaxis[:2])))


def cost_base_height(base_height, base_height_target):
    return np.nan_to_num(np.square(base_height - base_height_target))


def cost_torques(torques):
    return np.nan_to_num(np.sum(np.square(torques)))


def cost_energy(qvel, qfrc_actuator):
    return np.nan_to_num(np.sum(np.abs(qvel) * np.abs(qfrc_actuator)))


def cost_action_rate(act, last_act):
    return np.nan_to_num(np.sum(np.square(act - last_act)))


def cost_joint_pos_limits(qpos, soft_lowers, soft_uppers):
    out = -np.clip(qpos - soft_lowers, None, 0.0)
    out += np.clip(qpos - soft_uppers, 0.0, None)
    return np.nan_to_num(np.sum(out))


def cost_stand_still(commands, qpos, qvel, default_pose, ignore_head=False):
    cmd_norm = np.linalg.norm(commands[:3])
    if not ignore_head:
        pose_cost = np.sum(np.abs(qpos - default_pose))
        vel_cost = np.sum(np.abs(qvel))
    else:
        pose_cost = np.sum(np.abs(qpos[:5] - default_pose[:5])) + np.sum(
            np.abs(qpos[9:] - default_pose[9:])
        )
        vel_cost = np.sum(np.abs(qvel[:5])) + np.sum(np.abs(qvel[9:]))
    return np.nan_to_num(pose_cost + vel_cost) * (cmd_norm < 0.01)


def cost_termination(done):
    return done


def reward_alive():
    return np.array(1.0)


def cost_head_pos(joints_qpos, joints_qvel, cmd):
    move_cmd_norm = np.linalg.norm(cmd[:3])
    head_pos_error = np.sum(np.square(joints_qpos[5:9] - cmd[3:]))
    return np.nan_to_num(head_pos_error) * (move_cmd_norm > 0.01)


def cost_feet_slip(contact, global_linvel):
    return np.nan_to_num(np.sum(np.linalg.norm(global_linvel[:2]) * contact))


def reward_feet_air_time(air_time, first_contact, commands,
                         threshold_min=0.1, threshold_max=0.5):
    cmd_norm = np.linalg.norm(commands[:3])
    air_time = (air_time - threshold_min) * first_contact
    air_time = np.clip(air_time, None, threshold_max - threshold_min)
    return np.nan_to_num(np.sum(air_time) * (cmd_norm > 0.01))
