"""Plot saved observation traces (parity with reference common/plot_saved_obs.py).

Reads the pickle written by sim_infer (or a robot-side trace) and renders
(a) action-vs-joint-angle grids and (b) every obs channel with the canonical
101-dim layout labels, for sim-to-sim / sim-to-real diffing.

Usage: python -m open_duck_playground_tpu_torch.deploy.plot_saved_obs \
           mujoco_saved_obs.pkl [robot_saved_obs.pkl] [--out plots.png]
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np

NU = 14

# canonical 101-dim obs layout (envs/joystick.py _get_obs)
OBS_LAYOUT = [
    ("gyro", 3),
    ("accelerometer", 3),
    ("command", 7),
    ("joint_angles_delta", NU),
    ("joint_vel_scaled", NU),
    ("last_action", NU),
    ("last_last_action", NU),
    ("last_last_last_action", NU),
    ("motor_targets", NU),
    ("contacts", 2),
    ("imitation_phase", 2),
]


def channel_names():
    names = []
    for base, n in OBS_LAYOUT:
        for i in range(n):
            names.append(f"{base}[{i}]")
    return names


def plot(obs_files, out=None):
    import matplotlib

    if out is not None:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    traces = []
    for f in obs_files:
        with open(f, "rb") as fh:
            traces.append(np.asarray(pickle.load(fh)))

    names = channel_names()
    dim = traces[0].shape[1]
    ncols = 8
    nrows = int(np.ceil(dim / ncols))
    fig, axes = plt.subplots(nrows, ncols, figsize=(3 * ncols, 2 * nrows))
    for c in range(dim):
        ax = axes.flat[c]
        for trace, fname in zip(traces, obs_files):
            ax.plot(trace[:, c], label=fname, linewidth=0.8)
        ax.set_title(names[c] if c < len(names) else f"obs[{c}]", fontsize=7)
        ax.tick_params(labelsize=6)
    for c in range(dim, nrows * ncols):
        axes.flat[c].axis("off")
    fig.tight_layout()
    if out is not None:
        fig.savefig(out, dpi=110)
        print(f"wrote {out}")
    else:
        plt.show()


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("obs_files", nargs="+")
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    plot(args.obs_files, args.out)


if __name__ == "__main__":
    main()
