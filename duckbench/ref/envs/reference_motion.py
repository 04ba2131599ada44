"""Polynomial-compressed reference gait library, on the env's device.

The gait library (``data/polynomial_coefficients.pkl``) stores, for each
command grid point "dx_dy_dtheta" (6 x 4 x 10 grid), degree-15 polynomial
coefficients for each of 40 motion dimensions over one gait period.

Frame layout:
  [0:16]  joint positions (incl. neck/head/antennas)
  [16:32] joint velocities
  [32:34] foot contacts (left, right)
  [34:37] base linear velocity
  [37:40] base angular velocity

The library is one (6, 4, 10, 40, 16) tensor; lookup is clip + nearest-grid
argmin + gather per env, evaluation is Horner over the coefficients.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch


class PolyReferenceMotion:
    def __init__(self, polynomial_coefficients: str, device="cpu"):
        with open(polynomial_coefficients, "rb") as f:
            raw = pickle.load(f)

        dxs, dys, dthetas = set(), set(), set()
        meta = next(iter(raw.values()))
        self.period = meta["period"]
        self.fps = meta["fps"]
        self.frame_offsets = meta["frame_offsets"]
        self.startend_double_support_ratio = meta["startend_double_support_ratio"]
        self.start_offset = int(self.startend_double_support_ratio * self.fps)
        self.nb_steps_in_period = int(self.period * self.fps)

        entries = {}
        for name, entry in raw.items():
            dx, dy, dth = (float(x) for x in name.split("_"))
            dxs.add(dx)
            dys.add(dy)
            dthetas.add(dth)
            # highest degree first for Horner evaluation
            entries[(dx, dy, dth)] = np.stack(
                [np.asarray(v)[::-1] for v in entry["coefficients"].values()]
            )

        self.dxs = sorted(dxs)
        self.dys = sorted(dys)
        self.dthetas = sorted(dthetas)
        self.dx_range = [min(0.0, self.dxs[0]), max(0.0, self.dxs[-1])]
        self.dy_range = [min(0.0, self.dys[0]), max(0.0, self.dys[-1])]
        self.dtheta_range = [min(0.0, self.dthetas[0]), max(0.0, self.dthetas[-1])]

        grid = np.stack([
            np.stack([
                np.stack([entries[(dx, dy, dth)] for dth in self.dthetas])
                for dy in self.dys
            ])
            for dx in self.dxs
        ])  # (ndx, ndy, ndth, 40, deg+1)
        f32 = dict(dtype=torch.float32, device=device)
        self.data_array = torch.as_tensor(grid, **f32)
        self._dx_grid = torch.as_tensor(self.dxs, **f32)
        self._dy_grid = torch.as_tensor(self.dys, **f32)
        self._dth_grid = torch.as_tensor(self.dthetas, **f32)
        self.nb_dims = grid.shape[3]

    def vel_to_index(self, dx, dy, dtheta):
        """Nearest grid indices per env (argmin |grid - cmd|, ties -> first)."""
        dx = torch.clamp(dx, self.dx_range[0], self.dx_range[1])
        dy = torch.clamp(dy, self.dy_range[0], self.dy_range[1])
        dtheta = torch.clamp(dtheta, self.dtheta_range[0], self.dtheta_range[1])
        ix = torch.argmin(torch.abs(self._dx_grid - dx[:, None]), dim=1)
        iy = torch.argmin(torch.abs(self._dy_grid - dy[:, None]), dim=1)
        ith = torch.argmin(torch.abs(self._dth_grid - dtheta[:, None]), dim=1)
        return ix, iy, ith

    def get_reference_motion(self, dx, dy, dtheta, i) -> torch.Tensor:
        """(B, 40) reference frames for commands (dx, dy, dtheta) (each (B,))
        at clock values i ((B,) tensor or a python number)."""
        ix, iy, ith = self.vel_to_index(dx, dy, dtheta)
        coeffs = self.data_array[ix, iy, ith]  # (B, 40, deg+1)
        n = self.nb_steps_in_period
        if isinstance(i, torch.Tensor):
            t = (i % n) / n
        else:
            t = torch.full(dx.shape, (i % n) / n, dtype=coeffs.dtype, device=coeffs.device)
        t = torch.clamp(t, 0.0, 1.0).to(coeffs.dtype)[:, None]
        out = coeffs[:, :, 0]
        for k in range(1, coeffs.shape[2]):
            out = out * t + coeffs[:, :, k]
        return out
