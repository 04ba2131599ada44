"""NumPy twin of envs/reference_motion.py (parity with
poly_reference_motion_numpy.py): same gait library, evaluated host-side for
the deploy loop and viewers."""

from __future__ import annotations

import pickle

import numpy as np


class PolyReferenceMotion:
    def __init__(self, polynomial_coefficients: str):
        with open(polynomial_coefficients, "rb") as f:
            raw = pickle.load(f)

        meta = next(iter(raw.values()))
        self.period = meta["period"]
        self.fps = meta["fps"]
        self.frame_offsets = meta["frame_offsets"]
        self.startend_double_support_ratio = meta["startend_double_support_ratio"]
        self.start_offset = int(self.startend_double_support_ratio * self.fps)
        self.nb_steps_in_period = int(self.period * self.fps)

        dxs, dys, dthetas = set(), set(), set()
        entries = {}
        for name, entry in raw.items():
            dx, dy, dth = (float(x) for x in name.split("_"))
            dxs.add(dx)
            dys.add(dy)
            dthetas.add(dth)
            entries[(dx, dy, dth)] = np.stack(
                [np.asarray(v)[::-1] for v in entry["coefficients"].values()]
            )

        self.dxs = sorted(dxs)
        self.dys = sorted(dys)
        self.dthetas = sorted(dthetas)
        self.dx_range = [min(0.0, self.dxs[0]), max(0.0, self.dxs[-1])]
        self.dy_range = [min(0.0, self.dys[0]), max(0.0, self.dys[-1])]
        self.dtheta_range = [min(0.0, self.dthetas[0]), max(0.0, self.dthetas[-1])]
        self.data_array = np.stack(
            [
                np.stack(
                    [
                        np.stack([entries[(dx, dy, dth)] for dth in self.dthetas])
                        for dy in self.dys
                    ]
                )
                for dx in self.dxs
            ]
        )

    def vel_to_index(self, dx, dy, dtheta):
        dx = np.clip(dx, self.dx_range[0], self.dx_range[1])
        dy = np.clip(dy, self.dy_range[0], self.dy_range[1])
        dtheta = np.clip(dtheta, self.dtheta_range[0], self.dtheta_range[1])
        ix = int(np.argmin(np.abs(np.asarray(self.dxs) - dx)))
        iy = int(np.argmin(np.abs(np.asarray(self.dys) - dy)))
        ith = int(np.argmin(np.abs(np.asarray(self.dthetas) - dtheta)))
        return ix, iy, ith

    def get_reference_motion(self, dx, dy, dtheta, i):
        ix, iy, ith = self.vel_to_index(dx, dy, dtheta)
        coeffs = self.data_array[ix, iy, ith]
        t = np.clip((i % self.nb_steps_in_period) / self.nb_steps_in_period, 0.0, 1.0)
        return np.array([np.polyval(c, t) for c in coeffs])


if __name__ == "__main__":
    from open_duck_playground_tpu_torch.models.open_duck_mini_v2 import constants

    PRM = PolyReferenceMotion(constants.reference_motion_path())
    vals = [
        PRM.get_reference_motion(0.0, -0.05, -0.1, i)[-1]
        for i in range(PRM.nb_steps_in_period)
    ]
    print("period", PRM.period, "steps", PRM.nb_steps_in_period)
    print("dim[-1] over one period:", np.round(vals, 4))
