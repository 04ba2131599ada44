"""The fused physics step's plain PyTorch version: n substeps of
``lane_physics.LanePhysics`` with ctrl held fixed, on ``(B,)`` tiles of any
device, returning the fields the env reads (qpos, qvel, qacc_warmstart and
the derived outputs of the last substep, taken before its integration).

A frozen copy of the plain path of the port's ``ops/cuda_step.FusedPhysics``
(``plain``, ``flatten_dr_fields``): no kernel, no build."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from duckbench.ref.ops.lane_physics import DR_FIELDS, LanePhysics
from duckbench.ref.ops.types import Model

# flat per-env row shapes of the DR fields
DR_SHAPES = {
    "geom_friction": ("ngeom", 3),
    "body_ipos": ("nbody", 3),
    "dof_frictionloss": ("nv",),
    "dof_armature": ("nv",),
    "body_mass": ("nbody",),
    "qpos0": ("nq",),
    "actuator_gainprm": ("nu", 3),
    "actuator_biasprm": ("nu", 3),
}


def flatten_dr_fields(m_batched: Model) -> Dict[str, torch.Tensor]:
    """The DR-batched model fields as flat contiguous ``(B, rows)`` tensors."""
    return {f: getattr(m_batched, f).reshape(getattr(m_batched, f).shape[0], -1).contiguous()
            for f in DR_FIELDS}


def _lanes(x: torch.Tensor):
    return [x[:, i] for i in range(x.shape[1])]


def _stack(lanes, like: torch.Tensor) -> torch.Tensor:
    """(B,) tiles (or python floats) -> (B, n), on `like`'s device."""
    B = like.shape[0]
    return torch.stack([torch.as_tensor(v, dtype=torch.float32, device=like.device).expand(B)
                        for v in lanes], 1)


class TwinPhysics:
    """n-substep physics step of one scene on (B,) tiles."""

    def __init__(self, model: Model):
        self.model = model.to("cpu")
        self.lane = LanePhysics(self.model)

    def out_widths(self) -> Dict[str, int]:
        m = self.model
        return dict(qpos=m.nq, qvel=m.nv, qacc_warmstart=m.nv, sensordata=m.nsensordata,
                    actuator_force=m.nu, contact_dist=m.ncon, site_xpos=3 * m.nsite,
                    site_xmat=9 * m.nsite)

    def __call__(self, qpos, qvel, warm, ctrl, n_substeps: int,
                 dr: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """qpos (B, nq), qvel / warm (B, nv), ctrl (B, nu); dr: flat (B, rows)
        DR fields or None. Returns the flat (B, width) outputs."""
        m = self.model
        dr_n = None
        if dr is not None:
            dr_n = {}
            for f in DR_FIELDS:
                dims = DR_SHAPES[f]
                x = dr[f]
                if len(dims) == 1:
                    dr_n[f] = _lanes(x)
                else:
                    n0, n1 = getattr(m, dims[0]), dims[1]
                    dr_n[f] = [[x[:, i * n1 + j] for j in range(n1)] for i in range(n0)]
        qp, qv, w, der = self.lane.step_n(_lanes(qpos), _lanes(qvel), _lanes(ctrl),
                                          n_substeps, dr=dr_n, warm=_lanes(warm))
        out = dict(qpos=_stack(qp, qpos), qvel=_stack(qv, qpos), qacc_warmstart=_stack(w, qpos))
        for k in ("sensordata", "actuator_force", "contact_dist", "site_xpos", "site_xmat"):
            out[k] = _stack(der[k], qpos)
        return out
