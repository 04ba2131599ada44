"""Domain randomization as a declarative perturbation recipe, batched.

Counterpart of the JAX package's ``envs/randomize.py``: the same 8
randomized model fields and the same distributions, applied in the same
order (entries compose: the torso mass offset reads the scaled masses). The
draws come from a ``torch.Generator`` for the whole batch at once; torch's
stream is not JAX's threefry, so the tests compare distributions, and carry
JAX's draws across (``interop.model_from_numpy``) where they need the same
numbers.

Reference quirks kept on purpose:
- ``FLOOR_GEOM_ID`` is 0, which in the compiled duck scenes is a visual
  robot geom (the floor geom is last), so the "floor friction" draw has no
  effect, as upstream;
- ``TORSO_BODY_ID=1`` is the massless base body, so the mass scale has no
  effect there and only the +-0.1 kg offset matters.
Pass ``use_names=True`` for the name-based targeting.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from duckbench.ref.ops.types import Model

FLOOR_GEOM_ID = 0
TORSO_BODY_ID = 1

RANDOMIZED_FIELDS = (
    "geom_friction",
    "body_ipos",
    "dof_frictionloss",
    "dof_armature",
    "body_mass",
    "qpos0",
    "actuator_gainprm",
    "actuator_biasprm",
)


class _Ctx(NamedTuple):
    floor_geom: int
    torso_body: int
    dof_addr: torch.Tensor   # leading dof address per actuated joint
    qpos_addr: torch.Tensor  # qpos address per actuated joint


def _make_ctx(model: Model, use_names: bool, device) -> _Ctx:
    if use_names:
        floor, torso = model.geom("floor"), model.body("trunk_assembly")
    else:
        floor, torso = FLOOR_GEOM_ID, TORSO_BODY_ID
    # actuated joints carry frictionloss; backlash dofs and the free joint don't
    first_dof = np.asarray(model.jnt_dofadr)
    has_fl = np.asarray(model.dof_hasfrictionloss, dtype=bool)[first_dof]
    return _Ctx(
        floor_geom=int(floor),
        torso_body=int(torso),
        dof_addr=torch.as_tensor(first_dof[has_fl], device=device),
        qpos_addr=torch.as_tensor(np.asarray(model.jnt_qposadr)[has_fl], device=device),
    )


Sampler = Callable[[Dict[str, torch.Tensor], _Ctx, Callable], None]


def _floor_friction(f, ctx, U):
    f["geom_friction"][:, ctx.floor_geom, 0] = U((), 0.5, 1.0)


def _joint_frictionloss(f, ctx, U):
    scale = U((ctx.dof_addr.numel(),), 0.9, 1.1)
    f["dof_frictionloss"][:, ctx.dof_addr] = f["dof_frictionloss"][:, ctx.dof_addr] * scale


def _joint_armature(f, ctx, U):
    scale = U((ctx.dof_addr.numel(),), 1.0, 1.05)
    f["dof_armature"][:, ctx.dof_addr] = f["dof_armature"][:, ctx.dof_addr] * scale


def _torso_com_jitter(f, ctx, U):
    f["body_ipos"][:, ctx.torso_body] = f["body_ipos"][:, ctx.torso_body] + U((3,), -0.05, 0.05)


def _link_mass_scale(f, ctx, U):
    f["body_mass"] = f["body_mass"] * U((f["body_mass"].shape[1],), 0.9, 1.1)


def _torso_mass_offset(f, ctx, U):
    f["body_mass"][:, ctx.torso_body] = f["body_mass"][:, ctx.torso_body] + U((), -0.1, 0.1)


def _home_pose_jitter(f, ctx, U):
    jitter = U((ctx.qpos_addr.numel(),), -0.03, 0.03)
    f["qpos0"][:, ctx.qpos_addr] = f["qpos0"][:, ctx.qpos_addr] + jitter


def _servo_kp_scale(f, ctx, U):
    # one draw drives gain and bias so the position servo stays consistent
    kp = f["actuator_gainprm"][:, :, 0] * U((f["actuator_gainprm"].shape[1],), 0.9, 1.1)
    f["actuator_gainprm"][:, :, 0] = kp
    f["actuator_biasprm"][:, :, 1] = -kp


# the randomization, as data, in the reference's order
_RECIPE = (
    ("floor friction U(0.5,1.0)", _floor_friction),
    ("joint frictionloss xU(0.9,1.1)", _joint_frictionloss),
    ("joint armature xU(1.0,1.05)", _joint_armature),
    ("torso CoM jitter +-5cm", _torso_com_jitter),
    ("link masses xU(0.9,1.1)", _link_mass_scale),
    ("torso mass +U(-0.1,0.1)kg", _torso_mass_offset),
    ("home pose jitter +-0.03rad", _home_pose_jitter),
    ("servo kp xU(0.9,1.1)", _servo_kp_scale),
)


def domain_randomize(model: Model, num_envs: int,
                     generator: Optional[torch.Generator] = None,
                     use_names: bool = False) -> Model:
    """One physics variant per env: the model with every field of
    ``RANDOMIZED_FIELDS`` given a leading env dim of ``num_envs``, on the
    model's device. Draws come from ``generator`` (a default-seeded one on
    that device if None)."""
    device = model.body_mass.device
    g = generator if generator is not None else torch.Generator(device=device).manual_seed(0)
    ctx = _make_ctx(model, use_names, device)

    def U(shape, lo, hi):
        u = torch.rand((num_envs,) + tuple(shape), generator=g, device=device)
        return lo + (hi - lo) * u

    fields = {f: getattr(model, f).expand((num_envs,) + getattr(model, f).shape).clone()
              for f in RANDOMIZED_FIELDS}
    for _, sampler in _RECIPE:
        sampler(fields, ctx, U)
    return model.tree_replace(fields)


def take_rows(model: Model, rows: slice) -> Model:
    """The randomized model with the rows `rows` of every field of
    ``RANDOMIZED_FIELDS``: one rank's envs of a batch randomized at its
    global size."""
    return model.tree_replace({f: getattr(model, f)[rows] for f in RANDOMIZED_FIELDS})
