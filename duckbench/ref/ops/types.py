"""Model, Data, Contact as plain dataclasses of torch tensors.

Counterpart of ``open_duck_playground_tpu/ops/types.py``. The field names and
shapes of ``Model`` are the JAX package's, so a model compiled by either
package can be compared field by field. Structural metadata (parents,
addresses, types) stays in hashable numpy ``StaticArray``s; physics
parameters are float32 tensors.

A ``Model`` is unbatched, except that domain randomization gives the fields
of ``envs.randomize.RANDOMIZED_FIELDS`` a leading env dimension ``(B, ...)``.
``Data`` and ``Contact`` always carry a leading env dimension: the port
steps a batch of envs, never one env under ``vmap``. Their required fields
are the ones the env path reads after a step, which the fused kernel
computes (``ops/cuda_step.py``); the optional ones (None by default) are
the rest of the JAX package's fields, which only the general pipeline
(``ops/forward.py``) fills.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List, Optional, Tuple

import torch

from duckbench.ref.utils.static import StaticArray


class JointType(enum.IntEnum):
    FREE = 0
    BALL = 1
    SLIDE = 2
    HINGE = 3


class GeomType(enum.IntEnum):
    PLANE = 0
    HFIELD = 1
    SPHERE = 2
    CAPSULE = 3
    BOX = 6
    MESH = 7


class SensorType(enum.IntEnum):
    GYRO = 0
    VELOCIMETER = 1
    ACCELEROMETER = 2
    FRAMEXAXIS = 3
    FRAMEZAXIS = 4
    FRAMELINVEL = 5
    FRAMEANGVEL = 6
    FRAMEPOS = 7
    FRAMEQUAT = 8


class PairType(enum.IntEnum):
    PLANE_HULL = 0
    HFIELD_HULL = 1
    HULL_HULL = 2


class _Replace:
    def replace(self, **updates):
        return dataclasses.replace(self, **updates)


@dataclasses.dataclass(frozen=True)
class Option(_Replace):
    gravity: torch.Tensor  # (3,)
    timestep: float = None
    iterations: int = None
    ls_iterations: int = None
    impratio: float = None


@dataclasses.dataclass(frozen=True)
class Model(_Replace):
    # ----- option -----
    opt: Option

    # ----- sizes -----
    nq: int = None
    nv: int = None
    nu: int = None
    nbody: int = None
    njnt: int = None
    ngeom: int = None
    nsite: int = None
    nsensordata: int = None
    npair: int = None
    ncon: int = None  # npair * max points per pair (4)

    # ----- bodies -----
    body_parentid: StaticArray = None
    body_rootid: StaticArray = None
    body_jntadr: StaticArray = None
    body_jntnum: StaticArray = None
    body_dofadr: StaticArray = None
    body_dofnum: StaticArray = None
    body_pos: torch.Tensor = None  # (nbody, 3)
    body_quat: torch.Tensor = None  # (nbody, 4)
    body_ipos: torch.Tensor = None  # (nbody, 3)
    body_iquat: torch.Tensor = None  # (nbody, 4)
    body_mass: torch.Tensor = None  # (nbody,)
    body_inertia: torch.Tensor = None  # (nbody, 3) principal moments
    body_invweight0: torch.Tensor = None  # (nbody, 2) [trans, rot]
    body_subtreemass: torch.Tensor = None  # (nbody,)

    # ----- joints -----
    jnt_type: StaticArray = None
    jnt_qposadr: StaticArray = None
    jnt_dofadr: StaticArray = None
    jnt_bodyid: StaticArray = None
    jnt_limited: StaticArray = None
    jnt_pos: torch.Tensor = None  # (njnt, 3)
    jnt_axis: torch.Tensor = None  # (njnt, 3)
    jnt_range: torch.Tensor = None  # (njnt, 2)
    jnt_solref: torch.Tensor = None  # (njnt, 2)
    jnt_solimp: torch.Tensor = None  # (njnt, 5)
    jnt_margin: torch.Tensor = None  # (njnt,)

    # ----- dofs -----
    dof_bodyid: StaticArray = None
    dof_jntid: StaticArray = None
    dof_parentid: StaticArray = None  # -1 for root dofs
    dof_hasfrictionloss: StaticArray = None
    dof_armature: torch.Tensor = None  # (nv,)
    dof_damping: torch.Tensor = None  # (nv,)
    dof_frictionloss: torch.Tensor = None  # (nv,)
    dof_invweight0: torch.Tensor = None  # (nv,)
    dof_solref: torch.Tensor = None  # (nv, 2) for friction rows
    dof_solimp: torch.Tensor = None  # (nv, 5)

    # ----- geoms -----
    geom_type: StaticArray = None
    geom_bodyid: StaticArray = None
    geom_dataid: StaticArray = None  # hull index for MESH, hfield index
    geom_contype: StaticArray = None
    geom_conaffinity: StaticArray = None
    geom_condim: StaticArray = None
    geom_priority: StaticArray = None
    geom_pos: torch.Tensor = None  # (ngeom, 3)
    geom_quat: torch.Tensor = None  # (ngeom, 4)
    geom_size: torch.Tensor = None  # (ngeom, 3)
    geom_friction: torch.Tensor = None  # (ngeom, 3)
    geom_solref: torch.Tensor = None  # (ngeom, 2)
    geom_solimp: torch.Tensor = None  # (ngeom, 5)
    geom_margin: torch.Tensor = None  # (ngeom,)
    geom_gap: torch.Tensor = None  # (ngeom,)

    # ----- sites -----
    site_bodyid: StaticArray = None
    site_pos: torch.Tensor = None  # (nsite, 3)
    site_quat: torch.Tensor = None  # (nsite, 4)

    # ----- collision hulls (padded) -----
    hull_vert: torch.Tensor = None  # (nhull, HV, 3) geom-frame hull vertices
    hull_nvert: StaticArray = None  # (nhull,) actual counts (pad repeats v0)
    hull_face_n: torch.Tensor = None  # (nhull, HF, 3) face normals (geom frame)
    hull_face_d: torch.Tensor = None  # (nhull, HF) face plane offsets
    hull_nface: StaticArray = None  # (nhull,)

    # ----- heightfield -----
    hfield_data: Optional[torch.Tensor] = None  # (nrow, ncol) normalized [0,1]
    hfield_size: Optional[torch.Tensor] = None  # (4,) rx, ry, z_top, z_base
    hfield_nrow: int = None
    hfield_ncol: int = None

    # ----- actuators (position servos over joints) -----
    actuator_trnid: StaticArray = None  # joint id per actuator
    actuator_gainprm: torch.Tensor = None  # (nu, 3) [kp, 0, 0]
    actuator_biasprm: torch.Tensor = None  # (nu, 3) [0, -kp, -kv]
    actuator_ctrlrange: torch.Tensor = None  # (nu, 2)
    actuator_forcerange: torch.Tensor = None  # (nu, 2)
    actuator_gear: torch.Tensor = None  # (nu,)

    # ----- sensors -----
    sensor_type: StaticArray = None
    sensor_objid: StaticArray = None  # site id
    sensor_adr: StaticArray = None
    sensor_dim: StaticArray = None

    # ----- static contact pairs -----
    pair_geom1: StaticArray = None
    pair_geom2: StaticArray = None
    pair_type: StaticArray = None  # PairType
    pair_condim: StaticArray = None

    # ----- reference configuration -----
    qpos0: torch.Tensor = None  # (nq,)

    # ----- names / keyframes (static metadata) -----
    names: Any = None  # Names
    keyframes: Any = None  # Keyframes

    # ------------------------------------------------------------------
    def tree_replace(self, updates: Dict[str, Any]) -> "Model":
        """Replace tensor fields by name (the JAX package's spelling)."""
        return self.replace(**updates)

    def to(self, device) -> "Model":
        """The same model with every tensor field on `device`."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                out[f.name] = v.to(device)
        return self.replace(opt=self.opt.replace(gravity=self.opt.gravity.to(device)),
                            **out)

    # --- name lookups (mirror mujoco name2id utilities) ---
    def body(self, name: str) -> int:
        return self.names.body[name]

    def joint(self, name: str) -> int:
        return self.names.joint[name]

    def geom(self, name: str) -> int:
        return self.names.geom[name]

    def site(self, name: str) -> int:
        return self.names.site[name]

    def actuator(self, name: str) -> int:
        return self.names.actuator[name]

    def sensor(self, name: str) -> int:
        return self.names.sensor[name]

    def keyframe(self, name: str):
        return self.keyframes[name]

    def find_pair(self, g1: int, g2: int) -> int:
        """Static contact-pair index for a geom pair (order-insensitive)."""
        for i in range(self.npair):
            a, b = int(self.pair_geom1[i]), int(self.pair_geom2[i])
            if (a, b) == (g1, g2) or (a, b) == (g2, g1):
                return i
        raise ValueError(f"no contact pair for geoms ({g1}, {g2})")


class Names:
    """Hashable name->id registry for all object classes."""

    def __init__(self, **kwargs: Dict[str, int]):
        self._d = {k: dict(v) for k, v in kwargs.items()}
        self._lists = {k: _ids_to_list(v) for k, v in self._d.items()}
        self._hash = hash(tuple((k, tuple(sorted(v.items()))) for k, v in sorted(self._d.items())))

    def __getattr__(self, k):
        try:
            return self._d[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def id2name(self, kind: str, i: int) -> str:
        return self._lists[kind][i]

    def list(self, kind: str) -> List[str]:
        return list(self._lists[kind])

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return isinstance(other, Names) and self._d == other._d


def _ids_to_list(d: Dict[str, int]) -> List[str]:
    out = [""] * (max(d.values()) + 1 if d else 0)
    for k, v in d.items():
        out[v] = k
    return out


class Keyframes:
    """Hashable keyframe store: name -> (qpos, ctrl) numpy arrays."""

    def __init__(self, frames: Dict[str, Tuple]):
        self._frames = {
            k: (StaticArray(q), StaticArray(c)) for k, (q, c) in frames.items()
        }
        self._hash = hash(tuple(sorted((k, q, c) for k, (q, c) in self._frames.items())))

    def __getitem__(self, name: str):
        return _Keyframe(*self._frames[name])

    def __contains__(self, name):
        return name in self._frames

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return isinstance(other, Keyframes) and self._frames == other._frames


class _Keyframe:
    def __init__(self, qpos: StaticArray, ctrl: StaticArray):
        self.qpos = qpos.np
        self.ctrl = ctrl.np


@dataclasses.dataclass(frozen=True)
class Contact(_Replace):
    """Static-shape contact set: ncon = npair * 4 candidate points."""

    dist: torch.Tensor  # (B, ncon) penetration depth (negative = penetrating)
    pos: Optional[torch.Tensor] = None  # (B, ncon, 3) world midpoint
    frame: Optional[torch.Tensor] = None  # (B, ncon, 3, 3) rows: normal, tangent1, tangent2
    friction: Optional[torch.Tensor] = None  # (B, ncon, 3) combined friction
    solref: Optional[torch.Tensor] = None  # (B, ncon, 2)
    solimp: Optional[torch.Tensor] = None  # (B, ncon, 5)
    geom1: Optional[torch.Tensor] = None  # (B, ncon) int32 (static mapping)
    geom2: Optional[torch.Tensor] = None  # (B, ncon)
    efc_valid: Optional[torch.Tensor] = None  # (B, ncon) bool: candidate exists


@dataclasses.dataclass(frozen=True)
class Data(_Replace):
    """Dynamic state of a batch of envs: every field has a leading env dim."""

    qpos: torch.Tensor  # (B, nq)
    qvel: torch.Tensor  # (B, nv)
    ctrl: torch.Tensor  # (B, nu)
    qacc_warmstart: torch.Tensor  # (B, nv) previous solve's qacc (Newton start)
    time: torch.Tensor  # (B,)
    site_xpos: torch.Tensor  # (B, nsite, 3)
    site_xmat: torch.Tensor  # (B, nsite, 3, 3)
    actuator_force: torch.Tensor  # (B, nu)
    sensordata: torch.Tensor  # (B, nsensordata)
    contact: Contact
    # filled by the general pipeline only
    qacc: Optional[torch.Tensor] = None  # (B, nv)
    xpos: Optional[torch.Tensor] = None  # (B, nbody, 3)
    xquat: Optional[torch.Tensor] = None  # (B, nbody, 4)
    xmat: Optional[torch.Tensor] = None  # (B, nbody, 3, 3)
    xipos: Optional[torch.Tensor] = None  # (B, nbody, 3)
    subtree_com: Optional[torch.Tensor] = None  # (B, nbody, 3)
    qfrc_actuator: Optional[torch.Tensor] = None  # (B, nv)
    qfrc_smooth: Optional[torch.Tensor] = None  # (B, nv)
    qfrc_constraint: Optional[torch.Tensor] = None  # (B, nv)
    cvel: Optional[torch.Tensor] = None  # (B, nbody, 6) body spatial velocity @ root-com origin

    def replace_qpos(self, qpos: torch.Tensor) -> "Data":
        return self.replace(qpos=qpos)
