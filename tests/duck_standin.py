"""Generated stand-in for the Open Duck Mini v2 asset tree (no download).

The real duck's MJCF, STL meshes and gait pickle are not in the repository.
``write_standin(root)`` writes a tree with the same layout
(``xmls/`` and ``data/``) and every name and width the envs look up, so both
the JAX package and its PyTorch port can build ``Joystick`` on it:

- ``world -> base`` (body 1: massless, carries the ``floating_base`` free
  joint) ``-> trunk_assembly`` (the torso, holds the ``imu`` site) ``->``
  10 leg joints in ``constants.JOINTS_ORDER_NO_HEAD`` order and 4 head
  joints, in the real actuator order (5 left leg, 4 head, 5 right leg):
  nq=21, nv=20, nu=14 (backlash scene: 10 ``_backlash`` twins, nq=31, nv=30);
- geom 0 is a non-colliding visual box on the trunk (the randomization's
  ``FLOOR_GEOM_ID=0`` quirk), the floor plane is the last geom;
- the soles ``left_foot_bottom_tpu`` / ``right_foot_bottom_tpu`` are one
  binary-STL mesh, a convex symmetric octagonal slab (16 vertices) whose 8
  bottom vertices lie in one plane, so resting soles tie on depth;
- contact pairs: floor-left, floor-right (PLANE_HULL, HFIELD_HULL on the
  rough scene), left-right (HULL_HULL);
- the 15 sensors of the real duck, in its order (``upvector`` z is
  sensordata[11]);
- ``data/polynomial_coefficients.pkl``: a synthetic 6x4x10 ``dx_dy_dtheta``
  gait grid, 40 dims, degree 15.

Sizes: total mass 1.66 kg (trunk 0.8 kg), leg length 0.185 m from the
hip_yaw joint to the sole when straight, standing base height 0.1992 m at
``home`` (hips 0.3 rad, knees -0.6 rad, ankles 0.3 rad, soles flat on the
floor). Under ``ctrl = home ctrl`` it stands: 20 control steps keep base z
in [0.18, 0.21] and upvector z above 0.95 (``STAND_Z_BAND``).

The rough scene ``scene_rough_terrain_backlash.xml`` is the backlash duck on
a heightfield: ``xmls/assets/hfield.png``, a 256x256 8-bit PNG made with
``judge_heightfield``'s recipe (seed ``HFIELD_SEED``), in the reference's
``<hfield size="10 10 .01 0.1"/>`` (10 x 10 m, bumps up to 1 cm), on a geom
named ``floor`` (friction 1.0, condim 3) at the origin of a static body
with no ``<inertial>`` (so its mass comes from the geom). The reference's
exact layout is not in the repository. Here the terrain sits where the
flat floor is (z = 0 at the lowest point) and the home keyframe stands
``rough_home_lift()`` (7.5 mm) higher than the flat one, so that at reset the
highest point of the terrain under the two soles touches a sole vertex and
the duck stands on the bumps.

It also holds what the fused kernel is checked with on the stand-in:
``settled_states`` and the ``parity`` limits on |kernel - twin|, shared by
``chip_smoke.py``, ``tests/test_torch_cuda.py`` and the CPU tests.

Imports numpy, scipy, Pillow and the port (for the heightfield recipe and
its PNG writer), never jax, so the card's machine can run it.
"""

from __future__ import annotations

import os
import pickle
import struct
from typing import Optional

import numpy as np

LEG = ("hip_yaw", "hip_roll", "hip_pitch", "knee", "ankle")
HEAD = ("neck_pitch", "head_pitch", "head_yaw", "head_roll")
# leg chain: (joint, axis, body offset from its parent body, mass, com)
_LEG_CHAIN = (
    ("hip_yaw", "0 0 1", None, 0.05, (0.0, 0.0, -0.005)),
    ("hip_roll", "1 0 0", (0.0, 0.0, -0.01), 0.05, (0.0, 0.0, -0.005)),
    ("hip_pitch", "0 1 0", (0.0, 0.0, -0.01), 0.08, (0.0, 0.0, -0.0325)),
    ("knee", "0 1 0", (0.0, 0.0, -0.065), 0.07, (0.0, 0.0, -0.0325)),
    ("ankle", "0 1 0", (0.0, 0.0, -0.065), 0.08, (0.01, 0.0, -0.02)),
)
_HEAD_CHAIN = (
    ("neck_pitch", "0 1 0", (0.03, 0.0, 0.04), 0.05, (0.0, 0.0, 0.02)),
    ("head_pitch", "0 1 0", (0.0, 0.0, 0.04), 0.05, (0.0, 0.0, 0.01)),
    ("head_yaw", "0 0 1", (0.0, 0.0, 0.02), 0.05, (0.0, 0.0, 0.01)),
    ("head_roll", "1 0 0", (0.0, 0.0, 0.02), 0.05, (0.01, 0.0, 0.01)),
)
_RANGES = {
    "hip_yaw": (-0.5, 0.5), "hip_roll": (-0.5, 0.5), "hip_pitch": (-1.2, 1.2),
    "knee": (-1.5, 1.5), "ankle": (-1.2, 1.2),
    "neck_pitch": (-0.34, 1.1), "head_pitch": (-0.78, 0.78),
    "head_yaw": (-1.5, 1.5), "head_roll": (-0.5, 0.5),
}
HIP_Y = 0.05            # lateral hip offset
HIP_Z = -0.02           # hip_yaw joint below the trunk origin
SOLE_DROP = 0.035       # sole bottom below the ankle body origin
HOME_LEG = (0.0, 0.0, 0.3, -0.6, 0.3)
SOLE_HALF = (0.04, 0.02, 0.005)  # octagon half extents, half thickness
SOLE_CHAMFER = 0.01
STAND_Z_BAND = (0.18, 0.21)  # base z after 20 control steps at home
# rough scene: the terrain (judge_heightfield's recipe at 256 rows, fixed
# seed) and the reference's <hfield size>: 10 x 10 m, 1 cm bumps, 0.1 m base
HFIELD_NROW = 256
HFIELD_SEED = 1
HFIELD_SIZE = (10.0, 10.0, 0.01, 0.1)


def _sole_vertices() -> np.ndarray:
    hx, hy, hz = SOLE_HALF
    c = SOLE_CHAMFER
    ring = [(hx, hy - c), (hx - c, hy), (-hx + c, hy), (-hx, hy - c),
            (-hx, -hy + c), (-hx + c, -hy), (hx - c, -hy), (hx, -hy + c)]
    return np.array([(x, y, z) for z in (-hz, hz) for (x, y) in ring])


def _binary_stl(verts: np.ndarray) -> bytes:
    """Outward-oriented triangles of the convex hull of `verts`."""
    from scipy.spatial import ConvexHull

    hull = ConvexHull(verts)
    centre = verts.mean(0)
    tris = []
    for simplex in hull.simplices:
        a, b, c = verts[simplex]
        n = np.cross(b - a, c - a)
        if np.dot(n, a - centre) < 0:
            b, c, n = c, b, -n
        tris.append((n / np.linalg.norm(n), a, b, c))
    out = [b"stand-in duck sole".ljust(80, b" "), struct.pack("<I", len(tris))]
    for tri in tris:
        out.append(struct.pack("<12f", *np.concatenate(tri).astype(np.float32)))
        out.append(b"\x00\x00")
    return b"".join(out)


def _rot(axis: str, angle: float) -> np.ndarray:
    x, y, z = (float(v) for v in axis.split())
    k = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k


def _ankle_pose(side: float):
    """Ankle body pose relative to the base at the home pose (side +1 left,
    -1 right)."""
    pos, R = np.array([0.0, side * HIP_Y, HIP_Z]), np.eye(3)
    for (_, axis, off, _, _), q in zip(_LEG_CHAIN, HOME_LEG):
        if off is not None:
            pos = pos + R @ np.asarray(off)
        R = R @ _rot(axis, q)
    return pos, R


def standing_height() -> float:
    """Base height that puts both soles flat on z=0 at the home pose."""
    pos, R = _ankle_pose(1.0)
    sole = pos + R @ np.array([0.01, 0.0, -SOLE_DROP])
    return float(-sole[2])


def _terrain() -> np.ndarray:
    from open_duck_playground_tpu_torch.models.open_duck_mini_v2.judge_terrain import (
        judge_heightfield,
    )

    return judge_heightfield(HFIELD_NROW, HFIELD_SEED)


def terrain_heights() -> np.ndarray:
    """The rough scene's terrain as the compiler reads it back from the
    8-bit PNG: (HFIELD_NROW, HFIELD_NROW) in [0, 1], row index along +y."""
    return (_terrain() * 255).astype(np.uint8) / 255.0


def surface_height(data: np.ndarray, x: float, y: float) -> float:
    """Terrain surface z at world (x, y), for the terrain geom at the origin:
    the collider's cell lookup and triangulated interpolation (the twin's
    _hf_indices / _hf_interp), in float64."""
    nrow, ncol = data.shape
    rx, ry, ztop = HFIELD_SIZE[:3]
    gx = min(max((x + rx) / (2 * rx) * (ncol - 1), 0.0), ncol - 1.001)
    gy = min(max((y + ry) / (2 * ry) * (nrow - 1), 0.0), nrow - 1.001)
    ix, iy = int(np.floor(gx)), int(np.floor(gy))
    fx, fy = gx - ix, gy - iy
    z00, z10, z01, z11 = (ztop * data[iy + a, ix + b] for a, b in ((0, 0), (0, 1), (1, 0), (1, 1)))
    if fx + fy < 1.0:
        return z00 + fx * (z10 - z00) + fy * (z01 - z00)
    return z11 + (1.0 - fx) * (z01 - z11) + (1.0 - fy) * (z10 - z11)


def rough_home_lift() -> float:
    """Highest terrain point under the 16 sole-bottom vertices at the home
    pose (base at x = y = 0): the rough scene's home keyframe stands this
    much higher than the flat one, so the soles rest on the bumps."""
    data = terrain_heights()
    bottom = _sole_vertices()[:8] + np.array([0.01, 0.0, -SOLE_DROP + SOLE_HALF[2]])
    lift = 0.0
    for side in (1.0, -1.0):
        pos, R = _ankle_pose(side)
        for v in bottom:
            w = pos + R @ v
            lift = max(lift, surface_height(data, float(w[0]), float(w[1])))
    return lift


def _chain_xml(prefix, chain, backlash, indent, leaf, first_off=None):
    if not chain:
        return leaf
    (name, axis, off, mass, com), rest = chain[0], chain[1:]
    off = first_off if off is None else off
    j = f"{prefix}{name}"
    lo, hi = _RANGES[name]
    twin = ""
    if backlash:
        twin = (f'{indent}  <joint name="{j}_backlash" class="backlash" '
                f'axis="{axis}"/>\n')
    inner = _chain_xml(prefix, rest, backlash, indent + "  ", leaf)
    return (
        f'{indent}<body name="{j}_link" pos="{off[0]} {off[1]} {off[2]}">\n'
        f'{indent}  <inertial pos="{com[0]} {com[1]} {com[2]}" mass="{mass}" '
        f'diaginertia="2e-5 2e-5 1e-5"/>\n'
        f'{indent}  <joint name="{j}" class="sts3215" axis="{axis}" '
        f'range="{lo} {hi}"/>\n{twin}{inner}{indent}</body>\n'
    )


def _foot_leaf(side: str) -> str:
    indent = "  " * 10
    return (
        f'{indent}<geom name="{side}_foot_bottom_tpu" type="mesh" '
        f'mesh="foot_bottom_tpu" pos="0.01 0 {-SOLE_DROP + SOLE_HALF[2]}"/>\n'
        f'{indent}<site name="{side}_foot" pos="0.01 0 {-SOLE_DROP}"/>\n'
    )


def scene_xml(backlash: bool, rough: bool = False) -> str:
    """The flat scene, or with `rough` the heightfield scene: the floor
    plane becomes the terrain geom and the home keyframe rises by
    rough_home_lift()."""
    kp = 17.11 if backlash else 13.37
    h = standing_height() + (rough_home_lift() if rough else 0.0)
    if rough:
        hfield = ('    <hfield name="hfield" file="assets/hfield.png" size="'
                  + " ".join(str(v) for v in HFIELD_SIZE) + '"/>\n')
        floor = '<geom name="floor" type="hfield" hfield="hfield" friction="1.0" condim="3"/>'
    else:
        hfield = ""
        floor = '<geom name="floor" type="plane" size="0 0 0.05" friction="0.6" condim="3"/>'
    legs = {
        side: _chain_xml(f"{side}_", _LEG_CHAIN, backlash, "      ",
                         _foot_leaf(side), first_off=(0.0, sgn * HIP_Y, HIP_Z))
        for side, sgn in (("left", 1.0), ("right", -1.0))
    }
    head = _chain_xml("", _HEAD_CHAIN, False, "      ", "")
    joints = [f"left_{n}" for n in LEG] + list(HEAD) + [f"right_{n}" for n in LEG]
    actuators = "\n".join(
        f'    <position name="{j}" joint="{j}" class="sts3215"/>' for j in joints
    )
    home_q = list(HOME_LEG) + [0.0] * 4 + list(HOME_LEG)
    if backlash:
        # each leg joint is followed by its twin in qpos
        qj = []
        for i, q in enumerate(home_q):
            qj.append(q)
            if i < 5 or i >= 9:
                qj.append(0.0)
    else:
        qj = home_q
    qpos = " ".join(str(v) for v in [0.0, 0.0, h, 1.0, 0.0, 0.0, 0.0] + qj)
    ctrl = " ".join(str(v) for v in home_q)
    sensors = "\n".join([
        '    <gyro site="imu" name="gyro"/>',
        '    <velocimeter site="imu" name="local_linvel"/>',
        '    <accelerometer site="imu" name="accelerometer"/>',
        '    <framezaxis objtype="site" objname="imu" name="upvector"/>',
        '    <framexaxis objtype="site" objname="imu" name="forwardvector"/>',
        '    <framelinvel objtype="site" objname="imu" name="global_linvel"/>',
        '    <frameangvel objtype="site" objname="imu" name="global_angvel"/>',
        '    <framepos objtype="site" objname="imu" name="position"/>',
        '    <framequat objtype="site" objname="imu" name="orientation"/>',
        '    <framelinvel objtype="site" objname="left_foot" name="left_foot_global_linvel"/>',
        '    <framelinvel objtype="site" objname="right_foot" name="right_foot_global_linvel"/>',
        '    <framexaxis objtype="site" objname="left_foot" name="left_foot_upvector"/>',
        '    <framexaxis objtype="site" objname="right_foot" name="right_foot_upvector"/>',
        '    <framepos objtype="site" objname="left_foot" name="left_foot_pos"/>',
        '    <framepos objtype="site" objname="right_foot" name="right_foot_pos"/>',
    ])
    return f"""<mujoco model="open_duck_mini_v2_standin">
  <compiler angle="radian" meshdir="assets"/>
  <option timestep="0.002" iterations="1" ls_iterations="5">
    <flag eulerdamp="disable"/>
  </option>
  <default>
    <default class="sts3215">
      <joint damping="0.56" frictionloss="0.068" armature="0.027"/>
      <position kp="{kp}" forcerange="-3.23 3.23" inheritrange="1"/>
    </default>
    <default class="backlash">
      <joint damping="0.01" frictionloss="0" armature="0.01" range="-0.00873 0.00873"/>
    </default>
  </default>
  <asset>
    <mesh name="foot_bottom_tpu" file="foot_bottom_tpu.stl"/>
{hfield}  </asset>
  <worldbody>
    <body name="base" pos="0 0 {h}">
      <freejoint name="floating_base"/>
      <body name="trunk_assembly" pos="0 0 0">
        <inertial pos="0 0 0.02" mass="0.8" fullinertia="0.0014 0.0021 0.0027 1e-5 -2e-5 0"/>
        <geom name="trunk_visual" type="box" size="0.08 0.06 0.04" pos="0 0 0.02" contype="0" conaffinity="0"/>
        <site name="imu" pos="-0.08 0 0.05"/>
{legs["left"]}{head}{legs["right"]}      </body>
    </body>
    <body name="ground">
      {floor}
    </body>
  </worldbody>
  <actuator>
{actuators}
  </actuator>
  <sensor>
{sensors}
  </sensor>
  <keyframe>
    <key name="home" qpos="{qpos}" ctrl="{ctrl}"/>
  </keyframe>
</mujoco>
"""


def _gait_pickle(seed: int = 0) -> dict:
    """Synthetic gait library in the reference pickle's layout."""
    rng = np.random.RandomState(seed)
    dxs = np.round(np.linspace(-0.148, 0.222, 6), 3)
    dys = np.round(np.linspace(-0.111, 0.111, 4), 3)
    dths = np.round(np.linspace(-1.111, 1.222, 10), 3)
    home16 = np.array(list(HOME_LEG) + [0.0] * 6 + list(HOME_LEG))
    decay = 0.05 / (1.0 + np.arange(16)) ** 2
    out = {}
    for dx in dxs:
        for dy in dys:
            for dth in dths:
                base = np.concatenate([
                    home16, np.zeros(16), [1.0, 1.0], [dx, dy, 0.0], [0.0, 0.0, dth]
                ])
                coeffs = {}
                for d in range(40):
                    c = rng.normal(0.0, 1.0, 16) * decay
                    c[0] = base[d]
                    coeffs[f"dim_{d}"] = c.tolist()
                out[f"{dx}_{dy}_{dth}"] = {
                    "period": 0.54,
                    "fps": 50,
                    "frame_offsets": {"root_pos": 0, "root_quat": 3,
                                      "joints_pos": 7, "foot_contacts": 57},
                    "startend_double_support_ratio": 0.2,
                    "coefficients": coeffs,
                }
    return out


def write_standin(root: str) -> str:
    """Write the stand-in asset tree under `root`; returns `root`."""
    assets = os.path.join(root, "xmls", "assets")
    os.makedirs(assets, exist_ok=True)
    os.makedirs(os.path.join(root, "data"), exist_ok=True)
    with open(os.path.join(assets, "foot_bottom_tpu.stl"), "wb") as f:
        f.write(_binary_stl(_sole_vertices()))
    from open_duck_playground_tpu_torch.models.open_duck_mini_v2.judge_terrain import (
        heightfield_png,
    )

    heightfield_png(os.path.join(assets, "hfield.png"), _terrain())
    for name, backlash, rough in (("scene_flat_terrain.xml", False, False),
                                  ("scene_flat_terrain_backlash.xml", True, False),
                                  ("scene_rough_terrain_backlash.xml", True, True)):
        with open(os.path.join(root, "xmls", name), "w") as f:
            f.write(scene_xml(backlash, rough))
    with open(os.path.join(root, "data", "polynomial_coefficients.pkl"), "wb") as f:
        pickle.dump(_gait_pickle(), f)
    return root


# ---------------------------------------------------------------------------
# fused kernel vs its plain PyTorch version ("twin")
# ---------------------------------------------------------------------------


def settled_states(kf, nq: int, nv: int, nu: int, B: int, seed: int = 0):
    """tests/test_lane.py's settled states as float32 numpy (qpos, qvel,
    ctrl): the keyframe `kf` (``.qpos``, ``.ctrl``) with small joint
    perturbations and near-zero velocity."""
    rng = np.random.RandomState(seed)
    qpos = np.tile(np.asarray(kf.qpos, np.float32), (B, 1))
    qpos[:, 7:] += rng.uniform(-0.02, 0.02, (B, nq - 7)).astype(np.float32)
    qvel = rng.uniform(-0.01, 0.01, (B, nv)).astype(np.float32)
    ctrl = (np.asarray(kf.ctrl, np.float32)
            + rng.uniform(-0.05, 0.05, (B, nu)).astype(np.float32))
    return qpos, qvel, ctrl


def tilted_states(kf, nq: int, nv: int, nu: int, B: int, seed: int = 0):
    """settled_states with the base turned by up to 0.5 rad about a random
    axis, moving at up to 0.5 m/s and turning at up to 2 rad/s: every frame
    the kinematics compose is then far from the identity, so a sensor or
    site read in the wrong frame shows (from settled states, near upright
    and still, it may not)."""
    qpos, qvel, ctrl = settled_states(kf, nq, nv, nu, B, seed)
    rng = np.random.RandomState(seed + 1)
    axis = rng.normal(size=(B, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    half = rng.uniform(-0.25, 0.25, (B, 1))
    turn = np.concatenate([np.cos(half), np.sin(half) * axis], 1)
    w0, v0 = turn[:, :1], turn[:, 1:]
    w1, v1 = qpos[:, 3:4].astype(np.float64), qpos[:, 4:7].astype(np.float64)
    qpos[:, 3:4] = w0 * w1 - (v0 * v1).sum(1, keepdims=True)
    qpos[:, 4:7] = w0 * v1 + w1 * v0 + np.cross(v0, v1)
    qvel[:, 0:3] = rng.uniform(-0.5, 0.5, (B, 3))
    qvel[:, 3:6] = rng.uniform(-2.0, 2.0, (B, 3))
    return qpos, qvel, ctrl


# JAX package's TPU kernel vs its eager oracle, 10 substeps, 1024 envs, DR on:
# q50 of |difference| (RESULTS.md, kernel-level parity)
TPU_Q50 = {"qpos": 4.7e-05, "qvel": 4.5e-03, "actuator_force": 8.5e-04,
           "contact_dist": 3.2e-05, "site_xpos": 2.1e-05}
# Limits on |kernel - twin| after one call, per (variant, DR on) and
# output: (q50, q95, q95 of the worst column). "step" is 10 substeps and
# "init" 1, from settled_states; "tilted" is 1 substep from tilted_states,
# and holds only the outputs that are kinematics of the given state (all but
# qpos, qvel, qacc_warmstart and the accelerometer, which go through the
# constraint solve) to a few float32 ulps. Quantiles, not a max: with the
# iterations=1 Newton step an env whose active set flips on a last-bit
# difference leaves the twin's trajectory (tests/test_lane.py), so the tail
# is chaos, not error. The worst column holds each joint, sensor and site
# column to the limit on its own, so one wrong column cannot hide behind the
# rest. Each limit is 4x the largest reading over chip_smoke.py's cases
# (flat 1024 / 4096 envs DR off / on, backlash 1024 envs DR on; NVIDIA H100
# 80GB HBM3, 700 W), rounded up, and at least 1e-6 (1e-5 for qacc_warmstart
# and the accelerometer, whose entries reach 30): a reading of 0 gets a few
# float32 ulps. DR off reads worse than DR on: there the twin folds model
# constants in float64 on the host, as the JAX lane oracle does, while the
# kernel reads float32. Every step-variant q50 limit is under 10x TPU_Q50
# (the tests check it).
PARITY_LIMITS = {
    ("step", False): {
        "qpos": (2e-5, 5e-4, 8e-4),
        "qvel": (1e-3, 4e-2, 6e-2),
        "qacc_warmstart": (8e-2, 3e0, 6e0),
        "accelerometer": (2e-2, 5e-1, 7e-1),
        "sensordata": (3e-5, 6e-3, 6e-2),
        "actuator_force": (3e-4, 7e-3, 1e-2),
        "contact_dist": (1e-6, 4e-5, 6e-5),
        "site_xpos": (2e-6, 5e-5, 1e-4),
        "site_xmat": (7e-6, 5e-4, 9e-4),
    },
    ("step", True): {
        "qpos": (1e-6, 3e-5, 6e-5),
        "qvel": (1e-6, 4e-3, 2e-2),
        "qacc_warmstart": (1e-5, 8e-1, 3e0),
        "accelerometer": (1e-5, 2e-1, 3e-1),
        "sensordata": (1e-6, 9e-5, 8e-3),
        "actuator_force": (1e-6, 4e-4, 6e-4),
        "contact_dist": (1e-6, 1e-6, 4e-6),
        "site_xpos": (1e-6, 4e-6, 8e-6),
        "site_xmat": (1e-6, 2e-5, 8e-5),
    },
    ("init", False): {
        "qpos": (1e-6, 1e-5, 2e-5),
        "qvel": (8e-6, 6e-3, 2e-2),
        "qacc_warmstart": (4e-3, 3e0, 6e0),
        "accelerometer": (2e-3, 7e-1, 9e-1),
        "sensordata": (1e-6, 1e-6, 1e-6),
        "actuator_force": (1e-6, 1e-6, 1e-6),
        "contact_dist": (1e-6, 1e-6, 1e-6),
        "site_xpos": (1e-6, 1e-6, 1e-6),
        "site_xmat": (1e-6, 1e-6, 1e-6),
    },
    ("init", True): {
        "qpos": (1e-6, 1e-6, 1e-6),
        "qvel": (1e-6, 1e-6, 1e-6),
        "qacc_warmstart": (1e-5, 1e-5, 1e-5),
        "accelerometer": (1e-5, 1e-5, 1e-5),
        "sensordata": (1e-6, 1e-6, 1e-6),
        "actuator_force": (1e-6, 1e-6, 1e-6),
        "contact_dist": (1e-6, 1e-6, 1e-6),
        "site_xpos": (1e-6, 1e-6, 1e-6),
        "site_xmat": (1e-6, 1e-6, 1e-6),
    },
    **{("tilted", with_dr): {f: (1e-6, 1e-6, 1e-6) for f in (
        "sensordata", "actuator_force", "contact_dist", "site_xpos", "site_xmat")}
       for with_dr in (False, True)},
}
# The heightfield scenes (rough and judge, the backlash duck) have limits of
# their own, set the same way from chip_smoke.py's heightfield cases (rough
# 1024 envs DR off / on, 8192 DR on, judge 1024 DR on; NVIDIA H100 80GB
# HBM3, 700 W). With DR on every reading was 0: the twin divides by model
# constants as the kernel does (lane.div), so the two agree bit for bit; DR
# off differs as on the flat scenes (the twin folds constants in float64).
_EXACT = {f: (1e-5, 1e-5, 1e-5) if f in ("qacc_warmstart", "accelerometer") else (1e-6,) * 3
          for f in PARITY_LIMITS[("step", True)]}
ROUGH_PARITY_LIMITS = {
    ("step", False): {
        "qpos": (4e-5, 8e-4, 2e-3),
        "qvel": (5e-3, 7e-2, 1e-1),
        "qacc_warmstart": (7e-1, 9e0, 2e1),
        "accelerometer": (2e-1, 2e0, 2e0),
        "sensordata": (8e-5, 2e-2, 1e-1),
        "actuator_force": (7e-4, 2e-2, 2e-2),
        "contact_dist": (1e-6, 6e-5, 9e-5),
        "site_xpos": (7e-6, 8e-5, 2e-4),
        "site_xmat": (3e-5, 8e-4, 2e-3),
    },
    ("step", True): dict(_EXACT),
    ("init", False): {
        **{f: (1e-6, 1e-6, 1e-6) for f in (
            "sensordata", "actuator_force", "contact_dist", "site_xpos", "site_xmat")},
        "qpos": (1e-6, 2e-5, 4e-5),
        "qvel": (8e-6, 2e-2, 2e-2),
        "qacc_warmstart": (4e-3, 6e0, 1e1),
        "accelerometer": (9e-4, 1e0, 2e0),
    },
    ("init", True): dict(_EXACT),
    **{("tilted", with_dr): PARITY_LIMITS[("tilted", with_dr)] for with_dr in (False, True)},
}
# The trainer's own inputs (chip_smoke.py's trainer_vs_twin, the backlash
# duck): the env's reset states, whose joints are scaled by U(0.5, 1.5) so
# that feet start in or off the floor (init variant), and the states after
# training or after 20 policy steps (step variant). With DR on every reading
# was 0, so those limits are exact, the constraint solve's outputs included.
# DR off reads worse than from settled_states, in the solve's outputs alone
# (the kinematic ones read 0 or a few ulps): the twin's float64-folded
# constants, not the kernel's logic, which DR on shows bit-exact on the same
# states. The reset's first solve, with feet in the floor, spreads so wide
# (accelerometer q95 1.3 of 34) that no limit over it would still catch a
# wrong column, so the init variant DR off holds the kinematic outputs only,
# as "tilted" does; the step variant DR off is set as above, at 4x the
# readings of the eval env's 1024 envs (NVIDIA H100 80GB HBM3, 700 W).
TRAINER_PARITY_LIMITS = {
    ("step", False): {
        "qpos": (2e-6, 8e-5, 2e-4),
        "qvel": (3e-4, 1e-2, 3e-2),
        "qacc_warmstart": (4e-2, 2e0, 4e0),
        "accelerometer": (1e-2, 3e-1, 5e-1),
        "sensordata": (5e-6, 2e-3, 2e-2),
        "actuator_force": (5e-5, 2e-3, 2e-3),
        "contact_dist": (1e-6, 6e-6, 3e-4),
        "site_xpos": (1e-6, 8e-6, 2e-5),
        "site_xmat": (3e-6, 8e-5, 2e-4),
    },
    ("step", True): dict(_EXACT),
    ("init", False): PARITY_LIMITS[("tilted", False)],
    ("init", True): dict(_EXACT),
}
# The deploy loop (chip_smoke.py phase 7): one env (B=1), DR off, on the
# states of a standing policy's rollout on the backlash duck (home, mid-run,
# last), one control tick from the same state. DR off is not bit-exact (the
# twin's float64-folded constants): the home state, feet landing from the
# keyframe, reads the widest (step qvel q95 2.8e-4, accelerometer 7.9e-3;
# init qacc_warmstart 0.18), the settled mid-run and last states 1e-6 or
# less. Limits at 4x the largest reading over the three states (at least
# 1e-6), read on an NVIDIA H100 80GB HBM3, 700 W; the init variant's
# kinematic outputs read 0.
DEPLOY_PARITY_LIMITS = {
    "step": {
        "qpos": (8e-6, 3e-5, 3e-5),
        "qvel": (4e-4, 1.2e-3, 1.5e-3),
        "qacc_warmstart": (3e-2, 8e-2, 9e-2),
        "accelerometer": (1.2e-2, 3.2e-2, 3.4e-2),
        "sensordata": (8e-6, 4e-4, 1.3e-3),
        "actuator_force": (2.3e-4, 4e-4, 4e-4),
        "contact_dist": (3e-6, 4e-6, 4e-6),
        "site_xpos": (2e-6, 4e-6, 4e-6),
        "site_xmat": (6e-6, 2.4e-5, 2.4e-5),
    },
    "init": {
        **{f: (1e-6, 1e-6, 1e-6) for f in (
            "sensordata", "actuator_force", "contact_dist", "site_xpos", "site_xmat")},
        "qpos": (1e-6, 3e-6, 4e-6),
        "qvel": (4e-4, 1.5e-3, 1.5e-3),
        "qacc_warmstart": (2e-1, 8e-1, 8e-1),
        "accelerometer": (1.1e-2, 1.5e-2, 1.6e-2),
    },
}
# The general pipeline (ops/forward.py, the env's physics="pipeline") against
# the kernel, both from the same settled_states with the same DR draw
# (chip_smoke.py phase 8: flat 4096 and rough 8192 envs), per (variant,
# heightfield scene): "init" is forward.init against the init variant on the
# kinematic outputs, "step" forward.step_n(..., 10) against the step variant
# on every output. The two are different programs with the same semantics
# (the pipeline sums in batched products, the kernel in the twin's scalar
# order), so the kinematic outputs differ by float32 rounding, and the
# settled step's iterations=1 Newton solve turns that into active-set flips
# in some envs (test_lane's chaos). The manifold's spread picks (the
# stand-in's soles tie) flip a few contact slots between valid and not, so
# "init" holds contact_dist by its quantiles, not INIT_MAX. Limits: 4x the
# first card reading (NVIDIA H100 80GB HBM3, 700 W), rounded up to two
# digits, and at least 1e-6.
_INIT_PIPELINE = {f: (1e-6, 1e-6, 1e-6) for f in (
    "sensordata", "actuator_force", "contact_dist", "site_xpos", "site_xmat")}
PIPELINE_PARITY_LIMITS = {
    ("init", False): dict(_INIT_PIPELINE),
    ("init", True): dict(_INIT_PIPELINE),
    ("step", False): {
        "qpos": (2.7e-5, 8.4e-4, 1.4e-3),
        "qvel": (2.6e-3, 6.8e-2, 1.2e-1),
        "qacc_warmstart": (1.9e-1, 5.2e0, 1.1e1),
        "accelerometer": (4.8e-2, 9.2e-1, 1.5e0),
        "sensordata": (5.6e-5, 1.4e-2, 1.2e-1),
        "actuator_force": (5.6e-4, 1.3e-2, 1.6e-2),
        "contact_dist": (1e-6, 6.4e-5, 8.8e-5),
        "site_xpos": (5.6e-6, 1e-4, 1.9e-4),
        "site_xmat": (1.7e-5, 9.2e-4, 1.6e-3),
    },
    ("step", True): {
        "qpos": (6.4e-5, 8.8e-4, 1.4e-3),
        "qvel": (7.2e-3, 8e-2, 1.4e-1),
        "qacc_warmstart": (8.8e-1, 1.1e1, 2.3e1),
        "accelerometer": (1.8e-1, 1.8e0, 2.6e0),
        "sensordata": (1.2e-4, 2.2e-2, 1.3e-1),
        "actuator_force": (1.1e-3, 1.5e-2, 1.7e-2),
        "contact_dist": (1e-6, 6.4e-5, 9.6e-5),
        "site_xpos": (1.1e-5, 1e-4, 1.6e-4),
        "site_xmat": (4e-5, 1e-3, 2e-3),
    },
}


def pipeline_outputs(d) -> dict:
    """The kernel's flat (B, width) outputs read off a pipeline ``Data``."""
    B = d.qpos.shape[0]
    return dict(qpos=d.qpos, qvel=d.qvel, qacc_warmstart=d.qacc_warmstart,
                sensordata=d.sensordata, actuator_force=d.actuator_force,
                contact_dist=d.contact.dist, site_xpos=d.site_xpos.reshape(B, -1),
                site_xmat=d.site_xmat.reshape(B, -1))


# init and tilted variants: site and contact outputs are kinematics of
# identical inputs, held to a max as well
INIT_MAX = {"site_xpos": 1e-4, "contact_dist": 1e-4, "site_xmat": 1e-4}
_INVALID = 1e9  # contact slots without a contact carry dist 1e10


def parity_outputs(out: dict, accel_adr: int) -> dict:
    """The kernel's (or twin's) outputs as numpy, with sensordata split into
    the accelerometer (3 columns from `accel_adr`), the one sensor that
    reads the constraint solve and so carries its chaos, and the rest,
    kinematics of qpos and qvel."""
    out = {k: np.asarray(v) for k, v in out.items()}
    sd = out.pop("sensordata")
    accel = np.zeros(sd.shape[1], bool)
    accel[accel_adr:accel_adr + 3] = True
    out["accelerometer"], out["sensordata"] = sd[:, accel], sd[:, ~accel]
    return out


def parity_limits(variant: str, with_dr: bool, rough: bool = False) -> dict:
    """{output: (q50, q95, worst column's q95)} of one variant and DR
    setting, for the flat scenes or (`rough`) the heightfield scenes."""
    return (ROUGH_PARITY_LIMITS if rough else PARITY_LIMITS)[(variant, with_dr)]


def parity(kernel: np.ndarray, twin: np.ndarray, variant: str, with_dr: bool,
           field: str, rough: bool = False, limits: Optional[dict] = None) -> dict:
    """|kernel - twin| of one (B, width) output against its limits:
    `limits` ({output: (q50, q95, worst column's q95)}) if given, else
    parity_limits(variant, with_dr, rough).

    Returns q50, q95, the worst column's q95 and its index, max (for
    contact_dist over slots valid on both sides, with `flips` counting
    slots valid on one side only), `scale` (q95 of |twin|), and `ok`."""
    k = np.asarray(kernel, np.float64)
    p = np.asarray(twin, np.float64)
    finite = bool(np.isfinite(k).all())
    flips = 0
    valid = np.ones(p.shape, bool)
    if field == "contact_dist":
        kv, valid = k < _INVALID, p < _INVALID
        flips = int((kv != valid).sum())
        k, p = np.minimum(k, _INVALID), np.minimum(p, _INVALID)
        both = kv & valid
    else:
        both = valid
    err = np.abs(k - p)
    col = np.quantile(err, 0.95, axis=0)
    r = dict(q50=float(np.quantile(err, 0.5)), q95=float(np.quantile(err, 0.95)),
             col_q95=float(col.max()), col=int(col.argmax()),
             max=float(err[both].max()) if both.any() else 0.0, flips=flips,
             scale=float(np.quantile(np.abs(p[valid]), 0.95)) if valid.any() else 0.0)
    q50, q95, c95 = (limits or parity_limits(variant, with_dr, rough))[field]
    ok = finite and r["q50"] <= q50 and r["q95"] <= q95 and r["col_q95"] <= c95
    if variant in ("init", "tilted") and field in INIT_MAX:
        ok = ok and flips == 0 and r["max"] <= INIT_MAX[field]
    r["ok"] = ok
    return r


if __name__ == "__main__":
    import sys

    print(write_standin(sys.argv[1] if len(sys.argv) > 1 else "standin_assets"))
