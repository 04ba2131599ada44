"""The generated stand-in for the Open Duck Mini v2 asset tree, which every
cell of the benchmark runs on: the real duck's MJCF, meshes and gait pickle
are not in the repository.

A frozen copy of the generator in ``tests/duck_standin.py`` (``write_standin``
and what it calls, with the heightfield recipe of the port's
``judge_terrain.py`` inlined), so that the scene the benchmark measures does
not move when those files change. ``write_standin(root)`` writes ``xmls/``
(the flat, flat backlash and rough backlash scenes, the sole mesh and the
256x256 heightfield PNG) and ``data/polynomial_coefficients.pkl`` (a
synthetic gait grid): the real duck's topology and widths, nq=31, nv=30,
nu=14 on the backlash scenes.
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


def judge_heightfield(nrow: int, seed: int) -> np.ndarray:
    """[0, 1]-normalized smooth random bumps, (nrow, nrow) float64."""
    rng = np.random.RandomState(seed)
    h = rng.rand(nrow, nrow)
    k = max(nrow // 32, 1)
    if k > 1:
        ker = np.ones(k) / k
        h = np.apply_along_axis(lambda r: np.convolve(r, ker, "same"), 0, h)
        h = np.apply_along_axis(lambda r: np.convolve(r, ker, "same"), 1, h)
    h -= h.min()
    if h.max() > 0:
        h /= h.max()
    return h


def heightfield_png(path: str, h: np.ndarray) -> None:
    """Write a [0, 1] field as the 8-bit gray PNG a scene's <hfield file=...>
    names; the compiler flips rows (image row 0 is +y), so the image is
    written flipped and reads back as `h` in world orientation."""
    from PIL import Image

    Image.fromarray((h[::-1] * 255).astype(np.uint8), "L").save(path, format="PNG")


def _terrain() -> np.ndarray:
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
    heightfield_png(os.path.join(assets, "hfield.png"), _terrain())
    for name, backlash, rough in (("scene_flat_terrain.xml", False, False),
                                  ("scene_flat_terrain_backlash.xml", True, False),
                                  ("scene_rough_terrain_backlash.xml", True, True)):
        with open(os.path.join(root, "xmls", name), "w") as f:
            f.write(scene_xml(backlash, rough))
    with open(os.path.join(root, "data", "polynomial_coefficients.pkl"), "wb") as f:
        pickle.dump(_gait_pickle(), f)
    return root
