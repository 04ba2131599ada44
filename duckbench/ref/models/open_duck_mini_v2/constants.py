"""Open Duck Mini v2 robot constants (the JAX package's, same names).

Asset files (MJCF scenes, STL meshes, gait-polynomial pickle) are data, not
code. ``asset_root()`` returns ``$OPEN_DUCK_ASSETS`` (a directory
containing ``xmls/`` and ``data/``), read at each call so tests and scripts
can point it at a generated tree (``tests/duck_standin.py``).
"""

from __future__ import annotations

import os

def asset_root() -> str:
    root = os.environ.get("OPEN_DUCK_ASSETS", "")
    if root and os.path.isdir(os.path.join(root, "xmls")):
        return root
    raise FileNotFoundError(
        "Open Duck Mini v2 assets not found; set $OPEN_DUCK_ASSETS to a "
        "directory with xmls/ and data/ (python tests/duck_standin.py DIR "
        "writes a stand-in tree)"
    )


def task_to_xml(task_name: str) -> str:
    """Task name -> scene MJCF path.

    'rough_terrain' maps to scene_rough_terrain.xml, which the reference
    does not ship (only the backlash rough scene exists): selecting it
    raises FileNotFoundError on use, as upstream. (The port's generated
    judge scene is not part of this frozen copy.)
    """
    xmls = os.path.join(asset_root(), "xmls")
    return {
        "flat_terrain": os.path.join(xmls, "scene_flat_terrain.xml"),
        "rough_terrain": os.path.join(xmls, "scene_rough_terrain.xml"),
        "flat_terrain_backlash": os.path.join(xmls, "scene_flat_terrain_backlash.xml"),
        "rough_terrain_backlash": os.path.join(xmls, "scene_rough_terrain_backlash.xml"),
    }[task_name]


def reference_motion_path() -> str:
    return os.path.join(asset_root(), "data", "polynomial_coefficients.pkl")


FEET_SITES = ["left_foot", "right_foot"]
LEFT_FEET_GEOMS = ["left_foot_bottom_tpu"]
RIGHT_FEET_GEOMS = ["right_foot_bottom_tpu"]
FEET_GEOMS = LEFT_FEET_GEOMS + RIGHT_FEET_GEOMS

HIP_JOINT_NAMES = [
    "left_hip_yaw", "left_hip_roll", "left_hip_pitch",
    "right_hip_yaw", "right_hip_roll", "right_hip_pitch",
]
KNEE_JOINT_NAMES = ["left_knee", "right_knee"]

JOINTS_ORDER_NO_HEAD = [
    "left_hip_yaw", "left_hip_roll", "left_hip_pitch", "left_knee", "left_ankle",
    "right_hip_yaw", "right_hip_roll", "right_hip_pitch", "right_knee", "right_ankle",
]

FEET_POS_SENSOR = [f"{site}_pos" for site in FEET_SITES]

ROOT_BODY = "trunk_assembly"

GRAVITY_SENSOR = "upvector"
GLOBAL_LINVEL_SENSOR = "global_linvel"
GLOBAL_ANGVEL_SENSOR = "global_angvel"
LOCAL_LINVEL_SENSOR = "local_linvel"
ACCELEROMETER_SENSOR = "accelerometer"
GYRO_SENSOR = "gyro"
