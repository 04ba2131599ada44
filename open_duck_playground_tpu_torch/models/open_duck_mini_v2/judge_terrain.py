"""Judge terrain: the rough scene on which both engines are well-posed.

The JAX package's ``models/open_duck_mini_v2/judge_terrain.py``, same
recipe and same scene. Real MuJoCo's prism heightfield collider ejects the
duck from the home keyframe at the reference scene's 256x256 resolution,
even on a constant-zero field; at 128 rows or fewer it is stable up to the
scene's 1 cm bump ceiling. The judge field is the roughest terrain on which
MuJoCo itself is well-posed: 64x64 cells over the same 10x10 m extent with
the same <= 1 cm bumps. Rough policies get their second-engine gate on it
(task ``rough_judge_backlash``).

The scene directory is generated on demand (deterministic, seed 0) next to
this file: the rough scene of the asset root with only its heightfield PNG
swapped; the robot XMLs and mesh assets are symlinked from the asset root.
"""

from __future__ import annotations

import os

import numpy as np

from open_duck_playground_tpu_torch.models.open_duck_mini_v2.constants import asset_root

JUDGE_NROW = 64
JUDGE_SEED = 0
_VERSION = "judge-v1-64"  # change to force regeneration


def judge_heightfield(nrow: int = JUDGE_NROW, seed: int = JUDGE_SEED) -> np.ndarray:
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
    names, through a temporary file so readers never see half of it. The
    compiler flips rows (image row 0 is +y), so the image is written
    flipped and reads back as `h` in world orientation."""
    from PIL import Image

    Image.fromarray((h[::-1] * 255).astype(np.uint8), "L").save(_tmp(path), format="PNG")
    os.replace(_tmp(path), path)


def ensure_judge_scene() -> str:
    """Build (idempotently) the judge scene directory for the current asset
    root; returns the scene XML path."""
    root = asset_root()
    src_xmls = os.path.join(root, "xmls")
    out_xmls = os.path.join(os.path.dirname(os.path.abspath(__file__)), "judge_assets", "xmls")
    scene_path = os.path.join(out_xmls, "scene_rough_judge_backlash.xml")
    stamp = os.path.join(out_xmls, ".version")
    want = f"{_VERSION} {os.path.realpath(root)}"
    if os.path.exists(scene_path) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == want:
                return scene_path

    out_assets = os.path.join(out_xmls, "assets")
    os.makedirs(out_assets, exist_ok=True)
    for fn in os.listdir(src_xmls):
        if fn.endswith(".xml") and not fn.startswith("scene_"):
            _symlink(os.path.join(src_xmls, fn), os.path.join(out_xmls, fn))
    src_assets = os.path.join(src_xmls, "assets")
    for fn in os.listdir(src_assets):
        _symlink(os.path.join(src_assets, fn), os.path.join(out_assets, fn))
    heightfield_png(os.path.join(out_assets, "hfield_judge.png"), judge_heightfield())

    with open(os.path.join(src_xmls, "scene_rough_terrain_backlash.xml")) as f:
        xml = f.read()
    xml = xml.replace('file="assets/hfield.png"', 'file="assets/hfield_judge.png"')
    xml = xml.replace("rough terrain scene", "rough JUDGE terrain scene")
    _write(scene_path, xml)
    _write(stamp, want)
    return scene_path


def _tmp(path: str) -> str:
    return f"{path}.{os.getpid()}.tmp"


def _write(path: str, text: str) -> None:
    with open(_tmp(path), "w") as f:
        f.write(text)
    os.replace(_tmp(path), path)


def _symlink(src: str, dst: str) -> None:
    if os.path.islink(_tmp(dst)):
        os.remove(_tmp(dst))
    os.symlink(src, _tmp(dst))
    os.replace(_tmp(dst), dst)
