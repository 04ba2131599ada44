"""The port's MJCF compiler against the JAX package's, field by field.

Both compile in float64 numpy and cast once to float32, so every field must
agree exactly after the cast (no tolerance). The heightfield scenes (the
rough stand-in and the generated judge scene) cover hfield_data,
hfield_size and the terrain body's geom-derived inertial."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from open_duck_playground_tpu.mjcf import compile_mjcf as jax_compile
from open_duck_playground_tpu.models.open_duck_mini_v2 import judge_terrain as jax_judge
from open_duck_playground_tpu_torch import interop
from open_duck_playground_tpu_torch.mjcf import compile_mjcf as torch_compile
from open_duck_playground_tpu_torch.models.open_duck_mini_v2 import constants
from open_duck_playground_tpu_torch.models.open_duck_mini_v2 import judge_terrain
from tests.test_physics import FREE_BODY, PENDULUM
from tests.torch_helpers import jax_model_fields, scene, standin_assets

pytest_plugins = ["tests.torch_lock"]  # never beside tests/test_resume.py (see there)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    with standin_assets(str(tmp_path_factory.mktemp("standin"))) as r:
        yield r


def _assert_same(jf: dict, tf: dict):
    assert jf.keys() == tf.keys()
    for k in jf:
        a, b = jf[k], tf[k]
        if k == "opt":
            assert {kk: v for kk, v in a.items() if kk != "gravity"} == \
                {kk: v for kk, v in b.items() if kk != "gravity"}
            np.testing.assert_array_equal(a["gravity"], b["gravity"])
        elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(a, b, err_msg=k)
        elif k == "keyframes":
            assert a.keys() == b.keys()
            for kk in a:
                for x, y in zip(a[kk], b[kk]):
                    np.testing.assert_array_equal(x, y)
        else:
            assert a == b, k


def _sources(tmp_path, root):
    out = []
    for i, xml in enumerate((PENDULUM, FREE_BODY)):
        p = tmp_path / f"inline{i}.xml"
        p.write_text(xml)
        out.append(str(p))
    out += [scene(root, "scene_flat_terrain.xml"), scene(root, "scene_flat_terrain_backlash.xml"),
            scene(root, "scene_rough_terrain_backlash.xml"),
            constants.task_to_xml("rough_judge_backlash")]
    return out


@pytest.mark.parametrize("which", [0, 1, 2, 3, 4, 5])
def test_compiled_model_equals_jax(tmp_path, root, which):
    path = _sources(tmp_path, root)[which]
    jm, tm = jax_compile(path, timestep=0.002), torch_compile(path, timestep=0.002)
    tf = interop.model_to_numpy(tm)
    _assert_same(jax_model_fields(jm), tf)
    for f in dataclasses.fields(tm):
        v = getattr(tm, f.name)
        if isinstance(v, torch.Tensor):
            assert v.dtype == torch.float32, f.name


@pytest.mark.parametrize("which", [0, 3, 4])
def test_interop_round_trip(tmp_path, root, which):
    path = _sources(tmp_path, root)[which]
    jm = jax_compile(path, timestep=0.002)
    tm = interop.model_from_numpy(jax_model_fields(jm))
    _assert_same(jax_model_fields(jm), interop.model_to_numpy(tm))
    again = interop.model_from_numpy(interop.model_to_numpy(tm))
    assert again.names == tm.names and again.keyframes == tm.keyframes
    if "floor" in tm.names.geom:
        assert again.find_pair(tm.geom("floor"), tm.geom("left_foot_bottom_tpu")) == \
            jm.find_pair(jm.geom("floor"), jm.geom("left_foot_bottom_tpu"))


def test_rough_scenes_carry_the_terrain(tmp_path, root):
    """The rough stand-in's 256x256 table and the judge scene's 64x64 one,
    with the reference's size, a geom-derived terrain mass, and the
    heightfield-hull pairs."""
    rough, judge = _sources(tmp_path, root)[4:]
    for path, nrow in ((rough, 256), (judge, judge_terrain.JUDGE_NROW)):
        tm = torch_compile(path, timestep=0.002)
        assert (tm.hfield_nrow, tm.hfield_ncol) == (nrow, nrow)
        np.testing.assert_array_equal(tm.hfield_size.numpy(), np.float32([10, 10, 0.01, 0.1]))
        assert float(tm.hfield_data.min()) == 0.0 and float(tm.hfield_data.max()) == 1.0
        assert float(tm.body_mass[int(tm.geom_bodyid[tm.geom("floor")])]) > 1e4
        assert sorted(int(t) for t in tm.pair_type) == [1, 1, 2]


def test_judge_heightfield_matches_jax(root):
    """The port's judge recipe equals the JAX package's bit for bit (the
    judge's 64 rows and the rough stand-in's 256), and the judge scene it
    writes compiles in MuJoCo with 64 rows."""
    for nrow, seed in ((judge_terrain.JUDGE_NROW, judge_terrain.JUDGE_SEED), (256, 1)):
        np.testing.assert_array_equal(judge_terrain.judge_heightfield(nrow, seed),
                                      jax_judge.judge_heightfield(nrow, seed))
    path = constants.task_to_xml("rough_judge_backlash")
    assert constants.task_to_xml("rough_judge_backlash") == path  # built once
    pytest.importorskip("mujoco")
    from open_duck_playground_tpu.deploy.mujoco_infer_base import load_mj_model

    mm = load_mj_model(path)
    assert int(mm.hfield_nrow[0]) == judge_terrain.JUDGE_NROW
    assert (mm.nq, mm.nv, mm.nu) == (31, 30, 14)


def test_rough_terrain_task_is_missing_as_upstream(root):
    """'rough_terrain' maps to a scene the reference does not ship."""
    path = constants.task_to_xml("rough_terrain")
    assert path.endswith("scene_rough_terrain.xml") and not os.path.exists(path)
    with pytest.raises(FileNotFoundError):
        torch_compile(path)
