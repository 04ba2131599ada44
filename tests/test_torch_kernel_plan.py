"""The fused kernel's plan, checked on the CPU: one env's shared-memory slice
(``cuda_step.shared_layout``), the constraint Jacobian stored over each row's
support, the launch geometry, and the agreement of the kernel source's
tables and entry points with the wrapper that fills them."""

import re

import numpy as np
import pytest
import torch

from open_duck_playground_tpu_torch.mjcf import compile_mjcf
from open_duck_playground_tpu_torch.ops import cuda_step
from open_duck_playground_tpu_torch.ops.cuda_step import FusedPhysics
from tests import duck_standin
from tests.torch_helpers import scene, standin_assets

pytest_plugins = ["tests.torch_lock"]  # never beside tests/test_resume.py (see there)

SCENES = ("scene_flat_terrain.xml", "scene_flat_terrain_backlash.xml",
          "scene_rough_terrain_backlash.xml")
# bytes of one env's slice, as the card runs of this layout used them
ENV_BYTES = {"scene_flat_terrain.xml": 12224, "scene_flat_terrain_backlash.xml": 16032,
             "scene_rough_terrain_backlash.xml": 16032}
with open(cuda_step._SRC) as _f:
    SOURCE = _f.read()


@pytest.fixture(scope="module")
def physics(tmp_path_factory):
    with standin_assets(str(tmp_path_factory.mktemp("standin"))) as root:
        yield {n: FusedPhysics(compile_mjcf(scene(root, n), timestep=0.002)) for n in SCENES}


def _live_together(a, b) -> bool:
    """Whether two arrays of the layout (their spans) can be live at once:
    one stage group's arrays overlay only other stage groups', and phase B's
    groups also the rigid-body arrays."""
    (ga, pa), (gb, pb) = a[2:], b[2:]
    if ga == gb or "substep" in (ga, gb):
        return True
    if "rigid_body" in (ga, gb):
        return (pb if ga == "rigid_body" else pa) == "A"
    return False


@pytest.mark.parametrize("name", SCENES)
def test_layout_aligned_disjoint_and_sized(physics, name):
    packed = physics[name].packed()
    sz, lay = packed["sizes"], packed["layout"]
    spans = lay["spans"]
    assert tuple(spans) == cuda_step.LAYOUT_NAMES
    assert lay["offsets"] == [spans[n][0] for n in cuda_step.LAYOUT_NAMES]
    for off, n, _, _ in spans.values():
        assert off % 4 == 0 and n > 0 and off + n <= lay["env_floats"]
    names = list(spans)
    for i, a in enumerate(names):
        for b in names[:i]:
            (oa, na, *_), (ob, nb, *_) = spans[a], spans[b]
            if _live_together(spans[a], spans[b]):
                assert oa + na <= ob or ob + nb <= oa, (a, b)
    # the total from the sizes: the substep's arrays, then the larger of
    # phase A (rigid-body arrays and its largest stage) and phase B
    nv, nefc = sz["nv"], sz["nefc"]
    assert spans["M"][1] == spans["H"][1] == spans["LDLM"][1] == nv * (nv + 1) // 2
    assert spans["EFC_J"][1] == sz["efc_nnz"] and spans["EFC_D"][1] == nefc
    up = lambda n: -(-n // 4) * 4  # noqa: E731
    groups = {}
    for off, n, group, phase in spans.values():
        groups.setdefault((group, phase), []).append(up(n))
    persist = sum(groups.pop(("substep", "")))
    rigid = sum(groups.pop(("rigid_body", "")))
    a = rigid + max(sum(v) for (g, p), v in groups.items() if p == "A")
    b = max(sum(v) for (g, p), v in groups.items() if p == "B")
    assert lay["env_floats"] == persist + max(a, b)
    assert lay["env_bytes"] == 4 * lay["env_floats"] == ENV_BYTES[name]


@pytest.mark.parametrize("name", SCENES)
def test_jacobian_rows_are_the_twins_supports(physics, name):
    """efc_off / efc_col hold, row by row and in the twin's column order,
    the supports of the rows LanePhysics.make_efc builds."""
    fp = physics[name]
    lane, m = fp.lane, fp.model
    qpos, qvel, ctrl = (torch.from_numpy(x) for x in duck_standin.settled_states(
        m.keyframe("home"), m.nq, m.nv, m.nu, 1))
    qp, qv = [qpos[:, i] for i in range(m.nq)], [qvel[:, i] for i in range(m.nv)]
    xpos, xquat, xanchor, xaxis = lane.kinematics(qp, None)
    subtree_com, _, _, cdof = lane.com_pos(xpos, xquat, xanchor, xaxis, None)
    rows = lane.make_efc(qv, qp, lane.collide(xpos, xquat), cdof, subtree_com, None)
    a, sz = fp.packed()["arrays"], fp.packed()["sizes"]
    off, col = a["efc_off"], a["efc_col"]
    assert sz["nefc"] == len(rows) and len(off) == len(rows) + 1 and off[0] == 0
    for r, row in enumerate(rows):
        assert list(col[off[r]:off[r + 1]]) == [d for d, _ in row["support"]], r
    widths = np.diff(off)
    nfl = sz["nfri"] + sz["nlim"]
    assert (widths[:nfl] == 1).all()
    # hull-hull and plane- or heightfield-hull supports
    assert set(widths[nfl:].tolist()) == ({26, 16} if "backlash" in name else {16, 11})
    # each pair's 16 rows share the support of the pair's dof mask
    for p in range(m.npair):
        dofs = int(np.uint32(a["pair_i"][p, 11]) | np.uint32(a["pair_i"][p, 12]))
        for r in range(nfl + 16 * p, nfl + 16 * p + 16):
            assert [d for d in range(m.nv) if dofs >> d & 1] == list(col[off[r]:off[r + 1]])
    # each dof's friction and limit rows (the width-one rows on H's diagonal)
    dof_rows = a["efc_dof_rows"]
    for r in range(nfl):
        assert dof_rows[col[off[r]], int(r >= sz["nfri"])] == r
    assert (dof_rows >= 0).sum() == nfl
    assert sz["efc_nnz"] == off[-1] == len(col)


def test_body_depths(physics):
    a = physics["scene_flat_terrain.xml"].packed()["arrays"]
    parent, depth = a["body_parentid"], a["body_depth"]
    assert depth[0] == 0
    for b in range(1, len(parent)):
        assert depth[b] == depth[parent[b]] + 1


def test_a_model_past_the_shared_memory_raises(physics):
    sizes = dict(physics["scene_rough_terrain_backlash.xml"].packed()["sizes"])
    assert cuda_step.shared_layout(sizes)["env_bytes"] <= cuda_step.MAX_SHARED_BYTES
    sizes["efc_nnz"] = cuda_step.MAX_SHARED_BYTES // 4
    with pytest.raises(ValueError, match="does not fit"):
        cuda_step.shared_layout(sizes)


def _h100_blocks(env_bytes):
    """An H100's residency for k envs per block: 228 KB of shared memory per
    SM with 1 KB reserved per block, 64 warps, 32 blocks."""
    return lambda k: min(233472 // (k * env_bytes + 1024), 64 // k, 32)


@pytest.mark.parametrize("B, k, blocks, waves", [
    (4096, 2, 2048, 2), (8192, 2, 4096, 4), (1, 2, 1, 1), (33, 2, 17, 1), (1000, 2, 500, 1)])
def test_launch_geometry(B, k, blocks, waves):
    geo = cuda_step.launch_geometry(B, 12224, 132, _h100_blocks(12224))
    assert (geo["envs_per_block"], geo["blocks"], geo["waves"]) == (k, blocks, waves)
    assert geo["warps_per_sm"] == 18 and geo["blocks_per_sm"] == 9
    assert geo["blocks"] * geo["envs_per_block"] >= B


def test_launch_geometry_prefers_fewer_envs_per_block_on_a_tie():
    geo = cuda_step.launch_geometry(100, 1000, 132, lambda k: 16 // k)
    assert geo["envs_per_block"] == 1 and geo["warps_per_sm"] == 16


def test_launch_geometry_raises_when_no_block_fits():
    with pytest.raises(ValueError, match="fits"):
        cuda_step.launch_geometry(64, 200000, 132, lambda k: 0)
    with pytest.raises(ValueError):
        cuda_step.launch_geometry(64, cuda_step.MAX_SHARED_BYTES + 4, 132, lambda k: 1)


def test_source_layout_enum_matches_the_wrapper():
    body = SOURCE[SOURCE.index("enum {\n  L_QPOS"):SOURCE.index("L_COUNT")]
    assert tuple(re.findall(r"\bL_(\w+)", body)) == cuda_step.LAYOUT_NAMES


def test_source_model_struct_matches_the_wrapper():
    """DuckModel in the kernel source and the ctypes struct the wrapper
    fills: the same fields in the same order."""
    body = SOURCE[SOURCE.index("struct DuckModel {"):SOURCE.index("struct DuckDR")]
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in body.split("{", 1)[1].split(";"):
        decl = decl.replace("const", "").strip()
        if not decl or decl.startswith("}"):
            continue
        decl = re.sub(r"^(int|float|uint32_t)\s*", "", decl)
        names += [re.sub(r"[\s*]|\[.*\]", "", n) for n in decl.split(",")]
    assert names == [f for f, _ in cuda_step._DuckModel._fields_]


def test_source_defines_every_entry_point_the_wrapper_binds():
    """Every function bound from the library is defined in one of its five
    sources: the kernel's, the tracer's stamp (csrc/stamp.cu), the
    optimizer's (csrc/adam.cu), the GAE kernel's (csrc/gae.cu) and the
    swish's (csrc/swish.cu)."""
    with open(cuda_step.__file__) as f:
        bound = set(re.findall(r"lib\.(duck_\w+)", f.read()))
    others = ""
    for path in (cuda_step._STAMP_SRC, cuda_step._ADAM_SRC, cuda_step._GAE_SRC,
                 cuda_step._SWISH_SRC):
        with open(path) as f:
            others += f.read()
    defined = set(re.findall(r"^int (duck_\w+)\(", SOURCE + others, re.M))
    assert bound and bound <= defined and {"duck_stamp", "duck_adam", "duck_gae",
                                           "duck_swish_forward", "duck_swish_backward"} <= bound


def test_adam_tensor_limit_matches_the_source():
    """The optimizer's kernel takes at most DUCK_ADAM_LEAVES tensors per
    launch, the wrapper's ADAM_MAX_TENSORS."""
    with open(cuda_step._ADAM_SRC) as f:
        leaves = re.search(r"#define DUCK_ADAM_LEAVES (\d+)", f.read())
    assert leaves and int(leaves.group(1)) == cuda_step.ADAM_MAX_TENSORS


@pytest.mark.parametrize("n", [0, cuda_step.ADAM_MAX_TENSORS + 1])
def test_adam_step_raises_beyond_one_launch(n):
    """More tensors than one launch takes, or none: a ValueError before
    anything is built or launched, and no launch counted."""
    ts = [torch.zeros(3) for _ in range(n)]
    s = torch.ones(())
    before = cuda_step.ADAM.launches
    with pytest.raises(ValueError, match="one launch takes"):
        cuda_step.adam_step(ts, ts, ts, ts, None, s, s, None, 0.9, 0.999, 1e-8, 3e-4)
    assert cuda_step.ADAM.launches == before


def _gae_inputs(T=5, b=3):
    """reward, discount, truncation, values [T, b] and bootstrap [b]."""
    return [torch.zeros(T, b) for _ in range(4)] + [torch.zeros(b)]


def _bad_gae_inputs(case: str):
    ins = _gae_inputs()
    if case == "values_1d":
        ins[3] = torch.zeros(15)
    elif case == "empty_T":
        ins = _gae_inputs(T=0)
    elif case == "reward_shape":
        ins[0] = torch.zeros(5, 4)
    elif case == "bootstrap_shape":
        ins[4] = torch.zeros(1, 3)
    elif case == "discount_float64":
        ins[1] = ins[1].double()
    elif case == "truncation_view":
        ins[2] = torch.zeros(3, 5).t()
    return ins


@pytest.mark.parametrize("case,match", [
    ("values_1d", "values must be"), ("empty_T", "values must be"),
    ("reward_shape", "reward: shape"), ("bootstrap_shape", "bootstrap_value: shape"),
    ("discount_float64", "discount must be"), ("truncation_view", "truncation must be"),
    ("cpu", "CUDA device")])
def test_gae_step_raises_on_what_the_kernel_does_not_take(case, match):
    """The GAE kernel's launcher checks shapes ([T, b] with T, b >= 1, the
    bootstrap [b]), float32, contiguity and the device before anything is
    built or launched: a ValueError, and no launch counted. CPU tensors of
    the right shapes are refused too: the kernel has no CPU mode."""
    before = cuda_step.GAE.launches
    with pytest.raises(ValueError, match=match):
        cuda_step.gae_step(*_bad_gae_inputs(case), 1.0, 0.97, 0.95)
    assert cuda_step.GAE.launches == before


def test_profile_stage_names_match_the_source():
    body = SOURCE[SOURCE.index("enum {\n  PROF_"):SOURCE.index("PROF_COUNT")]
    assert len(re.findall(r"\bPROF_\w+", body)) == len(cuda_step.PROFILE_STAGES)


def test_launch_is_one_warp_per_env():
    """The kernel launches 32 threads per env; no thread-per-env sizing is left."""
    assert not hasattr(cuda_step, "block_threads")
    assert "StepKernel kernel = duck_step_kernel(ceiling);" in SOURCE
    assert "kernel<<<blocks, 32 * envs_per_block" in SOURCE


def test_ldl_ceilings_match_the_source():
    """The wrapper's LDL ceilings are the kernel's instantiations
    (duck_step_kernel's cases), the largest MAX_NV; a model takes the least
    that holds its nv, and one past the largest raises."""
    body = SOURCE[SOURCE.index("inline StepKernel duck_step_kernel"):]
    body = body[:body.index("return nullptr")]
    max_nv = int(re.search(r"#define MAX_NV (\d+)", SOURCE).group(1))
    cases = [int(c.replace("MAX_NV", str(max_nv)))
             for c in re.findall(r"case (\w+): return physics_step_kernel<\1>;", body)]
    assert tuple(cases) == cuda_step.LDL_CEILINGS and cases[-1] == max_nv
    assert [cuda_step.ldl_ceiling(nv) for nv in (1, 20, 24, 25, 30, 32)] == [24, 24, 24, 32, 32, 32]
    with pytest.raises(ValueError, match="nv=33"):
        cuda_step.ldl_ceiling(33)
