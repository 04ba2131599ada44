"""The fused kernel's LDL routine alone, on the CPU: ``ldl_factor`` +
``ldl_solve`` of ``ops/csrc/physics_step.cu``, built with g++ under the warp
emulator (``scripts/kernel_emulator/ldl.cpp``, a thread per lane), held bit
for bit against the twin's ``LDLTree.factor`` / ``solve`` on float32 CPU
tensors: x, 1 / d and L over the pattern. The routine uses +, -, x and /
alone, so the bits are equal when the order of the operations is.

Cases: the stand-in's M and Newton-Hessian patterns at nv = 20 and 30 (dense
after fill-in) with random SPD matrices scaled like H (entries from about
1e-5 to 1e5), at each ceiling that holds nv; a sparse forest pattern, NaN
outside the pattern (never read); a NaN entry propagating."""

import ctypes
import math
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from open_duck_playground_tpu_torch.mjcf import compile_mjcf
from open_duck_playground_tpu_torch.ops import cuda_step
from open_duck_playground_tpu_torch.ops.lane_physics import LDLTree, LanePhysics
from tests.duck_standin import write_standin
from tests.torch_helpers import scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = {20: "scene_flat_terrain.xml", 30: "scene_flat_terrain_backlash.xml"}


@pytest.fixture(scope="module")
def emu_ldl(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the warp emulator cannot be built")
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        from kernel_emulate import build
    finally:
        sys.path.pop(0)
    lib = build(cuda_step._SRC, entry="ldl.cpp", out_dir=str(tmp_path_factory.mktemp("emu")))
    fn = lib.emu_ldl
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5
    return fn


@pytest.fixture(scope="module")
def standin_trees(tmp_path_factory):
    """{nv: (M's LDLTree, H's LDLTree)} of the stand-in's flat scenes."""
    root = str(tmp_path_factory.mktemp("standin"))
    write_standin(root)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OPEN_DUCK_ASSETS", root)
        out = {}
        for nv, name in SCENES.items():
            lane = LanePhysics(compile_mjcf(scene(root, name), timestep=0.002))
            assert lane.m.nv == nv
            out[nv] = (lane.ldl, lane.ldl_h)
    return out


def forest_tree(nv: int) -> LDLTree:
    """A sparse pattern: three chains with side branches and no common root
    (a fixed-base robot's arms), so fill-in stays inside each tree."""
    parent = [-1 if i % (nv // 3) == 0 else i - 1 - (i % 4 == 3) for i in range(nv)]
    pattern = []
    for i in range(nv):
        j = i
        while j >= 0:
            pattern.append((i, j))
            j = parent[j]
    return LDLTree(nv, sorted(pattern))


def spd_on(tree: LDLTree, rng: np.random.RandomState) -> np.ndarray:
    """A symmetric matrix on the tree's pattern (0 elsewhere), positive
    definite by diagonal dominance, scaled by a log-uniform diagonal so its
    entries run from about 1e-5 to 1e5, as the Newton Hessian's do."""
    nv = tree.nv
    A = np.zeros((nv, nv))
    for (i, j) in tree.pat:
        if i > j:
            A[i, j] = A[j, i] = rng.uniform(-1.0, 1.0)
    A += np.diag(np.abs(A).sum(1) + rng.uniform(0.1, 1.0, nv))
    s = 10.0 ** rng.uniform(-2.5, 2.5, nv)
    return (A * s[:, None] * s[None, :]).astype(np.float32)


def kernel_ldl(fn, tree: LDLTree, A: np.ndarray, b: np.ndarray, ceiling: int, outside=0.0):
    """The kernel's routine on A (entries outside the pattern set to
    `outside`): (x, 1 / d, the packed triangle after the factor)."""
    nv = tree.nv
    tri = np.full(nv * (nv + 1) // 2, outside, np.float32)
    for (i, j) in tree.pat:
        tri[i * (i + 1) // 2 + j] = A[i, j]
    mask = np.ascontiguousarray(cuda_step._masks(nv, tree.pat, strict=True).view(np.uint32))
    b = np.ascontiguousarray(b, np.float32)
    x, dinv = np.full(nv, np.nan, np.float32), np.full(nv, np.nan, np.float32)
    err = fn(nv, ceiling, mask.ctypes.data, tri.ctypes.data, b.ctypes.data, x.ctypes.data,
             dinv.ctypes.data)
    assert err == 0
    return x, dinv, tri


def twin_ldl(tree: LDLTree, A: np.ndarray, b: np.ndarray):
    """LDLTree.factor / solve on float32 CPU tensors: (x, 1 / d, {(i, j): L})."""
    M = {(i, j): torch.tensor([A[i, j]]) for (i, j) in tree.pat}
    L, dinv = tree.factor(M)
    z = tree.solve(L, dinv, [torch.tensor([v]) for v in b.astype(np.float32)])
    as_np = lambda ts: np.array([t.item() for t in ts], np.float32)  # noqa: E731
    return as_np(z), as_np(dinv), {k: np.float32(v.item()) for k, v in L.items()}


def assert_bits(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.array_equal(np.isnan(got), np.isnan(want)), what
    ok = np.isnan(want) | (got.view(np.uint32) == want.view(np.uint32))
    assert ok.all(), f"{what}: differs at {np.flatnonzero(~ok)[:8]}"


def check(fn, tree, A, b, ceiling, outside=0.0):
    x, dinv, tri = kernel_ldl(fn, tree, A, b, ceiling, outside)
    zx, zd, zL = twin_ldl(tree, A, b)
    assert_bits(x, zx, "x")
    assert_bits(dinv, zd, "1 / d")
    keys = sorted(zL)
    assert_bits([tri[i * (i + 1) // 2 + j] for (i, j) in keys], [zL[k] for k in keys], "L")
    return x


@pytest.mark.parametrize("nv,which,ceiling", [
    (20, "M", 24), (20, "H", 24), (20, "H", 32), (30, "M", 32), (30, "H", 32)])
def test_standin_patterns_bit_for_bit(emu_ldl, standin_trees, nv, which, ceiling):
    """The stand-in's M and H patterns (dense after the free joint's fill-in),
    random SPD matrices over six decades each way: the kernel's x, 1 / d and
    L equal the twin's bits, at the model's ceiling and a larger one."""
    tree = standin_trees[nv][which == "H"]
    mask = cuda_step._masks(nv, tree.pat, strict=True).view(np.uint32)
    assert all(int(mask[i]) == (1 << i) - 1 for i in range(nv))  # dense: no test per term
    rng = np.random.RandomState(nv + ceiling + (which == "H"))
    for _ in range(3):
        A = spd_on(tree, rng)
        assert np.abs(A).max() / np.abs(A[A != 0]).min() > 1e8  # ten decades or more
        x = check(emu_ldl, tree, A, rng.normal(size=nv) * 10.0 ** rng.uniform(-3, 3, nv),
                  ceiling)
        assert np.isfinite(x).all()


@pytest.mark.parametrize("nv,ceiling", [(12, 24), (24, 24), (32, 32)])
def test_sparse_forest_pattern_bit_for_bit(emu_ldl, nv, ceiling):
    """A forest pattern (sparse after fill-in): each term taken only where
    both rows hold it, in the twin's order; the entries outside the pattern
    hold NaN in the kernel's triangle and never reach x, 1 / d or L."""
    tree = forest_tree(nv)
    assert len(tree.pat) < nv * (nv + 1) // 2  # sparse
    rng = np.random.RandomState(nv)
    for _ in range(3):
        A = spd_on(tree, rng)
        x = check(emu_ldl, tree, A, rng.normal(size=nv), ceiling, outside=math.nan)
        assert np.isfinite(x).all()


@pytest.mark.parametrize("where", ["diagonal", "below", "rhs"])
def test_nan_propagates_as_in_the_twin(emu_ldl, standin_trees, where):
    """A NaN in A (on the diagonal or below it) or in b spreads through the
    factor and the solve to the same entries as in the twin."""
    tree = standin_trees[20][1]
    rng = np.random.RandomState(5)
    A, b = spd_on(tree, rng), rng.normal(size=20).astype(np.float32)
    if where == "diagonal":
        A[7, 7] = np.nan
    elif where == "below":
        A[11, 4] = A[4, 11] = np.nan
    else:
        b[9] = np.nan
    x = check(emu_ldl, tree, A, b, 24)
    assert np.isnan(x).any()
