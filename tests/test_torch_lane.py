"""The kernel module: the port's plain PyTorch physics step ("twin",
open_duck_playground_tpu_torch/ops/lane_physics.py) against the JAX
package's LanePhysics, run eagerly on CPU on (B,) arrays, as
tests/test_lane.py runs the Pallas kernel's body. Both packages compute on
the same model (carried across with interop) and the same numpy inputs.

The two are the same straight-line program, so stage outputs agree to
float32 rounding. Full substeps are compared on settled states only, with
test_lane's quantile bounds: the iterations=1 Newton step is discontinuous
where a friction row sits at its Huber breakpoint or a contact at
activation, so a last-bit difference can flip an env's active set.

The rough (heightfield) scene: the gather and the heightfield stage are
held exactly (to 1e-6) against the JAX package's "direct" and "onehot"
gathers on identical inputs; full substeps against the JAX lane program with
its "onehot" gather, the TPU kernel's body.

The CUDA kernel itself is checked against the twin on the card by
tests/test_torch_cuda.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_duck_playground_tpu.ops import lane as jax_lane_ops

from open_duck_playground_tpu.envs import randomize as jax_randomize
from open_duck_playground_tpu.mjcf import compile_mjcf as jax_compile
from open_duck_playground_tpu.ops.lane_physics import LanePhysics as JaxLane
from open_duck_playground_tpu_torch import interop
from open_duck_playground_tpu_torch.ops import cuda_step
from open_duck_playground_tpu_torch.ops import lane as torch_lane_ops
from open_duck_playground_tpu_torch.ops.lane_physics import DR_FIELDS
from open_duck_playground_tpu_torch.ops.lane_physics import LanePhysics as TorchLane
from tests import duck_standin
from tests.duck_standin import settled_states
from tests.torch_helpers import jax_model_fields, random_states, scene, standin_assets

pytest_plugins = ["tests.torch_lock"]  # never beside tests/test_resume.py (see there)

B = 16


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    with standin_assets(str(tmp_path_factory.mktemp("standin"))) as r:
        yield r


def _models(root, name):
    jm = jax_compile(scene(root, name), timestep=0.002)
    return jm, interop.model_from_numpy(jax_model_fields(jm))


@pytest.fixture(scope="module")
def flat(root):
    jm, tm = _models(root, "scene_flat_terrain.xml")
    return jm, tm, JaxLane(jm), TorchLane(tm)


@pytest.fixture(scope="module")
def rough(root):
    jm, tm = _models(root, "scene_rough_terrain_backlash.xml")
    return jm, tm, JaxLane(jm), TorchLane(tm)


def _dr_numpy(jm, n, seed=0):
    """JAX's DR draws for n envs, flat (n, rows) numpy per field."""
    import jax

    mv, _ = jax_randomize.domain_randomize(jm, jax.random.split(jax.random.PRNGKey(seed), n))
    return {f: np.asarray(getattr(mv, f)).reshape(n, -1) for f in DR_FIELDS}


def _nest(flat_dr, m, tile):
    """Flat (B, rows) DR fields -> the nested per-element tiles LanePhysics reads."""
    out = {}
    for f, x in flat_dr.items():
        dims = cuda_step._DR_SHAPES[f]
        if len(dims) == 1:
            out[f] = [tile(x[:, i]) for i in range(x.shape[1])]
        else:
            n0, n1 = getattr(m, dims[0]), dims[1]
            out[f] = [[tile(x[:, i * n1 + j]) for j in range(n1)] for i in range(n0)]
    return out


def _jt(x):
    return jnp.asarray(np.ascontiguousarray(x))


def _tt(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _lanes(x, tile):
    return [tile(x[:, i]) for i in range(x.shape[1])]


def _np(lanes, n=B):
    return np.stack([np.broadcast_to(np.asarray(v), (n,)) for v in lanes], 1)


def _stages(lane, qpos, qvel, ctrl, dr, tile):
    lq, lv, lc = _lanes(qpos, tile), _lanes(qvel, tile), _lanes(ctrl, tile)
    xpos, xquat, xanchor, xaxis = lane.kinematics(lq, dr)
    subtree_com, _, cinert, cdof = lane.com_pos(xpos, xquat, xanchor, xaxis, dr)
    M = lane.crb(cinert, cdof, dr)
    contacts = lane.collide(xpos, xquat)
    cvel, cdofdot = lane.com_vel(cdof, lv)
    qfrc_bias = lane.rne(cinert, cdof, cdofdot, cvel, lv)
    force, qfrc_act = lane.actuation(lq, lv, lc, dr)
    qfrc_smooth = [qfrc_act[i] - qfrc_bias[i] - float(lane.c.dof_damping[i]) * lv[i]
                   for i in range(lane.m.nv)]
    L, dinv = lane.ldl.factor(M)
    qacc_smooth = lane.ldl.solve(L, dinv, qfrc_smooth)
    rows = lane.make_efc(lv, lq, contacts, cdof, subtree_com, dr)
    dist = _np([d for (cand, _, _) in contacts for (d, _, _) in cand])
    pos = np.stack([_np(p) for (cand, _, _) in contacts for (_, p, _) in cand], 1)
    J = np.zeros((B, len(rows), lane.m.nv), np.float32)
    for r_i, r in enumerate(rows):
        for (dof, cf) in r["support"]:
            J[:, r_i, dof] = np.broadcast_to(np.asarray(cf), (B,))
    return dict(
        M={k: np.broadcast_to(np.asarray(v), (B,)) for k, v in M.items()},
        dist=dist, pos=pos, force=_np(force), qacc_smooth=_np(qacc_smooth), J=J,
        D=_np([r["D"] for r in rows]), aref=_np([r["aref"] for r in rows]),
    )


@pytest.mark.parametrize("with_dr", [False, True])
def test_twin_stages_match_jax_lane(flat, with_dr):
    """Solver inputs, M, contacts and actuation on random states."""
    jm, tm, jl, tl = flat
    kf = jm.keyframe("home")
    qpos, qvel, ctrl = random_states(kf, jm.nq, jm.nv, jm.nu, B, seed=3)
    dr_j = dr_t = None
    if with_dr:
        d = _dr_numpy(jm, B)
        dr_j, dr_t = _nest(d, jm, _jt), _nest(d, tm, _tt)
    a = _stages(jl, qpos, qvel, ctrl, dr_j, _jt)
    b = _stages(tl, qpos, qvel, ctrl, dr_t, _tt)
    for k in a["M"]:
        np.testing.assert_allclose(b["M"][k], a["M"][k], atol=2e-5)
    np.testing.assert_allclose(np.minimum(b["dist"], 1e9), np.minimum(a["dist"], 1e9),
                               rtol=1e-4, atol=1e-6)
    # test_lane's tolerances on the solver inputs
    np.testing.assert_allclose(b["qacc_smooth"], a["qacc_smooth"], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(b["force"], a["force"], rtol=2e-3, atol=2e-3)
    # manifold tie-breaks (symmetric sole vertices at equal depth) may pick
    # another vertex on a last-bit difference: compare contact rows whose
    # selected position matches, and require the flip rate to be small
    con_match = (np.abs(b["pos"] - a["pos"]) < 1e-4).all(-1)
    assert con_match.mean() > 0.9, con_match.mean()
    n_pre = a["J"].shape[1] - 4 * con_match.shape[1]
    row_match = np.concatenate([np.ones((B, n_pre), bool), np.repeat(con_match, 4, 1)], 1)
    np.testing.assert_allclose(np.where(row_match[..., None], b["J"], 0),
                               np.where(row_match[..., None], a["J"], 0), atol=2e-5)
    np.testing.assert_allclose(b["D"], a["D"], rtol=2e-3)
    np.testing.assert_allclose(np.where(row_match, b["aref"], 0),
                               np.where(row_match, a["aref"], 0), rtol=2e-3, atol=1e-3)


def _settled_runs(models, **jax_kw):
    """One substep (warm start 0) and one 10-substep control step, both
    packages, settled states, DR on."""
    jm, tm, jl, tl = models
    kf = jm.keyframe("home")
    qpos, qvel, ctrl = settled_states(kf, jm.nq, jm.nv, jm.nu, B, seed=0)
    d = _dr_numpy(jm, B, seed=1)
    warm = np.zeros((B, jm.nv), np.float32)
    out = {}
    for n in (1, 10):
        a = jl.step_n(_lanes(qpos, _jt), _lanes(qvel, _jt), _lanes(ctrl, _jt), n,
                      dr=_nest(d, jm, _jt), warm=_lanes(warm, _jt), **jax_kw)
        b = tl.step_n(_lanes(qpos, _tt), _lanes(qvel, _tt), _lanes(ctrl, _tt), n,
                      dr=_nest(d, tm, _tt), warm=_lanes(warm, _tt))
        out[n] = (a, b)
    return out


@pytest.fixture(scope="module")
def settled_runs(flat):
    return _settled_runs(flat)


@pytest.fixture(scope="module")
def rough_runs(rough):
    """As settled_runs on the rough scene, whose home keyframe stands on the
    terrain, against the JAX lane program with its "onehot" gather."""
    return _settled_runs(rough, gather="onehot")


@pytest.mark.parametrize("runs,n", [pytest.param("settled_runs", 1, id="1"),
                                    pytest.param("settled_runs", 10, id="10"),
                                    pytest.param("rough_runs", 10, id="rough-10")])
def test_twin_step_matches_jax_lane_settled(request, runs, n):
    """qpos / qvel / sensordata after 1 and after 10 substeps, with
    test_lane's bounds for its settled-substep test (lane vs XLA there).

    One substep: all of them, including "30% of envs track to 1e-4".
    Ten substeps: the active-set flips of the truncated solver compound
    (XLA:CPU's and torch's sin/cos differ in the last bit, and each flip
    moves every dof of its env), so the per-env q30 bound is replaced by
    test_lane's bound for its chaotic scenes (backlash, heightfield): at
    least one env tracks to 1e-4. Measured on this draw (bounds in
    brackets): 1 substep: qpos q95 4.5e-8 [2e-4], max 1.1e-6 [2e-3]; qvel
    q50 0 [1e-3], max 5.7e-4 [0.5]; per-env q30 0 [1e-4]. 10 substeps: qpos
    q95 6.6e-5, max 2.3e-4; qvel q50 1.1e-4, max 5.0e-2; per-env min 4.5e-8
    [1e-4] (q30 2.0e-4); sensordata q85 1.7e-4 [1e-2].

    The rough scene (the 30-dof backlash duck on the heightfield) takes the
    same bounds but one: after 10 substeps none of its envs tracks to 1e-4.
    The backlash duck's 10 backlash joints (+-0.5 degree ranges) sit at a
    limit's activation in every env, so every env flips (why
    test_twin_backlash_model holds it for one substep only). Measured on
    this draw: per-env min 1.0e-3 [5e-3] (q30 3.3e-3); qpos q95 1.5e-4, max
    5.0e-4; qvel q50 9.2e-4, max 5.2e-2; sensordata q85 1.2e-3."""
    (qp_a, qv_a, w_a, der_a), (qp_b, qv_b, w_b, der_b) = request.getfixturevalue(runs)[n]
    qp_err = np.abs(_np(qp_b) - _np(qp_a))
    qv_err = np.abs(_np(qv_b) - _np(qv_a))
    per_env = qv_err.max(axis=1)
    assert np.quantile(qp_err, 0.95) < 2e-4, np.quantile(qp_err, 0.95)
    assert qp_err.max() < 2e-3, qp_err.max()
    assert np.quantile(qv_err, 0.5) < 1e-3, np.quantile(qv_err, 0.5)
    if n == 1:
        assert np.quantile(per_env, 0.3) < 1e-4, np.quantile(per_env, 0.3)
    else:
        assert per_env.min() < (1e-4 if runs == "settled_runs" else 5e-3), per_env
    assert qv_err.max() < 0.5, qv_err.max()
    sd_err = np.abs(_np(der_b["sensordata"]) - _np(der_a["sensordata"]))
    assert np.quantile(sd_err, 0.85) < 1e-2, np.quantile(sd_err, 0.85)
    assert sd_err.max() < 50.0, sd_err.max()


def test_twin_init_variant_matches_jax_lane(settled_runs):
    """The init variant's derived outputs (one substep, taken before its
    integration): no solver chaos reaches them except through
    sensordata's accelerometer, so they are held tightly."""
    (_, _, _, der_a), (_, _, _, der_b) = settled_runs[1]
    np.testing.assert_allclose(_np(der_b["actuator_force"]), _np(der_a["actuator_force"]),
                               rtol=2e-3, atol=2e-3)
    cd_a, cd_b = _np(der_a["contact_dist"]), _np(der_b["contact_dist"])
    np.testing.assert_array_equal(cd_b < 1e9, cd_a < 1e9)
    both = (cd_a < 1e9) & (cd_b < 1e9)
    np.testing.assert_allclose(cd_b[both], cd_a[both], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(_np(der_b["site_xpos"]), _np(der_a["site_xpos"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_np(der_b["site_xmat"]), _np(der_a["site_xmat"]), atol=1e-5)


def test_twin_backlash_model(root):
    """The 30-dof backlash scene at B=4, as test_lane's backlash test: one env
    must track essentially exactly, the rest get loose physical bounds."""
    jm, tm = _models(root, "scene_flat_terrain_backlash.xml")
    jl, tl = JaxLane(jm), TorchLane(tm)
    n = 4
    qpos, qvel, ctrl = settled_states(jm.keyframe("home"), jm.nq, jm.nv, jm.nu, n, seed=5)
    warm = np.zeros((n, jm.nv), np.float32)
    a = jl.step_n(_lanes(qpos, _jt), _lanes(qvel, _jt), _lanes(ctrl, _jt), 1,
                  warm=_lanes(warm, _jt))
    b = tl.step_n(_lanes(qpos, _tt), _lanes(qvel, _tt), _lanes(ctrl, _tt), 1,
                  warm=_lanes(warm, _tt))
    qp_err = np.abs(_np(b[0], n) - _np(a[0], n))
    qv_err = np.abs(_np(b[1], n) - _np(a[1], n))
    assert qv_err.max(axis=1).min() < 1e-4, qv_err.max(axis=1)
    assert qp_err.max() < 2e-3, qp_err.max()
    assert qv_err.max() < 0.5, qv_err.max()


# ---------------------------------------------------------------------------
# the wrapper (ops/cuda_step.py)
# ---------------------------------------------------------------------------


def test_wrapper_cpu_path_is_the_twin(flat):
    jm, tm, _, tl = flat
    fp = cuda_step.FusedPhysics(tm)
    qpos, qvel, ctrl = (_tt(x) for x in settled_states(jm.keyframe("home"), jm.nq, jm.nv,
                                                       jm.nu, 4, seed=2))
    warm = torch.zeros_like(qvel)
    out = fp(qpos, qvel, warm, ctrl, 2)
    qp, qv, w, der = tl.step_n(_lanes(qpos, lambda x: x), _lanes(qvel, lambda x: x),
                               _lanes(ctrl, lambda x: x), 2, warm=_lanes(warm, lambda x: x))
    torch.testing.assert_close(out["qpos"], torch.stack(qp, 1), rtol=0, atol=0)
    torch.testing.assert_close(out["qacc_warmstart"], torch.stack(w, 1), rtol=0, atol=0)
    assert out["site_xpos"].shape == (4, 3 * tm.nsite)
    assert out["contact_dist"].shape == (4, tm.ncon)
    assert fp.launches == 0


def test_wrapper_never_falls_back(flat):
    """Off the CPU the wrapper launches the kernel or raises: no quiet CPU
    path. Without a card (and without nvcc) the CUDA branch must raise."""
    _, tm, _, _ = flat
    fp = cuda_step.FusedPhysics(tm)
    x = torch.zeros(2, tm.nq, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fp(x, x, x, x, 1)
    if torch.cuda.is_available():
        pytest.skip("a card is present; the kernel path is tested on it")
    qpos = torch.zeros(2, tm.nq)
    qvel = torch.zeros(2, tm.nv)
    ctrl = torch.zeros(2, tm.nu)
    with pytest.raises(RuntimeError):
        fp._launch(qpos, qvel, qvel, ctrl, 1, None)
    assert fp.launches == 0
    from open_duck_playground_tpu_torch.envs.joystick import Joystick

    with pytest.raises((RuntimeError, AssertionError)):
        Joystick("flat_terrain", device="cuda")


@pytest.mark.parametrize("name", ["scene_flat_terrain.xml", "scene_flat_terrain_backlash.xml",
                                  "scene_rough_terrain_backlash.xml"])
def test_pack_model_tables(root, name):
    """The kernel's model tables: row counts, masks and pair data as the
    twin derives them."""
    tm = interop.model_from_numpy(jax_model_fields(
        jax_compile(scene(root, name), timestep=0.002)))
    lane = TorchLane(tm)
    p = cuda_step.pack_model(lane)
    a, sz = p["arrays"], p["sizes"]
    assert sz["nfri"] == len(lane.fri_dofs) == 14
    assert sz["nlim"] == len(lane.lim_jnts)
    assert sz["nefc"] == 14 + sz["nlim"] + 16 * tm.npair
    assert a["pair_i"].shape == (tm.npair, 13) and a["pair_f"].shape == (tm.npair, 39)
    assert a["lim_prm"].shape == (sz["nlim"], 14) and a["act_prm"].shape == (tm.nu, 9)
    tree = a["tree_mask"].view(np.uint32)
    for (i, j) in lane.tree_pat:
        assert tree[i] >> j & 1
    ldlh = a["ldlh_mask"].view(np.uint32)
    for (i, j) in lane.ldl_h.pat:
        if j < i:
            assert ldlh[i] >> j & 1
    for v in a.values():
        assert v.dtype in (np.int32, np.float32) and v.flags["C_CONTIGUOUS"]
    hf_pairs = [p for p in range(tm.npair) if int(tm.pair_type[p]) == 1]
    if "rough" not in name:
        assert not hf_pairs and "hfield_data" not in a and sz["hfield_nrow"] == 0
        return
    # heightfield pairs: the terrain's pose (static body at the origin), the
    # table row major and not transposed, its constants as float32
    assert len(hf_pairs) == 2 and (sz["hfield_nrow"], sz["hfield_ncol"]) == (256, 256)
    np.testing.assert_array_equal(a["hfield_data"], tm.hfield_data.numpy())
    for p in hf_pairs:
        np.testing.assert_array_equal(a["pair_f"][p, 27:30], 0.0)
        np.testing.assert_array_equal(a["pair_f"][p, 30:39], np.eye(3, dtype=np.float32).ravel())
    rx, ry, ztop = 10.0, 10.0, 0.01
    np.testing.assert_array_equal(a["hfield_prm"], np.float32(
        [rx, ry, 2 * rx, 2 * ry, 255, 255, 254.999, 254.999, ztop, 2 * rx / 255, 2 * ry / 255]))


def test_pack_model_rejects_an_unknown_pair_type(root):
    """Every pair type is handled by name: another one raises in the
    wrapper's packing and in the twin, and never runs as some other type."""
    tm = interop.model_from_numpy(jax_model_fields(
        jax_compile(scene(root, "scene_rough_terrain_backlash.xml"), timestep=0.002)))
    bad = tm.replace(pair_type=type(tm.pair_type)(np.full(tm.npair, 3, np.int32)))
    lane = TorchLane(bad)
    with pytest.raises(NotImplementedError, match="pair type 3"):
        cuda_step.pack_model(lane)
    qpos, qvel, ctrl = (_tt(x) for x in settled_states(tm.keyframe("home"), tm.nq, tm.nv,
                                                       tm.nu, 2))
    with pytest.raises(NotImplementedError, match="pair type 3"):
        lane.step_n(_lanes(qpos, lambda x: x), _lanes(qvel, lambda x: x),
                    _lanes(ctrl, lambda x: x), 1)


# ---------------------------------------------------------------------------
# the heightfield path (rough scene)
# ---------------------------------------------------------------------------


def test_hf_gather_matches_jax_direct_and_onehot(rough):
    """Corner heights of a hull's vertices: the port's indexed loads against
    the JAX package's "direct" indexing and its "onehot" window matmul (the
    TPU kernel's), on random cells of the 256x256 table, the last row and
    column included. The one-hot window equals direct indexing when its K
    covers the hull's span (K = ceil(hull diagonal / cell) + 2, the JAX
    package's _hf_window_K), as here: equal, exactly."""
    jm, tm, jl, tl = rough
    H = np.asarray(jl.c.hfield_data, np.float32)
    nrow, ncol = H.shape
    K = jl._hf_window_K(int(jm.geom_dataid[jm.geom("left_foot_bottom_tpu")]))
    rng = np.random.RandomState(0)
    n, V = 64, 17
    base_y, base_x = rng.randint(0, nrow - 1, n), rng.randint(0, ncol - 1, n)
    base_y[:8], base_x[4:12] = nrow - 2, ncol - 2  # cells on the last row / column
    base_y[12], base_x[12] = 0, 0
    iys = [np.clip(base_y + rng.randint(0, K - 1, n), 0, nrow - 2).astype(np.int32)
           for _ in range(V)]
    ixs = [np.clip(base_x + rng.randint(0, K - 1, n), 0, ncol - 2).astype(np.int32)
           for _ in range(V)]
    port = torch_lane_ops.hf_window_corners(torch.from_numpy(H), [_tt(i) for i in iys],
                                            [_tt(i) for i in ixs])
    direct = jax_lane_ops.hf_window_corners(jnp.asarray(H), [_jt(i) for i in iys],
                                            [_jt(i) for i in ixs], K, "direct")
    onehot = jax_lane_ops.hf_window_corners(jnp.asarray(H.T), [_jt(i) for i in iys],
                                            [_jt(i) for i in ixs], K, "onehot")
    for v in range(V):
        for k in range(4):
            got = port[v][k].numpy()
            np.testing.assert_array_equal(got, np.asarray(direct[v][k]))
            np.testing.assert_array_equal(got, np.asarray(onehot[v][k]))


def test_hf_indices_and_interp_match_jax(rough):
    """Cell lookup (beyond the table's edges, on cell boundaries) and the
    triangulated interpolation (on and beside a cell diagonal fx + fy = 1),
    on identical inputs: indices, fractions and heights equal; the normal
    within 1e-6, as torch's CPU sqrt is not always correctly rounded (one
    ulp off XLA's and numpy's in a few inputs)."""
    jm, tm, jl, tl = rough
    rng = np.random.RandomState(1)
    cell = 20.0 / 255
    x = np.concatenate([rng.uniform(-12, 12, 64), [-10.0, 10.0, -10.5, 10.5, 0.0],
                        cell * np.arange(-3, 4) - 10.0]).astype(np.float32)
    y = np.concatenate([rng.uniform(-12, 12, 64), [10.0, -10.0, 11.0, -11.0, 0.0],
                        cell * np.arange(4, -3, -1) + 10.0]).astype(np.float32)
    a = jl._hf_indices(_jt(x), _jt(y))
    b = tl._hf_indices(_tt(x), _tt(y))
    for u, w in zip(a, b):
        np.testing.assert_array_equal(w.numpy(), np.asarray(u))
    assert b[0].numpy().max() == 254 and b[0].numpy().min() == 0
    # fractions on the diagonal, and one float32 step to either side of it
    fx = np.float32(np.arange(1, 8) / 8.0)
    fx = np.concatenate([fx, fx, fx])
    fy = np.float32(1.0) - fx
    fy[7:14] = np.nextafter(fy[7:14], np.float32(2.0))
    fy[14:] = np.nextafter(fy[14:], np.float32(-1.0))
    corners = [rng.uniform(0, 1, fx.size).astype(np.float32) for _ in range(4)]
    za, na = jl._hf_interp(_jt(fx), _jt(fy), [_jt(c) for c in corners])
    zb, nb = tl._hf_interp(_tt(fx), _tt(fy), [_tt(c) for c in corners])
    np.testing.assert_array_equal(zb.numpy(), np.asarray(za))
    for u, w in zip(na, nb):
        np.testing.assert_allclose(w.numpy(), np.asarray(u), rtol=0, atol=1e-6)


def _foot_poses(tm, n, seed):
    """Random duck poses over the terrain and past its edges (|x|, |y| up
    to 12 m of a 10 m half-width), soles within 1 cm of the surface below
    the base."""
    rng = np.random.RandomState(seed)
    data = duck_standin.terrain_heights()
    qpos = np.tile(np.asarray(tm.keyframe("home").qpos, np.float32), (n, 1))
    qpos[:, :2] = rng.uniform(-12.0, 12.0, (n, 2))
    qpos[:n // 4, 0] = rng.uniform(9.9, 10.1, n // 4)  # straddling the edge
    for e in range(n):
        qpos[e, 2] = (duck_standin.standing_height() + rng.uniform(-0.01, 0.01)
                      + duck_standin.surface_height(data, float(qpos[e, 0]), float(qpos[e, 1])))
    yaw = rng.uniform(-np.pi, np.pi, n)
    qpos[:, 3], qpos[:, 6] = np.cos(yaw / 2), np.sin(yaw / 2)
    qpos[:, 7:] += rng.uniform(-0.1, 0.1, (n, tm.nq - 7)).astype(np.float32)
    return qpos


@pytest.mark.parametrize("gather", ["direct", "onehot"])
def test_twin_hfield_stage_matches_jax(rough, gather):
    """_hfield_hull on the same kinematics (random foot poses over the
    terrain and past its edges): candidate validity equal; dist, pos and the
    frame within 1e-6."""
    jm, tm, jl, tl = rough
    qpos = _foot_poses(tm, B, seed=2)
    xpos, xquat, _, _ = tl.kinematics(_lanes(qpos, _tt), None)
    to_np = lambda vs: [[np.broadcast_to(np.asarray(c), (B,)).copy() for c in v] for v in vs]  # noqa: E731
    xpos, xquat = to_np(xpos), to_np(xquat)
    n_touch = 0
    for p in range(jm.npair):
        if int(jm.pair_type[p]) != 1:
            continue
        g1, g2 = int(jm.pair_geom1[p]), int(jm.pair_geom2[p])
        ja = jl._hfield_hull(p, g1, g2, [[_jt(c) for c in v] for v in xpos],
                             [[_jt(c) for c in v] for v in xquat], None, gather)
        tb = tl._hfield_hull(p, g1, g2, [[_tt(c) for c in v] for v in xpos],
                             [[_tt(c) for c in v] for v in xquat])
        for (da, pa, va), (db, pb, vb) in zip(ja[0], tb[0]):
            np.testing.assert_array_equal(vb.numpy(), np.asarray(va))
            np.testing.assert_allclose(db.numpy(), np.asarray(da), rtol=0, atol=1e-6)
            np.testing.assert_allclose(_np(pb), _np(pa), rtol=0, atol=1e-6)
            n_touch += int(((db.numpy() < 0) & vb.numpy()).sum())
        for ra, rb in zip(ja[1], tb[1]):
            np.testing.assert_allclose(_np(rb), _np(ra), rtol=0, atol=1e-6)
    assert n_touch > B  # the poses do touch the terrain


def test_twin_rough_substep_matches_jax_onehot(rough_runs):
    """One substep on the rough scene against the JAX lane program with the
    TPU kernel's "onehot" gather (test_lane.py's heightfield protocol):
    the valid-slot pattern of contact_dist equal and |difference| <= 1e-5;
    qvel of at least one env within 1e-4, all within 0.5; qpos within
    2e-3. A pair's four candidates are compared as a set: two of them may
    trade places on a last-bit tie of the symmetric sole's vertices."""
    (qp_a, qv_a, _, der_a), (qp_b, qv_b, _, der_b) = rough_runs[1]
    cd_a, cd_b = _np(der_a["contact_dist"]), _np(der_b["contact_dist"])
    npair = cd_a.shape[1] // 4
    cd_a, cd_b = (np.sort(c.reshape(B, npair, 4), axis=2) for c in (cd_a, cd_b))
    np.testing.assert_array_equal(cd_b < 1e9, cd_a < 1e9)
    both = (cd_a < 1e9) & (cd_b < 1e9)
    assert both.sum() > B  # contacts on the terrain in most envs
    assert np.abs(cd_b[both] - cd_a[both]).max() <= 1e-5
    qp_err = np.abs(_np(qp_b) - _np(qp_a))
    qv_err = np.abs(_np(qv_b) - _np(qv_a))
    assert qv_err.max(axis=1).min() < 1e-4, qv_err.max(axis=1)
    assert qp_err.max() < 2e-3, qp_err.max()
    assert qv_err.max() < 0.5, qv_err.max()


def test_twin_zeroed_terrain_matches_flat_backlash(root, rough):
    """The rough scene with its heightfield zeroed (its surface then lies at
    the flat floor's height, z = 0) gives the flat backlash scene's contacts
    after one substep: valid slots equal, dist within 1e-6. The twin alone,
    without the JAX lane program."""
    _, tm, _, _ = rough
    zeroed = tm.replace(hfield_data=torch.zeros_like(tm.hfield_data))
    _, flat_bl = _models(root, "scene_flat_terrain_backlash.xml")
    qpos, qvel, ctrl = settled_states(flat_bl.keyframe("home"), tm.nq, tm.nv, tm.nu, B, seed=4)
    out = {}
    for name, m in (("zeroed", zeroed), ("flat", flat_bl)):
        *_, der = TorchLane(m).step_n(_lanes(qpos, _tt), _lanes(qvel, _tt), _lanes(ctrl, _tt), 1)
        cd = _np(der["contact_dist"])
        geoms = m.names.list("geom")
        out[name] = {tuple(sorted((geoms[int(m.pair_geom1[p])], geoms[int(m.pair_geom2[p])]))):
                     cd[:, 4 * p:4 * p + 4] for p in range(m.npair)}
    assert out["zeroed"].keys() == out["flat"].keys()
    n_valid = 0
    for key, a in out["flat"].items():
        b = out["zeroed"][key]
        np.testing.assert_array_equal(b < 1e9, a < 1e9)
        valid = a < 1e9
        n_valid += int(valid.sum())
        np.testing.assert_allclose(b[valid], a[valid], rtol=0, atol=1e-6)
    assert n_valid >= 2 * B  # both soles on the floor in every env
