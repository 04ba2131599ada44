"""The port's deploy tools (open_duck_playground_tpu_torch/deploy/) against
the JAX package's and against MuJoCo C, on the stand-in duck's
flat_terrain_backlash scene.

- the numpy twins (rewards, imitation reward, reference motion) against the
  JAX package's copies and its jnp functions;
- the 50 Hz policy loop against the JAX package's, on a fake engine host
  with seeded numpy sensors: obs and motor targets identical, joystick
  (with the gait-clock metadata) and standing;
- the port's engine (SimInfer on the kernel's plain version, one env)
  against MuJoCo C from the home keyframe, and its step_control against a
  direct FusedPhysics call;
- the C++ policy runtime against the numpy ONNX interpreter;
- the sim-to-sim gate end to end on the CPU;
- SimInfer runs on the card unless given device="cpu".
A tick of the port's engine on the CPU takes seconds, so every rollout here
is a few ticks.
"""

import json
import shutil
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_duck_playground_tpu.deploy import custom_rewards_numpy as jcrn
from open_duck_playground_tpu.deploy import rewards_numpy as jrn
from open_duck_playground_tpu.deploy.policy_loop import PolicyLoopMixin as JaxPolicyLoopMixin
from open_duck_playground_tpu.deploy.poly_reference_motion_numpy import (
    PolyReferenceMotion as JaxNpPRM,
)
from open_duck_playground_tpu.envs import imitation as jimitation
from open_duck_playground_tpu.envs import rewards as jrw
from open_duck_playground_tpu.envs.reference_motion import PolyReferenceMotion as JaxPRM
from open_duck_playground_tpu_torch.deploy import custom_rewards_numpy as crn
from open_duck_playground_tpu_torch.deploy import rewards_numpy as rn
from open_duck_playground_tpu_torch.deploy import sim2sim_check
from open_duck_playground_tpu_torch.deploy.policy_loop import PolicyLoopMixin
from open_duck_playground_tpu_torch.deploy.poly_reference_motion_numpy import (
    PolyReferenceMotion as NpPRM,
)
from open_duck_playground_tpu_torch.export.export import export_onnx
from open_duck_playground_tpu_torch.models.open_duck_mini_v2 import constants
from open_duck_playground_tpu_torch.train import networks as nets
from tests.torch_helpers import standin_assets

pytest_plugins = ["tests.torch_lock"]  # never beside tests/test_resume.py (see there)

TASK = "flat_terrain_backlash"
# SimInfer(device="cpu") against MuJoCo C on the stand-in, from the home
# keyframe (measured: tick-0 obs max |d| 4.8e-08; after 3 ticks of the home
# targets, base height |d| under 1e-4 m)
TICK0_OBS_ATOL = 1e-5
BASE_HEIGHT_ATOL = 2e-3


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    with standin_assets(str(tmp_path_factory.mktemp("standin"))) as r:
        yield r


def _onnx(path, obs_size, metadata=None, seed=0):
    """A policy ONNX written by the port's export_onnx from seeded params
    (with non-trivial normalizer statistics)."""
    obs_sizes = {"state": obs_size, "privileged_state": 153}
    network = nets.PPONetworks(obs_sizes, 14, generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    normalizer = nets.rs_update(nets.rs_init(obs_sizes), {
        "state": 0.5 * torch.randn((64, obs_size), generator=g),
        "privileged_state": torch.zeros(64, 153)})
    export_onnx((normalizer, network), 14, None, obs_size, output_path=str(path),
                metadata=metadata)
    return str(path)


@pytest.fixture(scope="module")
def policies(root, tmp_path_factory):
    d = tmp_path_factory.mktemp("onnx")
    return {"joystick": _onnx(d / "joystick.onnx", 101, {"phase_frequency_vx_ref": "0.094",
                                                          "phase_frequency_max": "1.4"}),
            "standing": _onnx(d / "standing.onnx", 85, seed=2)}


def test_numpy_twins_match_jax():
    """The port's rewards_numpy and custom_rewards_numpy against the JAX
    package's copies (equal) and its jnp functions."""
    rng = np.random.RandomState(0)
    cmd = rng.randn(7).astype(np.float32)
    vel = rng.randn(3).astype(np.float32)
    qpos = rng.randn(14).astype(np.float32)
    qvel = rng.randn(14).astype(np.float32)
    default = rng.randn(14).astype(np.float32)
    contact = np.array([1.0, 0.0], np.float32)
    j = jnp.asarray
    cases = [
        ("reward_tracking_lin_vel", (cmd, vel, 0.01)),
        ("reward_tracking_ang_vel", (cmd, vel, 0.01)),
        ("cost_lin_vel_z", (vel,)),
        ("cost_ang_vel_xy", (vel,)),
        ("cost_orientation", (vel,)),
        ("cost_base_height", (vel[0], 0.15)),
        ("cost_torques", (qpos,)),
        ("cost_energy", (qpos, qvel)),
        ("cost_action_rate", (qpos, qvel)),
        ("cost_joint_pos_limits", (qpos, default - 1.0, default + 1.0)),
        ("cost_stand_still", (cmd * 0.001, qpos, qvel, default)),
        ("cost_stand_still", (cmd * 0.001, qpos, qvel, default, True)),
        ("cost_head_pos", (qpos, qvel, cmd)),
        ("cost_head_pos", (qpos, qvel, cmd * 0.001)),
        ("cost_feet_slip", (contact, vel)),
        ("reward_feet_air_time", (vel[:2], contact, cmd)),
    ]
    assert {n for n in dir(rn) if not n.startswith("_")} == {n for n in dir(jrn)
                                                            if not n.startswith("_")}
    for name, args in cases:
        got = getattr(rn, name)(*args)
        np.testing.assert_array_equal(got, getattr(jrn, name)(*args), err_msg=name)
        if hasattr(jrw, name):
            want = getattr(jrw, name)(*[j(a) if isinstance(a, np.ndarray) else a for a in args])
            np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-6,
                                       err_msg=name)

    ref = rng.randn(40).astype(np.float32)
    base_qpos, base_qvel = rng.randn(7).astype(np.float32), rng.randn(6).astype(np.float32)
    for c in (np.array([0.1, 0, 0, 0, 0, 0, 0], np.float32), np.zeros(7, np.float32)):
        args = (base_qpos, base_qvel, qpos, qvel, contact, ref, c, True)
        a = crn.reward_imitation(*args)
        np.testing.assert_array_equal(a, jcrn.reward_imitation(*args))
        b = jimitation.reward_imitation(*[j(x) if isinstance(x, np.ndarray) else x for x in args])
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-5)
    assert crn.reward_imitation(*args[:-1], False) == 0.0


def test_reference_motion_numpy_matches_jax(root):
    path = constants.reference_motion_path()
    prm, jnp_prm, jax_prm = NpPRM(path), JaxNpPRM(path), JaxPRM(path)
    assert prm.nb_steps_in_period == jnp_prm.nb_steps_in_period == jax_prm.nb_steps_in_period
    for cmd in [(0.0, 0.0, 0.0), (0.1, -0.05, 0.3), (-0.2, 0.15, -1.5)]:
        for i in [0, 7, prm.nb_steps_in_period - 1]:
            a = prm.get_reference_motion(*cmd, i)
            np.testing.assert_array_equal(a, jnp_prm.get_reference_motion(*cmd, i))
            b = np.asarray(jax_prm.get_reference_motion(*[jnp.asarray(c) for c in cmd], i))
            # f32 Horner on degree-15 polynomials (the JAX training path)
            np.testing.assert_allclose(b, a, rtol=1e-2, atol=5e-3)


class _FakeHost:
    """An engine host with the accessor API of SimInferBase / MJInferBase
    and seeded numpy state: every step_control draws the next sensors,
    joints and contacts from its own stream."""

    def __init__(self, seed: int):
        self._rng = np.random.RandomState(seed)
        self.num_dofs = 14
        self.sim_dt, self.decimation = 0.002, 10
        self.default_actuator = self._rng.uniform(-0.5, 0.5, 14)
        self.motor_targets = self.default_actuator.copy()
        self.prev_motor_targets = self.default_actuator.copy()
        self.applied = []
        self._draw()

    def _draw(self):
        r = self._rng
        self.data = types.SimpleNamespace(qpos=r.uniform(-1, 1, 21), qvel=r.uniform(-2, 2, 20))
        self._sensors = {"gyro": r.uniform(-1, 1, 3), "accelerometer": r.uniform(-9, 9, 3),
                         "upvector": r.uniform(-1, 1, 3)}
        self._contacts = (r.uniform(size=2) < 0.5).astype(np.float64)

    def step_control(self, targets):
        self.applied.append(np.array(targets))
        self._draw()

    @property
    def qpos(self):
        return self.data.qpos

    def get_actuator_joints_qpos(self, qpos):
        return np.asarray(qpos)[7:21]

    def get_actuator_joints_qvel(self, qvel):
        return np.asarray(qvel)[6:20]

    def get_gyro(self, data):
        return self._sensors["gyro"]

    def get_accelerometer(self, data):
        return np.array(self._sensors["accelerometer"])

    def get_gravity(self, data):
        return self._sensors["upvector"]

    def get_feet_contacts(self, data):
        return self._contacts


class _PortLoop(PolicyLoopMixin, _FakeHost):
    pass


class _JaxLoop(JaxPolicyLoopMixin, _FakeHost):
    pass


@pytest.mark.parametrize("task", ["joystick", "standing"])
def test_policy_loop_matches_jax(root, policies, task):
    """10 control ticks of the port's PolicyLoopMixin and the JAX
    package's over the same fake host and ONNX: obs and motor targets
    identical (float64 numpy on both sides)."""
    standing = task == "standing"
    loops = []
    for cls in (_PortLoop, _JaxLoop):
        loop = cls(seed=11)
        loop.init_policy_loop(constants.reference_motion_path(), policies[task], standing)
        loop.commands = [0.0, 0.0, 0.0, 0.2, 0.2, 0.5, 0.0] if standing else [
            0.12, 0.0, 0.3, 0.0, 0.1, 0.0, 0.0]
        for _ in range(10):
            loop.step_control(loop.control_step())
        loops.append(loop)
    port, ref = loops
    if not standing:
        assert port.phase_freq_vx_ref == ref.phase_freq_vx_ref == 0.094
    assert len(port.saved_obs) == 10 and port.saved_obs[0].shape == ((85,) if standing else (101,))
    for a, b in zip(port.saved_obs, ref.saved_obs):
        assert a.dtype == b.dtype == np.float64
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.stack(port.applied), np.stack(ref.applied))


def test_own_engine_matches_mujoco_and_its_fused_step(root, policies):
    """SimInfer(device="cpu") and MuJoCo C from the home keyframe: the
    tick-0 obs agree within TICK0_OBS_ATOL; after 3 ticks of the home
    targets both stand upright and their base heights agree within
    BASE_HEIGHT_ATOL. SimInferBase.step_control is one call of the fused
    step (here its plain version), bit for bit."""
    pytest.importorskip("mujoco")
    from open_duck_playground_tpu_torch.deploy.mujoco_infer import MjInfer
    from open_duck_playground_tpu_torch.deploy.sim_infer import SimInfer
    from open_duck_playground_tpu_torch.ops.cuda_step import FusedPhysics

    args = (constants.task_to_xml(TASK), constants.reference_motion_path(), policies["standing"],
            True)
    own, mj = SimInfer(*args, device="cpu"), MjInfer(*args)
    cmd = [0.0, 0.0, 0.0, 0.2, 0.2, 0.5, 0.0]
    o_own, o_mj = own.get_obs(own.data, cmd), mj.get_obs(mj.data, cmd)
    assert o_own.shape == o_mj.shape == (85,)
    np.testing.assert_allclose(o_own, o_mj, atol=TICK0_OBS_ATOL)
    np.testing.assert_allclose(own.qpos, mj.qpos, atol=1e-6)

    fp = FusedPhysics(own.model)
    ctrl = torch.tensor(own.default_actuator, dtype=torch.float32)[None]
    d0 = own.data
    for tick in range(3):
        own.step_control(own.default_actuator)
        mj.step_control(mj.default_actuator)
        if tick == 0:
            direct = fp(d0.qpos, d0.qvel, d0.qacc_warmstart, ctrl, 10)
            for k in ("qpos", "qvel", "qacc_warmstart", "sensordata", "actuator_force"):
                assert torch.equal(getattr(own.data, k), direct[k]), k
            assert torch.equal(own.data.contact.dist, direct["contact_dist"])
    assert own.physics.launches == 0  # the CPU path launches no kernel
    assert own.get_gravity(own.data)[2] > 0.99 and mj.get_gravity(mj.data)[2] > 0.99
    assert abs(float(own.qpos[2]) - float(mj.qpos[2])) < BASE_HEIGHT_ATOL


def test_cpp_policy_runtime_matches_numpy(root, policies, tmp_path):
    if shutil.which("make") is None or shutil.which("g++") is None:
        pytest.skip("no C++ compiler (g++ and make) on this machine")
    from open_duck_playground_tpu_torch.deploy.policy_runtime import CppOnnxPolicy, build
    from open_duck_playground_tpu_torch.export.onnx_infer import NumpyOnnxSession

    lib = build(out_dir=str(tmp_path / "lib"))
    for task, obs_size in (("joystick", 101), ("standing", 85)):
        cpp = CppOnnxPolicy(policies[task], lib_path=lib)
        assert cpp.obs_size == obs_size and cpp.act_size == 14
        session = NumpyOnnxSession(policies[task])
        rng = np.random.RandomState(2)
        for _ in range(3):
            obs = rng.randn(obs_size).astype(np.float32)
            np.testing.assert_allclose(cpp.infer(obs), session.run(None, {"obs": obs[None]})[0][0],
                                       rtol=1e-5, atol=1e-6)
        cpp.close()


def test_sim2sim_gate_on_the_cpu(root, policies, capsys):
    """deploy.sim2sim_check on the CPU with the port's engine and MuJoCo C
    (a tick of the port's engine takes ~5 s here): main() for standing (two
    ticks plain, the battery off) and joystick (one tick), and the push
    battery over 2 directions with the kick at the first tick and one tick
    to recover. The JSON lines carry the JAX script's field names; main()
    returns 0 or 1 by the bar (untrained policies: a reading, not
    asserted)."""
    pytest.importorskip("mujoco")
    rc = sim2sim_check.main(["-o", policies["standing"], "--task", TASK, "--standing",
                             "--device", "cpu", "--seconds", "0.04", "--push_mag", "0"])
    rc_joy = sim2sim_check.main(["-o", policies["joystick"], "--task", TASK, "--device", "cpu",
                                 "--seconds", "0.02"])
    assert rc in (0, 1) and rc_joy in (0, 1)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    rows = {(r["engine"], r["task"], r["phase"]): r for r in lines if "engine" in r}
    assert set(rows) == {(e, t, "plain") for e in ("mujoco", "own")
                         for t in ("standing", "joystick")}
    for e in ("mujoco", "own"):
        plain = rows[(e, "standing", "plain")]
        assert {"walked_m", "forward_m", "min_up_z", "fell", "command_head"} <= set(plain)
        joy = rows[(e, "joystick", "plain")]
        assert {"walked_m", "min_up_z", "fell", "command_vx", "achieved_vx", "track_frac"} <= set(joy)
        assert np.isfinite(joy["track_frac"]) and np.isfinite(plain["min_up_z"])
        battery = sim2sim_check.run_push_battery(
            e, constants.task_to_xml(TASK), constants.reference_motion_path(),
            policies["standing"], [0.0, 0.0, 0.0, 0.2, 0.2, 0.5, 0.0], True, push_mag=0.6,
            n_dirs=2, settle_s=0.0, recover_s=0.02, device="cpu")
        assert (battery["engine"], battery["task"], battery["phase"]) == (
            e, "standing", "push_battery_0.6m/s")
        assert battery["n_dirs"] == 2 and len(battery["per_dir"]) == 2
        assert 0.0 <= battery["survival_frac"] <= 1.0
    bars = [r for r in lines if "pass" in r]
    assert len(bars) == 2 and bars[0]["pass"] == (rc == 0) and bars[1]["pass"] == (rc_joy == 0)
    assert bars[0]["pushed_pass"] is None


def test_sim_infer_defaults_to_the_card(root, policies):
    """SimInfer runs on the card unless given a CPU device: without CUDA a
    call that names no device raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from open_duck_playground_tpu_torch.deploy.sim_infer import SimInfer

    args = (constants.task_to_xml(TASK), constants.reference_motion_path(), policies["standing"],
            True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SimInfer(*args)
