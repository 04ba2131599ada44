"""The port's profiling utilities and its interactive and visual deploy
tools against the JAX package's, on the stand-in duck:

- utils/profiling: StepTimer's rates identical under one clock; trace on
  the CPU writes a Chrome trace that names its annotations, and on a
  missing card raises;
- deploy/viewer.py: tests/test_viewer.py's five cases on the port's
  module (live gait view included), and the key callback and the pygame
  sticks fed the same seeded events as the JAX package's: commands and the
  clock factor identical after every event;
- deploy/teleop.py: the same seeded keys (arrows as escape sequences)
  through a pipe for stdin, identical after every key;
- deploy/render.py: the same seeded frames give the same GIF bytes;
- deploy/plot_saved_obs.py: the channel names, and a PNG from two traces;
- deploy/ref_motion_viewer.py: playback on the CPU against JAX's float64
  host kinematics;
- PolicyLoopMixin.run's teleop / video hooks: against the JAX loop on a
  seeded fake engine (obs, targets and frames identical), and on the
  port's engine (SimInfer on the CPU: one engine call per tick, frames the
  tick's qpos, the command from the teleop's tick on);
- the new flags of sim_infer / mujoco_infer, and --render failing before
  the engine runs when mujoco is missing;
- none of the new modules imports jax, mujoco, matplotlib, PIL, OpenCV or
  pygame on import.
"""

import math
import os
import pickle
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from open_duck_playground_tpu.deploy import plot_saved_obs as jax_plot
from open_duck_playground_tpu.deploy import ref_motion_viewer as jax_rmv
from open_duck_playground_tpu.deploy import render as jax_render
from open_duck_playground_tpu.deploy import teleop as jax_teleop
from open_duck_playground_tpu.deploy import viewer as jax_viewer
from open_duck_playground_tpu.deploy.policy_loop import PolicyLoopMixin as JaxPolicyLoopMixin
from open_duck_playground_tpu.utils import profiling as jax_profiling
from open_duck_playground_tpu_torch.deploy import plot_saved_obs, ref_motion_viewer, render
from open_duck_playground_tpu_torch.deploy import sim_infer, teleop
from open_duck_playground_tpu_torch.deploy.policy_loop import PolicyLoopMixin
from open_duck_playground_tpu_torch.deploy.viewer import (
    COMMANDS_RANGE_THETA,
    COMMANDS_RANGE_X,
    COMMANDS_RANGE_Y,
    NECK_PITCH_RANGE,
    PygameJoystickTeleop,
    ViewerKeyTeleop,
    run_viewer,
)
from open_duck_playground_tpu_torch.models.open_duck_mini_v2 import constants
from open_duck_playground_tpu_torch.utils import profiling
from chip_smoke import RecordingVideo, ScriptedTeleop
from tests.test_torch_deploy import _FakeHost, _onnx
from tests.torch_helpers import standin_assets

pytest_plugins = ["tests.torch_lock"]  # never beside tests/test_resume.py (see there)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TASK = "flat_terrain_backlash"
N_EVENTS = 200
# playback's feet, port (float32 kinematics on the device) against JAX
# (float64 on the host); measured 1.8e-8 m on the stand-in
FEET_ATOL_M = 1e-5


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    with standin_assets(str(tmp_path_factory.mktemp("standin"))) as r:
        yield r


@pytest.fixture(scope="module")
def joystick_onnx(root, tmp_path_factory):
    return _onnx(tmp_path_factory.mktemp("onnx") / "joystick.onnx", 101,
                 {"phase_frequency_vx_ref": "0.094", "phase_frequency_max": "1.4"})


# --- fakes (tests/test_viewer.py's) ---------------------------------------


class _Host:
    def __init__(self):
        self.commands = [0.0] * 7
        self.phase_frequency_factor = 1.0
        self.sim_dt = 0.002
        self.decimation = 10
        self.model = object()
        self.data = object()
        self.saved_obs = []
        self.stepped = 0

    def control_step(self):
        self.saved_obs.append(np.zeros(3))
        return np.zeros(14)

    def step_control(self, targets):
        self.stepped += 1


class _FakeStick:
    def __init__(self, axes, name):
        self._axes = axes
        self._name = name

    def init(self):
        pass

    def get_name(self):
        return self._name

    def get_axis(self, i):
        return self._axes[i]


class _FakePygame:
    def __init__(self, sticks):
        self._sticks = sticks

        class _J:
            @staticmethod
            def init():
                pass

            @staticmethod
            def get_count():
                return len(sticks)

            @staticmethod
            def Joystick(i):
                return sticks[i]

        self.joystick = _J

        class _E:
            @staticmethod
            def pump():
                pass

        self.event = _E

    def init(self):
        pass


class _FakeViewer:
    def __init__(self, ticks):
        self._left = ticks
        self.synced = 0
        self.key_callback = None

    def is_running(self):
        self._left -= 1
        return self._left >= 0

    def sync(self):
        self.synced += 1

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


class _Recorder(RecordingVideo):
    """chip_smoke's recording video as MjVideoRenderer's stand-in in the
    entry points: made from a model path, it writes a pickle of its frames
    on save; every one made is kept in `made`."""

    made = []

    def __init__(self, model_path=None):
        super().__init__()
        self.saved = None
        _Recorder.made.append(self)

    def save(self, path):
        with open(path, "wb") as f:
            pickle.dump(self.frames, f)
        self.saved = path
        return path


class _PipeStdin:
    """A stdin over an os.pipe that reads one character per read(1), so an
    escape sequence stays in the pipe for select() until it is read."""

    def __init__(self):
        self.r, self.w = os.pipe()

    def fileno(self):
        return self.r

    def read(self, n):
        return os.read(self.r, n).decode()

    def send(self, s):
        os.write(self.w, s.encode())

    def close(self):
        os.close(self.r)
        os.close(self.w)


# --- tests/test_viewer.py's cases on the port's viewer ----------------------


def test_key_teleop_reference_semantics():
    host = _Host()
    cb = ViewerKeyTeleop(host)
    cb(265)  # arrow up -> vx max
    assert host.commands[0] == COMMANDS_RANGE_X[1]
    cb(263)  # arrow left -> vy max, AND vx resets to 0 (reference rebuilds)
    assert host.commands[1] == COMMANDS_RANGE_Y[1]
    assert host.commands[0] == 0.0
    cb(81)  # a -> wz max
    assert host.commands[2] == COMMANDS_RANGE_THETA[1]
    cb(80)  # p -> clock factor +0.1, commands reset
    assert abs(host.phase_frequency_factor - 1.1) < 1e-12
    assert host.commands[2] == 0.0
    cb(59)  # m -> clock factor back down
    assert abs(host.phase_frequency_factor - 1.0) < 1e-12
    # head mode: arrows drive head slots, locomotion zeroed
    cb(72)  # h toggles
    cb(265)
    assert host.commands[4] == NECK_PITCH_RANGE[1]
    assert host.commands[0] == 0.0
    cb(72)  # back to locomotion mode
    cb(264)
    assert host.commands[0] == COMMANDS_RANGE_X[0]


def test_pygame_joystick_mapping():
    # stick1 pushed forward (axis1 = -1) and right (axis0 = +0.5),
    # stick2 axis0 = -1 -> full positive turn
    sticks = [_FakeStick([0.5, -1.0], "s1"), _FakeStick([-1.0, 0.0], "s2")]
    cmd = [9.9, 9.9, 9.9]
    tele = PygameJoystickTeleop(cmd, pygame_module=_FakePygame(sticks))
    assert cmd[:3] == [0.0, 0.0, 0.0]  # init zeroes the command
    tele.poll()
    assert abs(cmd[0] - COMMANDS_RANGE_X[1]) < 1e-12          # forward = +vx max
    assert abs(cmd[1] - (-0.5 * COMMANDS_RANGE_Y[1])) < 1e-12  # right = -vy
    assert abs(cmd[2] - COMMANDS_RANGE_THETA[1]) < 1e-12      # stick2 -> +wz
    # reverse: axis1 = +1 uses the asymmetric negative range
    sticks[0]._axes = [0.0, 1.0]
    tele.poll()
    assert abs(cmd[0] - (-abs(COMMANDS_RANGE_X[0]))) < 1e-12


def test_pygame_no_joystick_is_noop():
    cmd = [0.1, 0.2, 0.3]
    tele = PygameJoystickTeleop(cmd, pygame_module=_FakePygame([]))
    tele.poll()
    assert cmd == [0.1, 0.2, 0.3]


def test_run_viewer_loop(tmp_path):
    host = _Host()
    fake = _FakeViewer(ticks=5)

    def launch(model, data, key_callback=None):
        fake.key_callback = key_callback
        return fake

    out = str(tmp_path / "obs.pkl")
    obs = run_viewer(host, save_path=out, launch=launch)
    assert host.stepped == 5 and fake.synced == 5
    assert len(obs) == 5
    with open(out, "rb") as f:
        assert len(pickle.load(f)) == 5
    # the installed key callback drives the host's commands
    fake.key_callback(265)
    assert host.commands[0] == COMMANDS_RANGE_X[1]


def test_live_gait_view_headless(root):
    pytest.importorskip("mujoco")
    fake = _FakeViewer(ticks=4)

    def launch(model, data, key_callback=None):
        return fake

    sticks = [_FakeStick([0.0, -1.0], "s1")]
    ticks = ref_motion_viewer.live_view(command=(0.05, 0.0, 0.0), joystick=True, launch=launch,
                                        pygame_module=_FakePygame(sticks), max_seconds=10.0)
    assert ticks == 4 and fake.synced == 4


# --- teleops and the timer, port against JAX on seeded events --------------


def test_key_teleop_matches_jax():
    """200 seeded GLFW keycodes (the mapped keys and two unmapped ones):
    commands and phase_frequency_factor identical after every event."""
    codes = [265, 264, 263, 262, 81, 69, 72, 80, 59, 32, 48]
    rng = np.random.RandomState(0)
    hosts = [_Host(), _Host()]
    cbs = [ViewerKeyTeleop(hosts[0]), jax_viewer.ViewerKeyTeleop(hosts[1])]
    for code in rng.choice(codes, N_EVENTS):
        for cb in cbs:
            cb(int(code))
        assert hosts[0].commands == hosts[1].commands
        assert hosts[0].phase_frequency_factor == hosts[1].phase_frequency_factor
        assert cbs[0].head_control_mode == cbs[1].head_control_mode


@pytest.mark.parametrize("n_sticks", [1, 2])
def test_pygame_teleop_matches_jax(n_sticks):
    """200 polls of seeded axis values on one or two fake sticks: the
    commands identical after every poll."""
    rng = np.random.RandomState(n_sticks)
    sides = []
    for cls in (PygameJoystickTeleop, jax_viewer.PygameJoystickTeleop):
        sticks = [_FakeStick([0.0, 0.0], f"s{i}") for i in range(n_sticks)]
        cmd = [0.3] * 7
        sides.append((sticks, cmd, cls(cmd, pygame_module=_FakePygame(sticks))))
    for axes in rng.uniform(-1, 1, (N_EVENTS, n_sticks, 2)):
        for sticks, cmd, tele in sides:
            for s, a in zip(sticks, axes):
                s._axes = [float(a[0]), float(a[1])]
            tele.poll()
        assert sides[0][1] == sides[1][1]


def test_stdin_teleop_matches_jax(monkeypatch):
    """200 seeded keys, arrows as escape sequences, through a pipe for
    stdin: commands, phase_frequency_factor and head mode identical after
    every key."""
    keys = ["\x1b[A", "\x1b[B", "\x1b[C", "\x1b[D", "a", "e", "h", "p", "m", "0", "x"]
    rng = np.random.RandomState(1)
    pipes = [_PipeStdin(), _PipeStdin()]
    try:
        tels = []
        for cls, pipe in zip((teleop.StdinTeleop, jax_teleop.StdinTeleop), pipes):
            monkeypatch.setattr(sys, "stdin", pipe)
            tels.append(cls())
        hosts = [types.SimpleNamespace(commands=[0.0] * 7, phase_frequency_factor=1.0)
                 for _ in range(2)]
        moved = 0
        for k in rng.choice(len(keys), N_EVENTS):
            for tel, pipe, host in zip(tels, pipes, hosts):
                pipe.send(keys[k])
                monkeypatch.setattr(sys, "stdin", pipe)
                tel.poll(host)
            assert hosts[0].commands == hosts[1].commands
            assert hosts[0].phase_frequency_factor == hosts[1].phase_frequency_factor
            assert tels[0].head_mode == tels[1].head_mode
            moved += keys[k].startswith("\x1b") and any(hosts[0].commands)
        assert moved > 0  # the arrows reached the commands
        for tel in tels:
            tel.close()
    finally:
        for pipe in pipes:
            pipe.close()


def test_step_timer_matches_jax(monkeypatch):
    """StepTimer under one patched time.monotonic sequence: identical
    smoothed rates after every tick."""
    rng = np.random.RandomState(2)
    clock = np.cumsum(rng.uniform(1e-4, 0.05, N_EVENTS))
    units = rng.uniform(1, 1000, N_EVENTS)
    rates = []
    for cls in (profiling.StepTimer, jax_profiling.StepTimer):
        it = iter(clock.tolist())
        monkeypatch.setattr(time, "monotonic", lambda: next(it))
        timer = cls(smoothing=0.8)
        rates.append([timer.tick(float(u)) for u in units] + [timer.rate])
    assert rates[0][0] is None and rates[0][-1] is not None
    assert rates[0] == rates[1]


# --- profiling.trace -------------------------------------------------------


def test_trace_on_the_cpu_writes_the_annotations(tmp_path):
    x = torch.randn(64, 64, generator=torch.Generator().manual_seed(0))
    with profiling.trace(str(tmp_path), device="cpu") as prof:
        with profiling.annotate("duck_matmul"):
            y = x @ x
    assert isinstance(prof, torch.profiler.profile)
    assert torch.isfinite(y).all()
    assert any(e.key == "duck_matmul" for e in prof.key_averages())
    with open(tmp_path / "trace.json") as f:
        text = f.read()
    assert '"duck_matmul"' in text and "aten::mm" in text


def test_trace_on_a_missing_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA trace is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with profiling.trace(str(tmp_path / "cuda")):
            pass
    assert not (tmp_path / "cuda").exists()


# --- plots and video -------------------------------------------------------


def test_plot_saved_obs_matches_jax(tmp_path):
    """The channel names are JAX's; plot() writes a PNG of two seeded
    traces, as JAX's does."""
    assert plot_saved_obs.channel_names() == jax_plot.channel_names()
    assert plot_saved_obs.OBS_LAYOUT == jax_plot.OBS_LAYOUT
    assert len(plot_saved_obs.channel_names()) == 101
    rng = np.random.RandomState(3)
    paths = []
    for name in ("a", "b"):
        paths.append(str(tmp_path / f"{name}.pkl"))
        with open(paths[-1], "wb") as f:
            pickle.dump(list(rng.randn(12, 24)), f)  # 24 channels: 3 rows of plots
    for mod, png in ((plot_saved_obs, tmp_path / "port.png"), (jax_plot, tmp_path / "jax.png")):
        mod.plot(paths, out=str(png))
        with open(png, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_video_save_matches_jax(tmp_path):
    """MjVideoRenderer.save on the same injected seeded frames: the same GIF
    bytes as JAX's; no frames, or another extension, raise as JAX's."""
    pytest.importorskip("PIL")
    frames = list(np.random.RandomState(4).randint(0, 256, (6, 36, 48, 3), dtype=np.uint8))
    out = []
    for cls, name in ((render.MjVideoRenderer, "port.gif"), (jax_render.MjVideoRenderer, "jax.gif")):
        r = object.__new__(cls)  # the frames only: no model, no GL context
        r.frames, r.fps = [], 25.0
        with pytest.raises(ValueError, match="no frames"):
            r.save(str(tmp_path / name))
        r.frames = list(frames)
        with pytest.raises(ValueError, match="unsupported extension"):
            r.save(str(tmp_path / "x.avi"))
        assert r.save(str(tmp_path / name)) == str(tmp_path / name)
        out.append((tmp_path / name).read_bytes())
    assert out[0][:6] == b"GIF89a" and out[0] == out[1]


def test_playback_matches_jax(root, tmp_path):
    """The gait playback's feet on the CPU against JAX's float64 host
    kinematics, within FEET_ATOL_M; main() with --device cpu writes the
    PNG."""
    for command, periods in (((0.1, 0.0, 0.0), 1), ((-0.1, 0.15, 0.5), 2)):
        port = ref_motion_viewer.playback(command, periods, out=None, device="cpu")
        ref = jax_rmv.playback(command, periods, out=None)
        assert port.shape == ref.shape and port.shape[1] == 6 and port.dtype == np.float64
        np.testing.assert_allclose(port, ref, rtol=0, atol=FEET_ATOL_M)
    png = tmp_path / "gait.png"
    ref_motion_viewer.main(["--device", "cpu", "--periods", "1", "--out", str(png)])
    assert png.read_bytes()[:4] == b"\x89PNG"


def test_playback_runs_on_the_card_by_default(root):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ref_motion_viewer.playback(periods=1, out=None)


# --- PolicyLoopMixin.run hooks ---------------------------------------------


class _UprightHost(_FakeHost):
    """test_torch_deploy's seeded fake engine with its upvector turned up,
    so that run() does not stop at a fall."""

    def get_gravity(self, data):
        up = np.array(self._sensors["upvector"])
        up[2] = abs(up[2]) + 0.1
        return up


class _PortLoop(PolicyLoopMixin, _UprightHost):
    pass


class _JaxLoop(JaxPolicyLoopMixin, _UprightHost):
    pass


def test_run_hooks_match_jax(root, joystick_onnx):
    """run() with a scripted teleop and a recording video, port and JAX
    loops on the same seeded fake engine: every obs, target and frame
    identical; the obs carry the new command from the teleop's tick on."""
    sides = []
    for cls in (_PortLoop, _JaxLoop):
        loop = cls(seed=5)
        loop.init_policy_loop(constants.reference_motion_path(), joystick_onnx, False)
        tele, video = ScriptedTeleop(at=3, vx=0.1), _Recorder()
        loop.run(seconds=0.2, save_path=None, teleop=tele, video=video)
        sides.append((loop, tele, video))
    (port, tele, video), (ref, ref_tele, ref_video) = sides
    assert tele.polls == ref_tele.polls == len(port.saved_obs) == 10
    for a, b in zip(port.saved_obs, ref.saved_obs):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.stack(port.applied), np.stack(ref.applied))
    assert len(video.frames) == len(ref_video.frames) == 5
    for a, b in zip(video.frames, ref_video.frames):
        np.testing.assert_array_equal(a, b)
    assert [o[6] for o in port.saved_obs] == [0.0] * 3 + [0.1] * 7


def test_run_hooks_on_the_port_engine(root, joystick_onnx, monkeypatch):
    """SimInfer(device="cpu"), 4 ticks with both hooks: one engine call
    per tick plus the init, each frame bit-identical to that tick's host
    qpos, and the obs carry the teleop's command from its tick."""
    from open_duck_playground_tpu_torch.ops.cuda_step import FusedPhysics

    calls = []
    call = FusedPhysics.__call__

    def counted(fp, *a, **k):
        calls.append(a[0].shape[0])
        return call(fp, *a, **k)

    monkeypatch.setattr(FusedPhysics, "__call__", counted)
    infer = sim_infer.SimInfer(constants.task_to_xml(TASK), constants.reference_motion_path(),
                               joystick_onnx, device="cpu")
    ticks = []
    step = infer.step_control

    def stepped(targets):
        step(targets)
        ticks.append(infer.qpos.copy())

    infer.step_control = stepped
    tele, video = ScriptedTeleop(at=2, vx=0.1), _Recorder()
    infer.run(seconds=0.08, save_path=None, teleop=tele, video=video)
    n = len(infer.saved_obs)
    assert n == len(ticks) == 4 and tele.polls == 4
    assert calls == [1] * (1 + n) and infer.physics.launches == 0  # the CPU launches none
    assert len(video.frames) == math.ceil(n / 2)
    for k, frame in enumerate(video.frames):
        assert frame.dtype == np.float32
        np.testing.assert_array_equal(frame, ticks[2 * k])
    assert [o[6] for o in infer.saved_obs] == [0.0, 0.0, 0.1, 0.1]


# --- the entry points' flags -----------------------------------------------


def test_sim_infer_takes_interactive_and_render(root, joystick_onnx, monkeypatch, tmp_path):
    """sim_infer.main with --interactive (an arrow up queued on stdin) and
    --render (a recording video in place of MuJoCo's): one tick, one frame,
    the obs carry the key's command, the video is saved."""
    monkeypatch.setattr(render, "MjVideoRenderer", _Recorder)
    pipe = _PipeStdin()
    try:
        monkeypatch.setattr(sys, "stdin", pipe)
        pipe.send("\x1b[A")
        _Recorder.made.clear()
        obs_path, video_path = tmp_path / "obs.pkl", tmp_path / "roll.gif"
        sim_infer.main(["-o", joystick_onnx, "--task", TASK, "--device", "cpu", "--seconds",
                        "0.02", "--interactive", "--render", str(video_path),
                        "--save_obs", str(obs_path)])
    finally:
        pipe.close()
    with open(obs_path, "rb") as f:
        obs = pickle.load(f)
    assert len(obs) == 1 and obs[0][6] == 0.15  # --command's vx 0.1 + 0.05, at its range
    (video,) = _Recorder.made
    assert video.saved == str(video_path) and len(video.frames) == 1


@pytest.mark.parametrize("entry", ["sim_infer", "mujoco_infer"])
def test_render_without_mujoco_fails_before_the_rollout(root, joystick_onnx, monkeypatch,
                                                        tmp_path, entry):
    """--render where mujoco cannot be imported raises ImportError before
    any tick (and, for sim_infer, before the engine is built)."""
    import importlib

    from open_duck_playground_tpu_torch.deploy.sim_infer_base import SimInferBase

    mod = importlib.import_module(f"open_duck_playground_tpu_torch.deploy.{entry}")
    monkeypatch.setitem(sys.modules, "mujoco", None)

    def no_engine(*a, **k):
        raise AssertionError("the engine was built or stepped")

    monkeypatch.setattr(SimInferBase, "__init__", no_engine)
    monkeypatch.setattr(PolicyLoopMixin, "run", no_engine)
    with pytest.raises(ImportError):
        mod.main(["-o", joystick_onnx, "--task", TASK, "--seconds", "0.02",
                  "--render", str(tmp_path / "roll.gif")]
                 + (["--device", "cpu"] if entry == "sim_infer" else []))


def test_mujoco_infer_takes_its_flags(root, joystick_onnx, monkeypatch, tmp_path):
    """mujoco_infer.main with --viewer --joystick (a fake passive viewer and
    fake pygame sticks: 3 ticks, the stick's vx in the obs), then with
    --interactive --render (a key on stdin, a recording video)."""
    mujoco = pytest.importorskip("mujoco")
    import mujoco.viewer

    from open_duck_playground_tpu_torch.deploy import mujoco_infer

    fake = _FakeViewer(ticks=3)
    monkeypatch.setattr(mujoco.viewer, "launch_passive",
                        lambda model, data, key_callback=None: fake)
    monkeypatch.setitem(sys.modules, "pygame", _FakePygame([_FakeStick([0.0, -1.0], "s1")]))
    obs_path = tmp_path / "viewer.pkl"
    mujoco_infer.main(["-o", joystick_onnx, "--task", TASK, "--viewer", "--joystick",
                       "--save_obs", str(obs_path)])
    with open(obs_path, "rb") as f:
        obs = pickle.load(f)
    assert fake.synced == 3 and len(obs) == 3
    assert [o[6] for o in obs] == [COMMANDS_RANGE_X[1]] * 3

    monkeypatch.setattr(render, "MjVideoRenderer", _Recorder)
    pipe = _PipeStdin()
    try:
        monkeypatch.setattr(sys, "stdin", pipe)
        pipe.send("a")
        _Recorder.made.clear()
        obs_path, video_path = tmp_path / "obs.pkl", tmp_path / "roll.gif"
        mujoco_infer.main(["-o", joystick_onnx, "--task", TASK, "--seconds", "0.1",
                           "--interactive", "--render", str(video_path),
                           "--save_obs", str(obs_path)])
    finally:
        pipe.close()
    with open(obs_path, "rb") as f:
        obs = pickle.load(f)
    assert len(obs) == 5 and obs[0][8] == 0.1  # 'a': wz + 0.1
    (video,) = _Recorder.made
    assert video.saved == str(video_path) and len(video.frames) == 3


def test_tools_import_no_jax_and_no_optional_package(root):
    """Importing the new modules (and a CPU playback with no plot) loads
    none of jax, the JAX package, mujoco, matplotlib, PIL, OpenCV or
    pygame."""
    code = (
        "import sys\n"
        "from open_duck_playground_tpu_torch.utils import profiling\n"
        "from open_duck_playground_tpu_torch.deploy import (\n"
        "    plot_saved_obs, ref_motion_viewer, render, teleop, viewer, sim_infer,\n"
        "    mujoco_infer)\n"
        "feet = ref_motion_viewer.playback(periods=1, out=None, device='cpu')\n"
        "assert feet.shape[1] == 6\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'open_duck_playground_tpu',\n"
        "                                    'mujoco', 'matplotlib', 'PIL', 'cv2', 'pygame'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = dict(os.environ, OPEN_DUCK_ASSETS=root)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "clean" in proc.stdout, proc.stderr[-2000:]
