"""Whole runs of each loop at a size the CPU holds (4 envs, 2 unroll steps,
a 32-wide network, 2 physics substeps; 2 eval envs, 3-step episodes): the
last line's shape, the reference against the port's CPU path, the control,
and each fault a cell can have planted in the timed path. The harness's
look for a chip is skipped (``run.run_cell`` on device "cpu"). A run on the
card is marked ``cuda``."""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys

import pytest
import torch

from duckbench import faults, manifest, run

FLAT_TRAIN = "joystick_flat_backlash.train"
ROUGH_TRAIN = "joystick_rough_backlash.train"
FLAT_EVAL = "joystick_flat_backlash.eval"
TOP_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def tiny(cfg: dict) -> dict:
    cfg = copy.deepcopy(cfg)
    cfg["ppo"].update(num_envs=4, batch_size=2, num_minibatches=2, num_updates_per_batch=1,
                      unroll_length=2, num_eval_envs=2, episode_length=3)
    cfg["network"].update(policy_hidden_layer_sizes=[32], value_hidden_layer_sizes=[32])
    cfg["env_overrides"] = {"sim_dt": 0.01}
    cfg["n_substeps"] = 2
    return cfg


def run_tiny(cell_name: str, trace: bool = False, fault=None, control: bool = False,
             seed: int = 4_000_000_123):
    bench = manifest.load()
    cell = manifest.workload(bench, cell_name)
    mix = manifest.traffic(cell["traffic"])
    if mix["loop"] == "train":
        mix = dict(mix, follow=2)
    return run.run_cell(bench, cell, seed, 0.2, trace, "cpu",
                        cfg=tiny(manifest.config(bench, cell["config"])), traffic_mix=mix,
                        fault=fault, control=control)


@pytest.fixture(scope="module")
def train_traced():
    return run_tiny(FLAT_TRAIN, trace=True, control=True)


@pytest.fixture(scope="module")
def eval_untraced():
    return run_tiny(FLAT_EVAL, trace=False, control=True)


def _shape(res: dict, bench: dict, cell: str, kind: str) -> None:
    keys = list(res)
    assert keys[:5] == TOP_KEYS and keys[-1] == "checks"
    assert isinstance(res["correct"], bool)
    assert res["attempted"] >= 1 and res["failed"] == 0
    want = {m["name"]: m["unit"] for m in manifest.cell_metrics(bench, cell, kind)}
    for name, m in res["metrics"].items():
        assert set(m) == {"value", "unit"} and m["unit"] == want[name]
        assert isinstance(m["value"], float)
    d = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(d)
    for name, c in res["checks"].items():
        assert set(c) == {"value", "limit"}
    json.dumps(res)


def test_train_run_traced_line_and_reference(train_traced):
    bench = manifest.load()
    _shape(train_traced, bench, FLAT_TRAIN, "per_layer")
    assert train_traced["correct"] is True
    assert all(c["value"] == 0.0 for c in train_traced["checks"].values())
    m = train_traced["metrics"]
    assert {"rollout_ms", "sgd_ms", "step_mfu.train"} <= set(m)
    # the CPU has no fused kernel to read a roofline from, and no device
    # operation to open the traced window
    assert "physics_step_roofline.train" not in m
    d = train_traced["device"]
    assert d["window_s"] == 0 and d["busy_s"] == 0
    b = train_traced["breakdown"]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_train_control_is_not_correct(train_traced):
    """The reference with TF32 products in the program's place fails."""
    limits = manifest.limits(FLAT_TRAIN)
    ctl = train_traced["control"]
    assert set(ctl) == set(limits)
    assert any(v > limits[k] for k, v in ctl.items())


def test_eval_run_line_reference_and_control(eval_untraced):
    bench = manifest.load()
    _shape(eval_untraced, bench, FLAT_EVAL, "end_to_end")
    assert eval_untraced["correct"] is True
    assert set(eval_untraced["metrics"]) == {"eval_env_sps", "setup_s"}
    limits = manifest.limits(FLAT_EVAL)
    assert any(v > limits[k] for k, v in eval_untraced["control"].items())


def test_rough_train_run_is_correct():
    res = run_tiny(ROUGH_TRAIN)
    assert res["correct"] is True
    assert set(res["metrics"]) == {"train_env_sps.hfield", "setup_s"}


@pytest.mark.parametrize("cell, fault", [
    (FLAT_TRAIN, "sgd_unchanged"), (FLAT_TRAIN, "half_batch"),
    (FLAT_TRAIN, "answer_altered"), (FLAT_TRAIN, "state_unchanged"),
    (FLAT_EVAL, "answer_altered"), (FLAT_EVAL, "state_unchanged"),
])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    assert fault in faults.FAULTS
    res = run_tiny(cell, fault=fault, seed=987_654_321_012)
    assert res["correct"] is False, res["checks"]


def test_reference_env_matches_the_port_cpu_path():
    """The frozen reference env and the port's env on the CPU: the same
    reset and step, bit for bit, with domain randomization."""
    from open_duck_playground_tpu_torch.envs import randomize as port_rand
    from open_duck_playground_tpu_torch.envs.joystick import Joystick as PortJoystick
    from open_duck_playground_tpu_torch.envs.wrapper import TrainEnv as PortTrainEnv

    from duckbench.check import leaves
    from duckbench.ref.envs import randomize as ref_rand
    from duckbench.ref.envs.joystick import Joystick as RefJoystick
    from duckbench.ref.envs.wrapper import TrainEnv as RefTrainEnv

    run.prepare()
    states = []
    for J, TE, R in ((PortJoystick, PortTrainEnv, port_rand), (RefJoystick, RefTrainEnv, ref_rand)):
        env = J("flat_terrain_backlash", device="cpu", config_overrides={"sim_dt": 0.01})
        env.generator.manual_seed(7)
        te = TE(env, num_envs=3, episode_length=1000, randomization_fn=R.domain_randomize,
                randomization_generator=torch.Generator().manual_seed(5))
        st = te.reset(torch.Generator().manual_seed(1))
        act = torch.tanh(torch.randn(3, 14, generator=torch.Generator().manual_seed(3)))
        states.append((leaves(st), leaves(te.step(st, act))))
    for a, b in zip(*states):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_main_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, "-m", "duckbench.run", "--workload", FLAT_TRAIN,
                          "--seed", "3", "--seconds", "1", "--trace", "0"],
                         cwd=manifest.ROOT, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernel has no CPU mode")
    bench = manifest.load()
    res = run.run_cell(bench, manifest.workload(bench, FLAT_EVAL), 11, 1.0, False, "cuda")
    assert res["correct"] is True, res["checks"]


def test_the_rounding_reading_changes_rounding_alone():
    """precision.reordered: a Linear sums in another order (within float32
    rounding of the plain product, not equal to it), and the plain physics
    step's velocities come out one unit in the last place higher."""
    from duckbench import precision
    from duckbench.ref.ops.twin import TwinPhysics

    g = torch.Generator().manual_seed(5)
    layer = torch.nn.Linear(512, 256)
    x = torch.randn(64, 512, generator=g)
    plain = layer(x)
    with precision.reordered(layer):
        other = layer(x)
    assert not torch.equal(plain, other)
    torch.testing.assert_close(other, plain, rtol=1e-5, atol=1e-5)
    assert torch.equal(layer(x), plain)  # restored after the block
    step = TwinPhysics.__call__
    TwinPhysics.__call__ = lambda self, *a, **k: {"qvel": torch.tensor([0.5, -2.0])}
    try:
        with precision.reordered(layer):
            v = TwinPhysics.__call__(None)["qvel"]
        assert torch.equal(v, torch.nextafter(torch.tensor([0.5, -2.0]),
                                              torch.tensor([float("inf")] * 2)))
    finally:
        TwinPhysics.__call__ = step
