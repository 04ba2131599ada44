"""The shipping recipes the port trains on the card against the JAX
package's own, and `scripts/torch_recipe.py`'s summary of a run.

- For each recipe of `scripts/torch_recipe.py` (joystick at 300M steps and
  16 evals, standing at 100M), the JAX runner and the port's runner are
  built from the same argv on the stand-in duck: the JAX runner's call of
  `ppo.train` (recorded, nothing trains) against the port's
  `train_kwargs()`: every PPO hyper-parameter, the network widths and the
  checkpoint options equal (the callbacks, `device`, `shard` and
  `host_loop` left out), the train and eval envs' configs equal as plain
  dicts, a randomizer set on both or on neither.
- `summarize` on a synthetic run directory in the runner's format: the
  curve, the epochs, the sps and peak-memory checks, the launches against
  the count the code gives (a fresh and a resumed process), the ONNX at
  every eval, the wall time split and the gate's bar.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest

from tests.torch_helpers import standin_assets

pytest_plugins = ["tests.torch_lock"]  # never beside tests/test_resume.py (see there)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEFT_OUT = {"progress_fn", "policy_params_fn", "device", "shard", "host_loop",
            "environment", "eval_env", "randomization_fn"}


def _recipe_module():
    spec = importlib.util.spec_from_file_location(
        "torch_recipe", os.path.join(ROOT, "scripts", "torch_recipe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _plain(x):
    """A config as plain Python: dicts, lists for sequences, numbers."""
    if hasattr(x, "to_dict"):
        x = x.to_dict()
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple, np.ndarray)):
        return [_plain(v) for v in x]
    if isinstance(x, np.generic):
        return x.item()
    return x


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    with standin_assets(str(tmp_path_factory.mktemp("standin"))) as r:
        yield r


@pytest.mark.parametrize("recipe", ["joystick", "standing"])
def test_recipe_matches_jax_runner(recipe, root, tmp_path, monkeypatch):
    from open_duck_playground_tpu.train import runner as jax_runner
    from open_duck_playground_tpu_torch.train import runner as rn

    tr = _recipe_module()
    argv = [*tr.RECIPES[recipe], "--auto_resume", "--output_dir", str(tmp_path)]
    recorded = {}

    def fake_train(**kwargs):
        recorded.update(kwargs)
        return None, None, None

    monkeypatch.setattr(jax_runner.ppo, "train", fake_train)
    monkeypatch.setattr(sys, "argv", ["runner", *argv])
    jax_runner.main()

    port = rn.OpenDuckMiniV2Runner(rn.build_parser().parse_args([*argv, "--device", "cpu"]))
    kw = port.train_kwargs()

    want = {k: v for k, v in recorded.items() if k not in LEFT_OUT}
    got = {k: v for k, v in kw.items() if k not in LEFT_OUT}
    assert _plain(got) == _plain(want)
    assert (want["num_timesteps"], want["num_envs"], want["num_evals"]) == {
        "joystick": (300_000_000, 8192, 16), "standing": (100_000_000, 8192, 15)}[recipe]
    assert want["auto_resume"] is True
    for name in ("environment", "eval_env"):
        jax_env, port_env = recorded[name], getattr(port, "eval_env" if name == "eval_env" else "env")
        assert type(port_env).__name__ == type(jax_env).__name__
        assert _plain(port_env._config) == _plain(jax_env._config)
    assert (recorded["randomization_fn"] is None) == (kw["randomization_fn"] is None)
    assert kw["randomization_fn"] is not None


def _write_run(d, steps, sps, peaks, launches, session, T=20, ep_len=1000, spe=3, t0=0.0):
    """Append a run's lines to `d` as the runner and the script write them."""
    with open(d / "metrics.jsonl", "a") as f, open(d / "readings.jsonl", "a") as g:
        for i, step in enumerate(steps):
            m = {"step": step, "eval/episode_reward": 10.0 + step, "eval/episode_reward_std": 1.0,
                 "eval/avg_episode_length": 900.0, "eval/episode_tracking_lin_vel": 0.5}
            if sps[i] is not None:
                m.update({"training/sps": sps[i], "training/total_loss": 1.0,
                          "training/walltime": 1.0})
            f.write(json.dumps(m) + "\n")
            g.write(json.dumps({"step": step, "session": session, "wall_s": t0 + 10.0 * (i + 1),
                                "peak_allocated_bytes": peaks[i], "reserved_bytes": 5000,
                                "launches": launches[i], "unroll_length": T,
                                "episode_length": ep_len, "steps_per_epoch": spe}) + "\n")
            (d / f"2026_01_01_000000_{step}.onnx").write_bytes(b"")


def test_summary_of_a_run_directory(tmp_path):
    tr = _recipe_module()
    d = tmp_path
    # a fresh process: evals at 0, 100, 200; killed after the eval at 300,
    # before its full state was saved
    fresh_launches = [{"train_env": 2, "eval_env": 1002}, {}, {},
                      {"train_env": 2 + 20 * (1 + 3 * 3), "eval_env": 1 + 4 * 1001}]
    _write_run(d, [0, 100, 200, 300], [None, 50.0, 100.0, 98.0], [7, 900, 1000, 1005],
               fresh_launches, session=1.0)
    # resumed from epoch 2's full state: epoch 3 again, then epoch 4
    _write_run(d, [300, 400], [99.0, 95.0], [1000, 1008],
               [{}, {"train_env": 2 + 20 * (1 + 2 * 3), "eval_env": 1 + 2 * 1001}], session=2.0)
    with open(d / "train.log", "w") as f:
        f.write('[ppo] rollout captured: {"warmup_s": 0.5, "capture_s": 0.25, '
                '"instantiate_s": 0.25, "pool_bytes": 1}\n')
        f.write("[ppo] eval rollout done in 2.2s\n[ppo] eval rollout done in 2.1s\n")
        f.write("[ppo] full-state save epoch 0: host copy 0.30s write 0.20s\n")
        f.write("[recipe] checkpoint and ONNX at step 0: 0.125 s\n")
    gate = {"rc": 0, "lines": [{"engine": "own", "fell": False},
                               {"pass": True, "min_track_frac": 0.7}], "seconds": 3.0}

    s = tr.summarize(str(d), num_timesteps=400, gate=gate)
    assert [c["step"] for c in s["curve"]] == [0, 100, 200, 300, 400]
    assert s["curve"][3]["eval/episode_reward"] == 310.0
    assert [e["training/sps"] for e in s["epochs"]] == [50.0, 100.0, 99.0, 95.0]
    assert s["epochs"][0]["epoch_s"] == pytest.approx(2.0)
    assert s["epochs"][2]["peak_allocated_bytes"] == 1000  # the resumed line wins
    assert s["sps_min_over_median"] == pytest.approx(95.0 / 99.0)
    assert s["peak_growth"] == pytest.approx(1008 / 1000 - 1.0)
    assert s["onnx_steps"] == [0, 100, 200, 300, 400]
    assert [(x["first_step"], x["last_step"]) for x in s["launches"]] == [(0, 300), (300, 400)]
    assert all(x["launches"] == x["want"] for x in s["launches"])
    assert s["wall"]["evals_s"] == pytest.approx(4.3)
    assert s["wall"]["full_state_saves_s"] == pytest.approx(0.5)
    assert s["wall"]["exports_s"] == pytest.approx(0.125)
    assert s["wall"]["captures"] == {"rollout": [1.0]}
    assert s["wall"]["total_s"] == pytest.approx(40.0 + 20.0)
    assert s["checks"] == {"steps": True, "finite": True, "onnx_at_every_eval": True,
                           "sps": True, "peak_memory": True, "launches": True, "gate": True}
    assert s["ok"]

    # each check fails on its own
    assert not tr.summarize(str(d), num_timesteps=500, gate=gate)["checks"]["steps"]
    assert not tr.summarize(str(d), num_timesteps=400)["checks"]["gate"]
    _write_run(d, [500], [80.0], [1100], [{"train_env": 0, "eval_env": 0}], session=3.0)
    bad = tr.summarize(str(d), num_timesteps=500, gate=gate)["checks"]
    assert bad == {"steps": True, "finite": True, "onnx_at_every_eval": True, "sps": False,
                   "peak_memory": False, "launches": False, "gate": True}
    with open(d / "metrics.jsonl", "a") as f:
        f.write(json.dumps({"step": 600, "eval/episode_reward": float("nan"),
                            "eval/episode_reward_std": 0.0, "eval/avg_episode_length": 1.0,
                            "training/sps": 99.0}) + "\n")
    bad = tr.summarize(str(d), num_timesteps=500, gate=gate)["checks"]
    assert not bad["finite"] and not bad["onnx_at_every_eval"]
