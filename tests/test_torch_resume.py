"""The port's checkpoints: the counterparts of tests/test_resume.py and
tests/test_checkpoint.py, on the batched torch ToyEnv (tests/torch_helpers.py).

Its steps draw noise from the env's own generator, so a resume that lost
that stream, the trainer's generators or any tensor of the env batch would
give another curve. Kill-and-resume must give the same eval curve and the
same params, exactly; so must a run with profile_breakdown=True.
"""

import os

import numpy as np
import torch

from open_duck_playground_tpu_torch import interop
from open_duck_playground_tpu_torch.train import checkpoint as ckpt
from open_duck_playground_tpu_torch.train import networks as nets
from open_duck_playground_tpu_torch.train import ppo
from tests.torch_helpers import TorchToyEnv

pytest_plugins = ["tests.torch_lock"]  # never beside tests/test_resume.py (see there)


def _train(tmpdir=None, stop_after=None, auto_resume=False, num_evals=5, save_every=1,
           profile_breakdown=False):
    evals = []

    def progress(step, metrics):
        if "eval/episode_reward" in metrics:
            evals.append((step, metrics["eval/episode_reward"]))

    _, params, _ = ppo.train(
        TorchToyEnv(noise=0.01), eval_env=TorchToyEnv(noise=0.01),
        num_timesteps=2048, episode_length=16, num_envs=8, num_eval_envs=4,
        unroll_length=4, num_minibatches=2, batch_size=4,
        num_updates_per_batch=1, num_evals=num_evals, seed=7,
        network_factory={
            "policy_hidden_layer_sizes": (16,),
            "value_hidden_layer_sizes": (16,),
            "policy_obs_key": "state",
            "value_obs_key": "privileged_state",
        },
        progress_fn=progress,
        save_full_state_dir=tmpdir,
        auto_resume=auto_resume,
        stop_after_epochs=stop_after,
        save_full_state_every=save_every,
        profile_breakdown=profile_breakdown,
    )
    return evals, params


def _assert_same_params(a, b):
    na, nb = interop.normalizer_to_numpy(a[0]), interop.normalizer_to_numpy(b[0])
    for f in ("mean", "summed_variance", "std"):
        for k in na[f]:
            np.testing.assert_array_equal(na[f][k], nb[f][k])
    np.testing.assert_array_equal(na["count"], nb["count"])
    for p, q in zip(a[1].parameters(), b[1].parameters()):
        assert torch.equal(p, q)


def test_kill_and_resume_exactly_reproduces_curve(tmp_path):
    d = str(tmp_path / "run")
    # A: uninterrupted
    evals_a, params_a = _train()
    assert len(evals_a) == 5  # eval at 0 + 4 epochs
    # B: same recipe, "killed" after 2 epochs (full state on disk)
    evals_b, _ = _train(tmpdir=d, stop_after=2)
    assert len(evals_b) == 3
    assert ckpt.latest_full(d) is not None
    # C: auto-resume completes the recipe
    evals_c, params_c = _train(tmpdir=d, auto_resume=True)
    assert len(evals_c) == 2  # epochs 3 and 4 only

    merged = evals_b + evals_c
    assert [s for s, _ in merged] == [s for s, _ in evals_a]
    np.testing.assert_array_equal(np.asarray([r for _, r in merged], np.float64),
                                  np.asarray([r for _, r in evals_a], np.float64))
    _assert_same_params(params_a, params_c)


def test_profile_breakdown_leaves_training_untouched(tmp_path):
    """The breakdown times the real rollout, SGD step, training step, eval
    and save on throwaway draws and copies: the same seed gives the same
    curve and bit-identical params with and without it. Its timed save
    leaves nothing behind: with saves every 2 epochs, epoch 1's is the only
    file (a full_00000.npz would make auto_resume skip epoch 0)."""
    evals_a, params_a = _train(num_evals=3)
    d = tmp_path / "bd"
    evals_b, params_b = _train(tmpdir=str(d), num_evals=3, save_every=2, profile_breakdown=True)
    assert evals_a == evals_b
    assert sorted(os.listdir(d)) == ["full_00001.npz"]
    _assert_same_params(params_a, params_b)
    bd = ppo.LAST_PROFILE_BREAKDOWN
    for k in ("rollout_s", "rollout_env_sps", "sgd_s", "training_step_s", "e2e_env_sps",
              "eval_s", "full_state_save_s"):
        assert bd[k] > 0, k


def test_save_cadence_every_n_epochs(tmp_path):
    # every=2 over epochs 0..3 saves on epochs 1 and 3 (the final epoch is
    # also always-saved; here it coincides with the cadence)
    d = str(tmp_path / "cad")
    _train(tmpdir=d, save_every=2)
    assert [e for e, _ in ckpt.list_full(d)] == [1, 3]
    # cadence never fires before a stop_after_epochs kill, but the crash-sim
    # exit must still leave the stopped epoch's state on disk for resume
    d2 = str(tmp_path / "cad_stop")
    _train(tmpdir=d2, save_every=5, stop_after=2)
    assert [e for e, _ in ckpt.list_full(d2)] == [1]


def test_full_state_rotation(tmp_path):
    d = str(tmp_path / "rot")
    state = {"x": np.arange(4.0)}
    for epoch in range(5):
        ckpt.save_full(d, epoch, state, keep=2)
    entries = ckpt.list_full(d)
    assert [e for e, _ in entries] == [3, 4]
    assert ckpt.latest_full(d)[0] == 4
    restored = ckpt.load_full(ckpt.latest_full(d)[1])
    np.testing.assert_array_equal(restored["x"], np.arange(4.0))


def test_full_state_names_every_tensor(tmp_path):
    """The saved state holds the trainer's and the envs' generators, the
    Adam moments, and the whole env batch including the autoreset caches."""
    d = str(tmp_path / "names")
    _train(tmpdir=d, num_evals=2)
    names = set(ckpt.load_full(ckpt.latest_full(d)[1]))
    assert {"generators/epoch", "generators/eval", "generators/env", "generators/eval_env",
            "training_state/opt_state/count", "training_state/env_steps",
            "training_state/opt_state/mu/policy/params/hidden_0/kernel",
            "training_state/normalizer/count", "env_state/info/first_data",
            "env_state/info/first_obs/state", "env_state/info/steps",
            "env_state/metrics/dist"} <= names


def _full_params(seed=0):
    obs_sizes = {"state": 101, "privileged_state": 212}
    network = nets.PPONetworks(obs_sizes, 14, policy_hidden_layer_sizes=(32, 16),
                               value_hidden_layer_sizes=(32, 16),
                               generator=torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed)
    normalizer = nets.rs_update(nets.rs_init(obs_sizes), {
        k: torch.as_tensor(rng.randn(8, n).astype(np.float32)) for k, n in obs_sizes.items()})
    return network, (normalizer, network)


def test_checkpoint_roundtrip(tmp_path):
    _, full = _full_params(seed=0)
    path = ckpt.save(str(tmp_path / "ckpt_0"), full)
    assert path.endswith("ckpt_0.npz")
    _, other = _full_params(seed=1)  # different values, same structure
    restored = ckpt.load(str(tmp_path / "ckpt_0"), other)
    _assert_same_params(full, restored)
    for p, q in zip(full[1].parameters(), restored[1].parameters()):
        assert p.dtype == q.dtype
    assert not torch.equal(other[1].policy.hidden_0.weight, full[1].policy.hidden_0.weight)
    names = set(np.load(path).files)
    assert {"params/policy/params/hidden_0/kernel", "params/value/params/hidden_2/bias",
            "normalizer/mean/state", "normalizer/std/privileged_state",
            "normalizer/count"} <= names
    assert np.load(path)["params/policy/params/hidden_0/kernel"].shape == (101, 32)


def test_checkpoint_restored_policy_acts_identically(tmp_path):
    network, full = _full_params(seed=2)
    path = str(tmp_path / "ckpt_1")
    ckpt.save(path, full)
    _, other = _full_params(seed=3)
    restored = ckpt.load(path, other)
    policy = network.make_policy_fn(deterministic=True)
    obs = {"state": torch.linspace(-1, 1, 101)[None], "privileged_state": torch.zeros(1, 212)}
    a1, _ = policy(full, obs)
    a2, _ = policy(restored, obs)
    assert torch.equal(a1, a2)
