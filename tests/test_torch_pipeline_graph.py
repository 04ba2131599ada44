"""The general pipeline's captured bodies, on the CPU.

On the card at world size 1, an env with physics="pipeline" (ops/forward.py)
has its control step replayed as a CUDA graph, as the fused kernel's is:
`wrapper.EnvStepProgram` records `step_into`, `ppo.RolloutProgram`
records one env step of the policy and `TrainEnv.step` per graph (a
pipeline control step is ~43,000-56,000 small kernels: no graph spans
more than one), `ppo.EvalStepProgram` one eval step. Here, without a card:

- the body the env-step graph records (`step_into` over buffers) equals
  `TrainEnv.step` bit for bit (NaN for NaN) over 3 steps of a flat DR
  pipeline env with a NaN action and an autoreset, every leaf of the
  pipeline's Data and Contact included, and the env generator's state;
- `clone_tree` of a pipeline state gives every leaf, the int32 and bool
  contact fields included, a storage of its own;
- after a warm-up step, a pipeline step (flat and rough, with an
  autoreset, and on a second DR model) makes no tensor from host data,
  reads no tensor back to the host and grows none of ops/smooth.py's
  tables: the CPU's proxy for "safe to capture";
- the rollout program make_rollout makes for the pipeline (a
  RolloutProgram of span 1, its body run eagerly on the CPU) equals
  ppo.rollout bit for bit over 2 rollouts of 2 steps;
- a pipeline env on a CUDA device (a stub attribute) is captured: the
  rollout's span is one step (the kernel's the whole unroll), and
  make_rollout and make_eval_step log the captured forms.

The replays on the card are tests/test_torch_cuda.py
(test_captured_pipeline_env_step_matches_eager,
test_captured_pipeline_rollout_matches_eager) and chip_smoke.py phase 8; the
body against the JAX package's jitted pipeline step is
tests/test_torch_forward.py::test_captured_body_on_the_pipeline_matches_jax.
"""

import numpy as np
import pytest
import torch

from open_duck_playground_tpu_torch.envs import randomize, wrapper
from open_duck_playground_tpu_torch.envs.joystick import Joystick
from open_duck_playground_tpu_torch.envs.wrapper import TrainEnv
from open_duck_playground_tpu_torch.ops import cuda_step, smooth
from open_duck_playground_tpu_torch.train import ppo
from open_duck_playground_tpu_torch.utils.graphs import clone_tree, tree_leaves
from tests.torch_helpers import standin_assets

pytest_plugins = ["tests.torch_lock"]  # never beside tests/test_resume.py (see there)

# immediate action delay: a NaN action reaches the physics in its own step
DELAY_0 = {"noise_config.action_max_delay": 1}
NF = {"policy_hidden_layer_sizes": (32, 16), "value_hidden_layer_sizes": (32, 16)}
# the fields only the pipeline fills (the kernel leaves them None)
PIPELINE_ONLY = ("/data/qacc", "/data/xpos", "/data/cvel", "/data/qfrc_constraint",
                 "/data/contact/pos", "/data/contact/frame", "/data/contact/geom1",
                 "/data/contact/efc_valid")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    with standin_assets(str(tmp_path_factory.mktemp("standin"))) as r:
        yield r


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1).contiguous().view(torch.uint8)


def _assert_same(a, b, where="") -> None:
    """Every tensor of `a` and `b` equal bit for bit (NaN for NaN)."""
    ta, tb = tree_leaves(a), tree_leaves(b)
    assert ta.keys() == tb.keys(), where
    for k, x in ta.items():
        y = tb[k]
        assert x.dtype == y.dtype and x.shape == y.shape, (where, k)
        assert torch.equal(_bits(x), _bits(y)), (where, k)


def _pipeline(task="flat_terrain", B=3, episode_length=1000, seed=3, dr_seed=0):
    env = Joystick(task, config_overrides=DELAY_0, device="cpu", seed=seed, physics="pipeline")
    te = TrainEnv(env, num_envs=B, episode_length=episode_length,
                  randomization_fn=randomize.domain_randomize,
                  randomization_generator=torch.Generator().manual_seed(dr_seed))
    return env, te


def test_env_step_body_equals_functional_step(root):
    """3 steps of step_into over buffers cloned from a reset against 3
    steps of TrainEnv.step from the same reset and generator state, 3
    pipeline envs, DR on, episode_length 2: env 0 takes a NaN action at step
    0 and terminates (and at every step after: its info keeps the NaN motor
    target), the others are truncated at step 1; at step 2 every env
    restarts from its first state. Every leaf of every step's state
    (the pipeline's Data and Contact fields too) and the env generator's
    state after the run are equal bit for bit; the buffers are the same
    tensors throughout."""
    B = 3
    env, te = _pipeline(B=B, episode_length=2)
    actions = np.random.RandomState(4).uniform(-1, 1, (3, B, env.action_size)).astype(np.float32)
    actions[0, 0] = np.nan
    actions = torch.from_numpy(actions)
    start = te.reset(torch.Generator().manual_seed(1))
    g0 = env.generator.get_state()

    eager, state = [], start
    for a in actions:
        state = te.step(state, a)
        eager.append(state)
    g_eager = env.generator.get_state()

    env.generator.set_state(g0)
    buffers = clone_tree(start)
    held = list(tree_leaves(buffers).values())
    assert set(PIPELINE_ONLY) <= tree_leaves(buffers).keys()
    for k, a in enumerate(actions):
        assert wrapper.step_into(te, buffers, a) is buffers
        _assert_same(buffers, eager[k], f"step {k}")
    assert all(x is y for x, y in zip(tree_leaves(buffers).values(), held))
    assert torch.equal(env.generator.get_state(), g_eager)

    done = torch.stack([s.done for s in eager])
    trunc = torch.stack([s.info["truncation"] for s in eager])
    assert done[0, 0] == 1 and trunc[0, 0] == 0  # the NaN action terminated env 0
    assert bool(torch.isnan(eager[0].data.qpos[0]).any())
    assert bool((trunc[1, 1:] == 1).all())  # truncated at episode_length
    assert bool((eager[2].info["steps"] == 1).all())  # every env restarted
    # env 0's info keeps the NaN motor target (as the reference's does)
    assert bool(torch.isfinite(eager[2].data.qpos[1:]).all())


def test_clone_tree_of_a_pipeline_state_shares_no_storage(root):
    """Reset puts its Data in the autoreset cache itself and the pipeline's
    Data holds one tensor at two places (qacc and qacc_warmstart): each
    leaf of the clone, the int32 geom ids and the bool efc_valid included,
    has a storage of its own, holding the same bits."""
    _, te = _pipeline(B=2)
    state = te.reset(torch.Generator().manual_seed(1))
    leaves = tree_leaves(state)
    assert leaves["/data/qacc"] is leaves["/data/qacc_warmstart"]
    assert leaves["/data/qpos"] is leaves["/info/first_data/qpos"]
    clone = tree_leaves(clone_tree(state))
    assert clone.keys() == leaves.keys() and set(PIPELINE_ONLY) <= clone.keys()
    ptrs = [t.untyped_storage().data_ptr() for t in clone.values()]
    assert len(set(ptrs)) == len(ptrs)
    assert not set(ptrs) & {t.untyped_storage().data_ptr() for t in leaves.values()}
    assert clone["/data/contact/geom1"].dtype == torch.int32
    assert clone["/data/contact/efc_valid"].dtype == torch.bool
    for k, t in leaves.items():
        assert torch.equal(_bits(clone[k]), _bits(t)), k


HOST_READS = ("__bool__", "__int__", "__float__", "__index__", "item", "tolist", "numpy", "cpu")


@pytest.mark.parametrize("task", ["flat_terrain", "rough_terrain_backlash"])
def test_pipeline_step_is_safe_to_capture(root, task, monkeypatch):
    """After one warm-up step, a step of the pipeline env (episode_length 1,
    so it autoresets every env) and a step of a second TrainEnv on the same
    env with another DR draw make no tensor from host data
    (torch.tensor / as_tensor / from_numpy, or a number written through a
    tensor index), read no tensor back to the host (item, bool, int, float,
    tolist, numpy, cpu) and grow none of ops/smooth.py's index and constant
    tables: what a CUDA graph of the step needs, checked without a card."""
    env, te = _pipeline(task, B=2, episode_length=1)
    te2 = TrainEnv(env, num_envs=2, episode_length=1, randomization_fn=randomize.domain_randomize,
                   randomization_generator=torch.Generator().manual_seed(9))
    act = torch.zeros(2, env.action_size)
    state = te.step(te.reset(torch.Generator().manual_seed(1)), act)
    state2 = te2.reset(torch.Generator().manual_seed(2))
    tables = lambda: (len(smooth._INDEX_CACHE), len(smooth._ANCESTOR_MASK_CACHE),  # noqa: E731
                      len(smooth._BODY_DOF_MASK_CACHE))
    before = tables()

    calls = []

    def spy(owner, name):
        fn = getattr(owner, name)

        def recorded(*a, **k):
            calls.append(name)
            return fn(*a, **k)

        monkeypatch.setattr(owner, name, recorded)

    for name in ("tensor", "as_tensor", "from_numpy"):
        spy(torch, name)
    for name in HOST_READS:
        spy(torch.Tensor, name)
    setitem = torch.Tensor.__setitem__

    def checked_setitem(self, idx, value):
        # a Python number written through a tensor index is a host tensor
        # copied to the card (refused while a graph captures)
        parts = idx if isinstance(idx, tuple) else (idx,)
        if not isinstance(value, torch.Tensor) and any(isinstance(p, torch.Tensor)
                                                       for p in parts):
            calls.append("__setitem__ of a number through a tensor index")
        return setitem(self, idx, value)

    monkeypatch.setattr(torch.Tensor, "__setitem__", checked_setitem)
    out = te.step(state, act)
    out2 = te2.step(state2, act)
    monkeypatch.undo()
    assert calls == []
    assert tables() == before
    assert bool((out.info["steps"] == 1).all())  # the step autoreset every env
    assert bool(torch.isfinite(out.data.qpos).all() and torch.isfinite(out2.data.qpos).all())


def _hyper(num_envs: int, unroll_length: int) -> ppo.Hyper:
    return ppo.Hyper(num_envs=num_envs, unroll_length=unroll_length, num_minibatches=1,
                     batch_size=num_envs, num_updates_per_batch=1, action_repeat=1,
                     learning_rate=3e-4, entropy_cost=5e-3, discounting=0.97, gae_lambda=0.95,
                     clipping_epsilon=0.2, normalize_advantage=True, reward_scaling=1.0,
                     normalize_observations=True, max_grad_norm=1.0)


def _training_state(env, seed=6):
    obs_sizes = {k: v[0] for k, v in env.observation_size.items()}
    return ppo.init_training_state(obs_sizes, env.action_size, NF,
                                   torch.Generator().manual_seed(seed), "cpu")


def test_pipeline_rollout_body_equals_rollout(root):
    """The rollout make_rollout makes for a pipeline env, run on the CPU as
    on the card but for the graph (its body eagerly): a RolloutProgram of
    span 1, whose one-step body runs unroll_length times per call, each
    step's Transition copied into stacked tensors. Two consecutive rollouts
    of 2 steps at 3 envs (episode_length 3: the second rollout autoresets)
    against ppo.rollout from the same reset and generator state: the final
    states, the Transitions and the generator states bit for bit."""
    env, te = _pipeline(B=3, episode_length=3)
    ts = _training_state(env)
    hp = _hyper(3, 2)
    noise = torch.from_numpy(np.random.RandomState(7).randn(2, 2, 3, env.action_size)
                             .astype(np.float32))
    start = te.reset(torch.Generator().manual_seed(1))
    g0 = env.generator.get_state()
    state, eager = start, []
    for n in noise:
        state, data = ppo.rollout(te, state, ts.normalizer, ts.params, n)
        eager.append((clone_tree(state), clone_tree(data)))
    g_eager = env.generator.get_state()
    assert bool((eager[-1][1].discount == 0).any())  # episodes end inside the run

    roll = ppo.make_rollout(te, ts, hp)
    assert isinstance(roll, ppo.RolloutProgram) and roll.span == 1
    env.generator.set_state(g0)
    state = start
    for k, n in enumerate(noise):
        state, data = roll(te, state, ts.normalizer, ts.params, n)
        assert state is roll.static["state"]
        _assert_same(state, eager[k][0], f"rollout {k} state")
        _assert_same(data, eager[k][1], f"rollout {k} transition")
    assert torch.equal(env.generator.get_state(), g_eager)
    assert roll.replays == 4 and roll.extra == {"env_steps_per_replay": 1}


def test_pipeline_on_a_card_is_captured(root):
    """A pipeline env whose device is a CUDA device (a stub attribute: no
    card is needed to decide) at world size 1 is captured: the rollout's
    span is one control step (the kernel's is the whole unroll), and
    make_rollout and make_eval_step log the captured forms. Nothing is
    captured before a program's first call. On the CPU the same env's
    programs say they run eagerly."""
    env, te = _pipeline(B=2)
    ts = _training_state(env)
    hp = _hyper(2, 20)
    lines = []
    ppo.make_rollout(te, ts, hp, lines.append)
    assert lines[0].endswith(", run eagerly on cpu (no CUDA graph off the card)")
    kernel_env = Joystick("flat_terrain", device="cpu")
    for e in (env, kernel_env):
        e.device = torch.device("cuda")
    lines = []
    roll = ppo.make_rollout(te, ts, hp, lines.append)
    ev = ppo.make_eval_step(te, ts, torch.Generator(), False, lines.append)
    assert isinstance(roll, ppo.RolloutProgram) and roll.span == 1 and roll.graph is None
    assert isinstance(ev, ppo.EvalStepProgram) and ev.graph is None
    assert lines == [
        "[ppo] rollout: 20 replays per training step, each 1 env step of the policy and "
        "TrainEnv.step (physics='pipeline': ~50,000 kernels per control step, a graph per "
        "control step at most), CUDA graphs on cuda, captured at the first call",
        "[ppo] eval step: one replay per eval step, CUDA graphs on cuda, captured at the "
        "first call"]
    kernel_roll = ppo.make_rollout(TrainEnv(kernel_env, num_envs=2, episode_length=1000), ts, hp)
    assert kernel_roll.span == hp.unroll_length
    assert kernel_roll.kernels == [kernel_env.physics, cuda_step.SWISH]  # and the policy's swish
    assert roll.kernels == [cuda_step.SWISH]  # the pipeline launches no fused physics kernel
