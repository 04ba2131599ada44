"""The bodies the card's CUDA graphs record, on the CPU: the env step, the
rollout and the eval step over fixed buffers.

On the card at world size 1 with the fused kernel, `TrainEnv.step`, the
rollout and the eval step are each replayed as one CUDA graph by a
device program (`utils.graphs.Captured`: `wrapper.EnvStepProgram`,
`ppo.RolloutProgram`, `ppo.EvalStepProgram`). A graph replays fixed
addresses, so each records a body that writes its results into buffers
in place: `wrapper.step_into`, `ppo.rollout_into`, and `ppo.eval_step`
copied into the carry. The CPU runs the same programs, each body eagerly;
here they must give what the functional code gives, bit for bit (NaN for
NaN), generator states included:

- the program class itself: static buffers cloned at the first call, no
  copy of a leaf that is its own buffer, a rebound read refused, and
  `between` at every point of a generator body;
- the env step over 5 consecutive steps of Joystick("flat_terrain") and of
  Standing, DR on, through the kernel's plain version, with an autoreset
  (episode_length 3) and a NaN action that terminates an env: a buffer that
  aliased the autoreset cache (reset hands it the first state itself)
  would restore the stepped state;
- the rollout over 2 consecutive rollouts, and the eval episode, stochastic
  and deterministic, against the eval loop as it stood before it was split
  into steps (kept below as the oracle); both on 4 duck envs whose physics
  is the cheap stand-in of tests/torch_helpers.py, made to tip over some
  envs so that episodes end inside the run;
- the env-step body against the JAX package's TrainEnv.step on
  tests/test_torch_env.py's run (8 envs, 5 steps, DR on), to that module's
  test_slice_matches_jax bounds;
- off the card (either physics engine, world 2 as world 1): the
  programs the card captures, run eagerly and saying so, against the bare
  functions over two consecutive calls each.

The replays against the eager bodies on the card are tests/test_torch_cuda.py
(test_captured_env_step_matches_eager, test_captured_rollout_matches_eager)
and chip_smoke.py phases 3, 4 and 9.
"""

import dataclasses

import numpy as np
import pytest
import torch

from open_duck_playground_tpu_torch import interop
from open_duck_playground_tpu_torch.envs import randomize
from open_duck_playground_tpu_torch.envs import wrapper
from open_duck_playground_tpu_torch.envs.joystick import Joystick
from open_duck_playground_tpu_torch.envs.standing import Standing
from open_duck_playground_tpu_torch.envs.wrapper import TrainEnv
from open_duck_playground_tpu_torch.ops.types import Contact, Data
from open_duck_playground_tpu_torch.parallel.dist import EnvShard
from open_duck_playground_tpu_torch.train import networks as nets
from open_duck_playground_tpu_torch.train import ppo
from open_duck_playground_tpu_torch.utils import profiling
from open_duck_playground_tpu_torch.utils.graphs import (
    Captured,
    GraphedBody,
    clone_tree,
    copy_into,
    tree_leaves,
)
from tests.test_torch_env import N_STEPS as JAX_STEPS
from tests.test_torch_env import _port, jax_run, root  # noqa: F401  (fixtures)
from tests.torch_helpers import torch_standin_physics

pytest_plugins = ["tests.torch_lock"]  # never beside tests/test_resume.py (see there)

NF = {"policy_hidden_layer_sizes": (32, 16), "value_hidden_layer_sizes": (32, 16)}
# immediate action delay (a NaN action reaches the physics in its own step);
# noise, IMU delay and pushes as configured, so every step draws
DELAY_0 = {"noise_config.action_max_delay": 1}


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


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def test_copy_into_reads_no_overwritten_buffer():
    """A step hands inputs on to other places (last_act -> last_last_act):
    copying its result into the buffers it read must not read one it has
    already overwritten; a tensor that is its own buffer is left alone."""
    a, b, c = torch.tensor([1.0]), torch.tensor([2.0]), torch.tensor([3.0])
    dst = {"last": a, "last_last": b, "same": c}
    copy_into(dst, {"last": torch.tensor([9.0]), "last_last": a, "same": c})
    assert (a.item(), b.item(), c.item()) == (9.0, 1.0, 3.0)
    with pytest.raises(ValueError, match="cannot copy"):
        copy_into(dst, {"last": torch.zeros(2), "last_last": a, "same": c})


def test_clone_tree_makes_distinct_buffers():
    x = torch.arange(3.0)
    out = clone_tree({"data": x, "info": {"first_data": x}})
    assert out["data"] is not out["info"]["first_data"]
    assert torch.equal(out["data"], x) and out["data"].data_ptr() != x.data_ptr()


def test_captured_copies_in_no_leaf_that_is_its_own_buffer(monkeypatch):
    """A program clones its first call's inputs into static buffers; a later
    call copies in only the leaves that are not already those buffers (one
    copy_ for the one new leaf), and a call handed back all that the last
    one returned copies nothing and opens no ``<prefix>.copy_in`` span."""
    prog = Captured(lambda s: {k: v.add_(1) for k, v in s.items()}, device="cpu", prefix="t")
    x = torch.zeros(2)
    out = prog.run({"x": x, "y": torch.ones(2)})
    assert out["x"] is prog.static["x"] and out["x"] is not x and torch.equal(x, torch.zeros(2))
    copied, copy_ = [], torch.Tensor.copy_

    def spy(t, src, *a, **k):
        copied.append(t)
        return copy_(t, src, *a, **k)

    monkeypatch.setattr(torch.Tensor, "copy_", spy)
    profiling.enable()
    try:
        profiling.reset()
        out = prog.run({"x": out["x"], "y": torch.full((2,), 5.0)})
        assert [s["name"] for s in profiling.spans()] == ["t.copy_in", "t.replay"]
        assert len(copied) == 1 and copied[0] is prog.static["y"]
        profiling.reset()
        out = prog.run(out)
        assert [s["name"] for s in profiling.spans()] == ["t.replay"] and len(copied) == 1
    finally:
        profiling.disable()
        profiling.reset()
    assert out["x"].tolist() == [3.0, 3.0] and out["y"].tolist() == [7.0, 7.0]
    assert prog.replays == 3


def test_captured_refuses_a_rebound_read():
    """What a program reads by reference is handed again at every call and
    checked by identity: another tensor of the same value raises, at the
    first call as at a later one."""
    w = torch.ones(2)
    prog = Captured(lambda s: s["x"] * w, reads=[w], device="cpu")
    with pytest.raises(ValueError, match="reads what it was made for"):
        prog.run({"x": torch.ones(2)}, [w.clone()])
    assert prog.graph is None
    assert torch.equal(prog.run({"x": torch.full((2,), 3.0)}, [w]), torch.full((2,), 3.0))
    with pytest.raises(ValueError, match="reads what it was made for"):
        prog.run({"x": torch.ones(2)}, [w.clone()])
    with pytest.raises(ValueError, match="reads what it was made for"):
        prog.run({"x": torch.ones(2)})


def test_between_runs_at_every_point_off_the_card():
    """Off the card a program whose body is a generator runs it whole at
    each call, `between` at every point it yields, in order, as
    dist.run_points does (the env-sharded SGD step's collectives), and
    returns what it returned; no graph is captured."""
    def body(s):
        a = s["x"] + 1
        yield a
        b = a * 2
        yield b
        return b + s["x"]

    seen = []

    def between(buf):
        seen.append(buf.item())
        buf.add_(10)

    prog = Captured(body, device="cpu", between=between)
    assert prog.run({"x": torch.zeros(())}).item() == 32  # (0 + 1 + 10) * 2 + 10
    assert prog.run({"x": torch.ones(())}).item() == 35  # (1 + 1 + 10) * 2 + 10 + 1
    assert seen == [1.0, 22.0, 2.0, 24.0]
    assert prog.replays == 2 and prog.info == {} and prog.graph.graph is None
    assert GraphedBody(lambda: None, [], device="cpu").eager


# ---------------------------------------------------------------------------
# the env step, through the kernel's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("env_cls,task", [(Joystick, "flat_terrain"),
                                          (Standing, "flat_terrain_backlash")])
def test_env_step_body_equals_functional_step(root, env_cls, task):
    """5 steps of step_into over buffers cloned from a reset against 5
    steps of TrainEnv.step from the same reset and generator state, 3 envs,
    DR on, episode_length 3: env 0 takes a NaN action at step 1 and
    terminates (and at every step after: its info keeps the NaN motor
    target, as the reference's does), envs 1 and 2 are truncated at step 3
    and restart from their first state.
    Every tensor of every step's state and the env generator's state after
    the run are equal bit for bit; the buffers are the same tensors
    throughout."""
    B = 3
    env = env_cls(task, config_overrides=DELAY_0, device="cpu", seed=3)
    te = TrainEnv(env, num_envs=B, episode_length=3, randomization_fn=randomize.domain_randomize,
                  randomization_generator=torch.Generator().manual_seed(0))
    actions = np.random.RandomState(4).uniform(-1, 1, (5, B, env.action_size)).astype(np.float32)
    actions[1, 0] = np.nan
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
    for k, a in enumerate(actions):
        assert wrapper.step_into(te, buffers, a) is buffers
        _assert_same(buffers, eager[k], f"step {k}")
    assert all(x is y for x, y in zip(tree_leaves(buffers).values(), held))
    assert torch.equal(env.generator.get_state(), g_eager)

    done = torch.stack([s.done for s in eager])
    trunc = torch.stack([s.info["truncation"] for s in eager])
    assert done[1, 0] == 1 and trunc[1, 0] == 0  # the NaN action terminated env 0
    # envs 1 and 2: truncated at step 3, running again from their first state
    assert bool((trunc[2, 1:] == 1).all()) and bool((done[3, 1:] == 0).all())
    assert bool(torch.isfinite(eager[-1].data.qpos[1:]).all())


# ---------------------------------------------------------------------------
# the rollout and the eval step, on the stand-in physics
# ---------------------------------------------------------------------------


def _tipping_duck(n_envs: int, episode_length: int, seed: int = 5):
    """A Joystick flat DR env on the CPU whose physics is the cheap
    stand-in, with the up vector flipped (a fall) for the even envs from
    the third step on."""
    env = Joystick("flat_terrain", device="cpu", seed=seed)
    init, step = torch_standin_physics(env)
    up = int(env.model.sensor_adr[env.model.sensor("upvector")])

    def tipping_step(model, d, ctrl):
        d = step(model, d, ctrl)
        fall = (d.time > 2.5 * env.dt) & (torch.arange(d.time.shape[0]) % 2 == 0)
        sd = d.sensordata.clone()
        sd[:, up + 2] = torch.where(fall, -sd[:, up + 2], sd[:, up + 2])
        return d.replace(sensordata=sd)

    env.physics_init, env.physics_step = init, tipping_step
    te = TrainEnv(env, num_envs=n_envs, episode_length=episode_length,
                  randomization_fn=randomize.domain_randomize,
                  randomization_generator=torch.Generator().manual_seed(0))
    return env, te


def _training_state(env, seed=6):
    obs_sizes = {k: v[0] for k, v in env.observation_size.items()}
    return ppo.init_training_state(obs_sizes, env.action_size, NF,
                                   torch.Generator().manual_seed(seed), "cpu")


def test_rollout_body_equals_rollout(root):
    """Two consecutive rollouts of 4 steps at 4 envs (episode_length 6, the
    even envs falling): rollout_into over buffers cloned from the reset
    against ppo.rollout from the same reset and generator state. The
    Transitions, the final states and the generator states are equal bit
    for bit; the second rollout_into starts from the buffers the first
    wrote."""
    env, te = _tipping_duck(4, 6)
    ts = _training_state(env)
    noise = torch.from_numpy(np.random.RandomState(7).randn(2, 4, 4, env.action_size)
                             .astype(np.float32))
    start = te.reset(torch.Generator().manual_seed(1))
    g0 = env.generator.get_state()
    state, eager = start, []
    for n in noise:
        state, data = ppo.rollout(te, state, ts.normalizer, ts.params, n)
        eager.append((state, data))
    g_eager = env.generator.get_state()
    assert bool((eager[-1][1].discount == 0).any())  # episodes end inside the run

    env.generator.set_state(g0)
    buffers = clone_tree(start)
    for k, n in enumerate(noise):
        out, data = ppo.rollout_into(te, buffers, ts.normalizer, ts.params, n)
        assert out is buffers
        _assert_same(buffers, eager[k][0], f"rollout {k} state")
        _assert_same(data, eager[k][1], f"rollout {k} transition")
    assert torch.equal(env.generator.get_state(), g_eager)


@torch.no_grad()
def _oracle_eval(eval_env, normalizer, networks, generator, episode_length, deterministic):
    """run_eval's loop as it stood before it was split into eval steps
    (world size 1)."""
    policy = networks.make_policy_fn(deterministic=True)
    state = eval_env.reset(generator)
    n = eval_env.num_envs
    active, sums, length = torch.ones(n), torch.zeros(n), torch.zeros(n)
    metric_sums = {k: torch.zeros(n) for k in state.metrics}
    for _ in range(episode_length):
        if deterministic:
            action, _ = policy((normalizer, networks), state.obs)
        else:
            noise = torch.randn((n, networks.action_size), generator=generator)
            action = nets.sample_actions(networks, normalizer, state.obs, noise)[0]
        state = eval_env.step(state, action)
        sums = sums + state.reward * active
        metric_sums = {k: v + state.metrics[k] * active for k, v in metric_sums.items()}
        length = length + active
        active = active * (1.0 - state.done)
    out = {"eval/episode_reward": torch.mean(sums),
           "eval/episode_reward_std": torch.std(sums, correction=0),
           "eval/avg_episode_length": torch.mean(length)}
    out.update({f"eval/episode_{k}": torch.mean(v) for k, v in metric_sums.items()})
    return out, sums, length


@pytest.mark.parametrize("deterministic", [False, True])
def test_eval_body_equals_run_eval(root, deterministic):
    """One eval episode of 6 steps at 4 envs (the even envs fall at step 3):
    run_eval through the body the eval graph records (eval_step copied into
    one carry of buffers) and through eval_step, against the loop as it
    stood: every metric, the per-env sums and lengths and the generators'
    states bit for bit."""
    env, te = _tipping_duck(4, 1000)
    ts = _training_state(env)
    carries = []

    def body(eval_env, normalizer, networks, generator, carry, det, shard):
        if not carries:
            carries.append(clone_tree(carry))
        elif carry is not carries[0]:
            copy_into(carries[0], carry)
        copy_into(carries[0], ppo.eval_step(eval_env, normalizer, networks, generator,
                                            carries[0], det, shard))
        return carries[0]

    runs = []
    for step in ("oracle", ppo.eval_step, body):
        g = torch.Generator().manual_seed(8)
        env.generator.manual_seed(9)
        if step == "oracle":
            out, sums, length = _oracle_eval(te, ts.normalizer, ts.params, g, 6, deterministic)
        else:
            out = ppo.run_eval(te, ts.normalizer, ts.params, g, episode_length=6,
                               deterministic=deterministic, step=step)
        runs.append((out, g.get_state(), env.generator.get_state()))
    for out, g, ge in runs[1:]:
        assert out.keys() == runs[0][0].keys()
        for k, v in out.items():
            assert torch.equal(_bits(v), _bits(runs[0][0][k])), k
        assert torch.equal(g, runs[0][1]) and torch.equal(ge, runs[0][2])
    assert torch.equal(carries[0].sums, sums) and torch.equal(carries[0].length, length)
    assert float(runs[0][0]["eval/avg_episode_length"]) < 6  # the fallen envs stopped counting


# ---------------------------------------------------------------------------
# the env-step body against the JAX package
# ---------------------------------------------------------------------------


def _kernel_fields(d: Data) -> Data:
    return d.replace(contact=Contact(dist=d.contact.dist),
                     **{f.name: None for f in dataclasses.fields(d) if f.default is None})


def test_env_step_body_matches_jax(jax_run):
    """test_torch_env.py's JAX run (TrainEnv of Joystick("flat_terrain"), 8
    envs, DR on, deterministic but for physics) through the port's
    step_into over buffers cloned from JAX's reset state, with
    test_slice_matches_jax's bounds after 5 steps: done identical at every
    step; obs |err| q50 < 1e-5, q90 < 1e-2, max < 2.0 (a foot-contact flag
    that flips between the two physics programs is an obs difference of
    1); reward |err| max < 0.05."""
    env, te = _port(jax_run)
    states, actions = jax_run["states"], jax_run["actions"]
    start = interop.state_from_numpy(states[0])
    # the fields the fused kernel fills: a captured step's state keeps one
    # structure (JAX's Data carries the general pipeline's fields too)
    info = dict(start.info, first_data=_kernel_fields(start.info["first_data"]))
    buffers = clone_tree(start.replace(data=_kernel_fields(start.data), info=info))
    for k in range(JAX_STEPS):
        wrapper.step_into(te, buffers, torch.from_numpy(actions[k]))
        ref = states[k + 1]
        np.testing.assert_array_equal(buffers.done.numpy(), ref["done"], err_msg=f"step {k}")
    err = np.concatenate([np.abs(buffers.obs[key].numpy() - ref["obs"][key]).ravel()
                          for key in ("state", "privileged_state")])
    assert np.isfinite(err).all()
    assert np.quantile(err, 0.5) < 1e-5, np.quantile(err, 0.5)
    assert np.quantile(err, 0.9) < 1e-2, np.quantile(err, 0.9)
    assert err.max() < 2.0, err.max()
    assert np.abs(buffers.reward.numpy() - ref["reward"]).max() < 0.05


# ---------------------------------------------------------------------------
# which path runs
# ---------------------------------------------------------------------------


def test_eager_path_off_the_card(root):
    """Off the card the trainer runs the programs it runs on the card,
    each body eagerly: make_rollout and make_eval_step give a
    RolloutProgram and an EvalStepProgram on either physics engine and at
    world 2 as at world 1, and log that they run eagerly. Over two
    consecutive calls each (4 envs, episode_length 6, the even envs
    falling), from the same reset and generator states: the rollout
    program against ppo.rollout (states, Transitions), the eval-step
    program against ppo.eval_step (carries) and the env-step program
    against TrainEnv.step (states), with the generators' states, bit for
    bit. Each returns its static buffers, counts its replays and captures
    no graph."""
    env, te = _tipping_duck(4, 6)
    ts = _training_state(env)
    hp = ppo.Hyper(num_envs=4, unroll_length=4, num_minibatches=1, batch_size=4,
                   num_updates_per_batch=1, action_repeat=1, learning_rate=3e-4,
                   entropy_cost=5e-3, discounting=0.97, gae_lambda=0.95, clipping_epsilon=0.2,
                   normalize_advantage=True, reward_scaling=1.0, normalize_observations=True,
                   max_grad_norm=1.0)
    pipeline = TrainEnv(Joystick("flat_terrain", device="cpu", physics="pipeline"),
                        num_envs=4, episode_length=10)
    g = torch.Generator()

    def lines_of(train_env):
        lines = []
        assert isinstance(ppo.make_rollout(train_env, ts, hp, lines.append), ppo.RolloutProgram)
        assert isinstance(ppo.make_eval_step(train_env, ts, g, False, lines.append),
                          ppo.EvalStepProgram)
        return lines

    eager = "run eagerly on cpu (no CUDA graph off the card)"
    kernel = [f"[ppo] rollout: one replay per training step (4 env steps), {eager}",
              f"[ppo] eval step: one replay per eval step, {eager}"]
    assert lines_of(te) == kernel
    env.shard = EnvShard(1, 2)
    assert lines_of(te) == kernel
    env.shard = None
    assert lines_of(pipeline)[0] == (
        "[ppo] rollout: 4 replays per training step, each 1 env step of the policy and "
        "TrainEnv.step (physics='pipeline': ~50,000 kernels per control step, a graph per "
        f"control step at most), {eager}")

    noise = torch.from_numpy(np.random.RandomState(7).randn(2, 4, 4, env.action_size)
                             .astype(np.float32))
    start = te.reset(torch.Generator().manual_seed(1))
    g0 = env.generator.get_state()

    def run(roll, eval_step, env_step):
        """Two rollouts, two eval steps and two env steps from `start`: what
        each call returned, and a copy of it."""
        env.generator.set_state(g0)
        g.manual_seed(8)
        out, state = [], start
        for n in noise:
            state, data = roll(te, state, ts.normalizer, ts.params, n)
            out.append((state, clone_tree({"state": state, "data": data})))
        carry = ppo.eval_start(start)
        for _ in range(2):
            carry = eval_step(te, ts.normalizer, ts.params, g, carry, False, None)
            out.append((carry, clone_tree(carry)))
        state = start
        for a in noise[0, :2]:
            state = env_step(state, a)
            out.append((state, clone_tree(state)))
        return out, g.get_state(), env.generator.get_state()

    want = run(ppo.rollout, ppo.eval_step, te.step)
    programs = (ppo.make_rollout(te, ts, hp), ppo.make_eval_step(te, ts, g, False),
                wrapper.EnvStepProgram(te))
    got = run(*programs)
    for k, ((_, copy), (_, ref)) in enumerate(zip(got[0], want[0])):
        _assert_same(copy, ref, f"call {k}")
    roll, ev, step = programs
    statics = [roll.static["state"]] * 2 + [ev.static["carry"]] * 2 + [step.static["state"]] * 2
    assert all(r is b for (r, _), b in zip(got[0], statics))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    for p in programs:
        assert p.replays == 2 and p.info == {} and p.graph.graph is None


def test_dr_fields_are_flattened_once_per_model(root):
    """The kernel reads the DR fields from the flat tensors of one
    flattening per randomized model (a graph keeps the pointers it
    captured); another model is flattened anew."""
    env = Joystick("flat_terrain", device="cpu")
    models = [randomize.domain_randomize(env.model, 2, torch.Generator().manual_seed(s))
              for s in (0, 1)]
    first = env._dr(models[0])
    assert env._dr(models[0]) is first
    assert env._dr(models[1]) is not first and env._dr(env.model) is None
