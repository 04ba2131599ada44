"""The trainer's SGD step over persistent buffers, on the CPU.

On the card at world size 1 the SGD step is one CUDA graph
(`ppo.SGDStepProgram`) over the params, the Adam state and the normalizer,
updated in place. Its body, `ppo.sgd_step`, is what the same program runs
eagerly on the CPU; it must give what the functional step gave before the
buffers became persistent, bit for bit, over consecutive steps (a step
that aliased or rebound a buffer would show on the second), and so must
the program. The functional step and Adam are kept below as the oracle,
as they stood before.

Inputs are seeded numpy at a small size: 64 envs, 4 minibatches of 16, 2
updates per batch, unroll 5, (32, 16) networks. The replay against the
eager body on the card is `tests/test_torch_cuda.py`
(test_captured_sgd_step_matches_eager_body).
"""

import dataclasses

import numpy as np
import pytest
import torch

from open_duck_playground_tpu_torch.envs.wrapper import TrainEnv
from open_duck_playground_tpu_torch.parallel.dist import EnvShard
from open_duck_playground_tpu_torch.train import networks as nets
from open_duck_playground_tpu_torch.train import optim, ppo
from open_duck_playground_tpu_torch.utils import profiling
from open_duck_playground_tpu_torch.utils.graphs import tree_map
from tests.duck_standin import write_standin

pytest_plugins = ["tests.torch_lock"]  # never beside tests/test_resume.py (see there)

OBS = {"state": 12, "privileged_state": 20}
ACT = 4
N, T, NMB, B, E = 64, 5, 4, 16, 2
NF = {"policy_hidden_layer_sizes": (32, 16), "value_hidden_layer_sizes": (32, 16)}


def _hyper(normalize_observations=True, max_grad_norm=1.0) -> ppo.Hyper:
    return ppo.Hyper(num_envs=N, unroll_length=T, num_minibatches=NMB, batch_size=B,
                     num_updates_per_batch=E, action_repeat=1, learning_rate=3e-4,
                     entropy_cost=5e-3, discounting=0.97, gae_lambda=0.95,
                     clipping_epsilon=0.2, normalize_advantage=True, reward_scaling=1.0,
                     normalize_observations=normalize_observations, max_grad_norm=max_grad_norm)


def _state(seed: int) -> ppo.TrainingState:
    return ppo.init_training_state(OBS, ACT, NF, torch.Generator().manual_seed(seed), "cpu")


def _clone(ts: ppo.TrainingState) -> ppo.TrainingState:
    params = nets.PPONetworks(OBS, ACT, **NF)
    params.load_state_dict(ts.params.state_dict())
    return ts.replace(params=params, opt_state=optim.clone_state(ts.opt_state),
                      normalizer=tree_map(torch.clone, ts.normalizer))


def _inputs(ts: ppo.TrainingState, seed: int):
    """A seeded rollout's Transition (actions, raw actions and log probs from
    the state's policy), per-epoch permutations and entropy noise."""
    rng = np.random.RandomState(seed)
    f32 = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))  # noqa: E731
    obs = {k: f32(T, N, n) * 2.0 + 0.5 for k, n in OBS.items()}
    nxt = {k: v + 0.1 * f32(T, N, v.shape[-1]) for k, v in obs.items()}
    action, raw, log_prob = nets.sample_actions(ts.params, ts.normalizer, obs, f32(T, N, ACT))
    done = torch.from_numpy((rng.rand(T, N) < 0.1).astype(np.float32))
    trunc = torch.from_numpy((rng.rand(T, N) < 0.1).astype(np.float32)) * done
    data = ppo.Transition(observation=obs, action=action, reward=f32(T, N), discount=1.0 - done,
                          next_observation=nxt, truncation=trunc, raw_action=raw,
                          log_prob=log_prob)
    perms = torch.from_numpy(np.stack([rng.permutation(N) for _ in range(E)]))
    return data, perms, f32(E, NMB, T, B, ACT)


# ---------------------------------------------------------------------------
# the oracle: the functional Adam and SGD step, as they stood before the
# buffers became persistent (world size 1)
# ---------------------------------------------------------------------------


@torch.no_grad()
def _functional_adam(params, grads, state, learning_rate, b1=0.9, b2=0.999, eps=1e-8):
    mu = [(1 - b1) * g + b1 * m for g, m in zip(grads, state.mu)]
    nu = [(1 - b2) * (g * g) + b2 * v for g, v in zip(grads, state.nu)]
    count = state.count + 1
    bc1 = 1 - b1 ** count.to(torch.float32)
    bc2 = 1 - b2 ** count.to(torch.float32)
    for p, m, v in zip(params, mu, nu):
        update = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        p.copy_(p + (-learning_rate) * update)
    return optim.AdamState(count=count, mu=mu, nu=nu)


def _functional_sgd_step(training_state, data, perms, entropy_noise, hp):
    if hp.normalize_observations:
        normalizer = nets.rs_update(training_state.normalizer, data.observation)
    else:
        normalizer = training_state.normalizer
    networks = training_state.params
    params = list(networks.parameters())
    opt_state = training_state.opt_state
    b = hp.batch_size
    aux = []
    for e in range(hp.num_updates_per_batch):
        for j in range(hp.num_minibatches):
            idx, ent = perms[e, j * b:(j + 1) * b], entropy_noise[e, j]
            mb = tree_map(lambda x: x.index_select(1, idx), data)
            total, mb_aux = ppo.loss_fn(networks, normalizer, mb, ent, hp)
            grads = torch.autograd.grad(total, params)
            if hp.max_grad_norm is not None:
                grads = optim.clip_by_global_norm(grads, hp.max_grad_norm)
            opt_state = _functional_adam(params, grads, opt_state, hp.learning_rate)
            aux.append(mb_aux)
    stacked = {k: torch.stack([a[k] for a in aux]).reshape(
        hp.num_updates_per_batch, hp.num_minibatches) for k in aux[0]}
    return training_state.replace(normalizer=normalizer, opt_state=opt_state), stacked


def _assert_same_learner(a: ppo.TrainingState, b: ppo.TrainingState) -> None:
    ta, tb = ppo.learner_tensors(a), ppo.learner_tensors(b)
    assert len(ta) == len(tb)
    for i, (x, y) in enumerate(zip(ta, tb)):
        assert x.dtype == y.dtype and torch.equal(x, y), i


# ---------------------------------------------------------------------------


def test_adam_in_place_equals_functional():
    """optim.adam over the state's own buffers against the functional step,
    3 steps with the clip taken on the first and last: params, count, mu,
    nu bit for bit, and the same tensors before and after."""
    ts = _state(0)
    params = list(ts.params.parameters())
    ref_params = [p.detach().clone() for p in params]
    state, ref = ts.opt_state, optim.clone_state(ts.opt_state)
    buffers = [state.count, *state.mu, *state.nu]
    rng = np.random.RandomState(1)
    for norm in (25.0, 0.5, 3.0):
        g = [torch.from_numpy(rng.randn(*p.shape).astype(np.float32)) for p in params]
        scale = norm / float(optim.global_norm(g))
        g = optim.clip_by_global_norm([x * scale for x in g], 1.0)
        assert optim.adam(params, g, state, 3e-4) is state
        ref = _functional_adam(ref_params, g, ref, 3e-4)
    assert all(a is b for a, b in zip([state.count, *state.mu, *state.nu], buffers))
    assert int(state.count) == 3 and state.count.dtype == torch.int32
    for x, y in zip([*params, state.count, *state.mu, *state.nu],
                    [*ref_params, ref.count, *ref.mu, *ref.nu]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("max_grad_norm", [1.0, None])
def test_clip_and_adam_runs_the_plain_functions_on_the_cpu(max_grad_norm):
    """optim.clip_and_adam on CPU tensors is clip_by_global_norm (unless
    None) then adam, bit for bit, on the state's own tensors, over 3 steps
    with the clip taken on the first and last; the tracer counts each as a
    plain step and none as fused."""
    ts = _state(7)
    params = list(ts.params.parameters())
    ref_params = [p.detach().clone() for p in params]
    state, ref = ts.opt_state, optim.clone_state(ts.opt_state)
    tensors = [*params, state.count, *state.mu, *state.nu]
    rng = np.random.RandomState(8)
    profiling.reset()
    for norm in (25.0, 0.5, 3.0):
        g = [torch.from_numpy(rng.randn(*p.shape).astype(np.float32)) for p in params]
        g = [x * (norm / float(optim.global_norm(g))) for x in g]
        assert optim.clip_and_adam(params, g, state, 3e-4, max_grad_norm) is state
        if max_grad_norm is not None:
            g = optim.clip_by_global_norm(g, max_grad_norm)
        optim.adam(ref_params, g, ref, 3e-4)
    counters = profiling.summary()["counters"]
    assert counters["optim.plain_steps"] == 3 and counters["optim.fused_steps"] == 0
    assert all(a is b for a, b in zip([*params, state.count, *state.mu, *state.nu], tensors))
    for x, y in zip(tensors, [*ref_params, ref.count, *ref.mu, *ref.nu]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("reward_scaling", [1.0, 0.37])
def test_gae_runs_compute_gae_on_the_cpu(reward_scaling):
    """ppo.gae on CPU tensors is compute_gae on the rewards and termination
    loss_points made before it, bit for bit (a NaN stays in its column);
    the tracer counts each call as a plain step and none as fused."""
    hp = dataclasses.replace(_hyper(), reward_scaling=reward_scaling)
    ts = _state(3)
    data, _, _ = _inputs(ts, 4)
    data = dataclasses.replace(data, reward=data.reward.clone())
    data.reward[2, 5] = float("nan")
    rng = np.random.RandomState(5)
    values = torch.from_numpy(rng.randn(T, N).astype(np.float32))
    boot = torch.from_numpy(rng.randn(N).astype(np.float32))
    profiling.reset()
    vs, adv = ppo.gae(data, values, boot, hp)
    counters = profiling.summary()["counters"]
    assert counters["gae.plain_steps"] == 1 and counters["gae.fused_steps"] == 0
    termination = (1 - data.discount) * (1 - data.truncation)
    ref_vs, ref_adv = ppo.compute_gae(data.truncation, termination,
                                      data.reward * reward_scaling, values, boot,
                                      lambda_=hp.gae_lambda, discount=hp.discounting)
    for x, y in ((vs, ref_vs), (adv, ref_adv)):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))
        assert torch.isnan(x).any(0).nonzero().flatten().tolist() == [5]


def _swish_grad_reference(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The gradient the swish's backward kernel (ops/csrc/swish.cu) computes,
    written out: g * s + ((g * x) * (1 - s)) * s with s = sigmoid(x), every
    product and sum rounded on its own."""
    s = torch.sigmoid(x)
    return g * s + ((g * x) * (1 - s)) * s


def _swish_values(shape, seed: int):
    """Seeded x (normal, scaled by 6) and g (normal) of `shape`, with special
    values at the head of x: +-0, +-inf, NaN, subnormals, |x| past 88 where
    exp(-x) overflows or sigmoid underflows, FLT_MAX; and g large where
    g * x overflows."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 6).astype(np.float32).reshape(-1)
    g = rng.randn(*shape).astype(np.float32).reshape(-1)
    tiny = np.finfo(np.float32).tiny
    big = np.finfo(np.float32).max
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, tiny / 8, -tiny / 8, tiny, 88.5,
                        -88.5, 89.0, -89.0, 104.0, -104.0, 1e30, -1e30, big, -big, 1e10, -1e10],
                       dtype=np.float32)
    x[:len(special)] = special
    g[len(special) - 2:len(special)] = 1e30  # g * x overflows at x = +-1e10
    return torch.from_numpy(x.reshape(shape)), torch.from_numpy(g.reshape(shape))


def _same_floats(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit where neither is NaN, and NaN where the other is."""
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))
                and torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32)))


def test_swish_runs_the_plain_expression_on_the_cpu():
    """networks.swish on CPU tensors is x * sigmoid(x) bit for bit, and so is
    its gradient; an MLP's forward calls it once per hidden layer. The
    tracer counts each call as plain and none as fused."""
    x, g = _swish_values((5, 33), 1)
    mlp = nets.MLP([33, 32, 16, 8], torch.Generator().manual_seed(0))
    profiling.reset()
    xr = x.clone().requires_grad_()
    y = nets.swish(xr)
    y.backward(g)
    mlp(torch.randn(7, 33, generator=torch.Generator().manual_seed(1)))
    counters = profiling.summary()["counters"]
    assert counters["swish.plain_calls"] == 3 and counters["swish.fused_calls"] == 0
    xp = x.clone().requires_grad_()
    want = xp * torch.sigmoid(xp)
    want.backward(g)
    assert _same_floats(y.detach(), want.detach()) and _same_floats(xr.grad, xp.grad)


@pytest.mark.parametrize("width", [512, 256, 128])
def test_swish_backward_formula_equals_autograd(width):
    """The backward kernel's formula as a plain function equals autograd's
    gradient of x * sigmoid(x) bit for bit (g * s from mul, sigmoid_backward
    of g * x, their sum), on the SGD step's [unroll, batch, width] shapes
    with special values."""
    x, g = _swish_values((20, 256, width), width)
    xr = x.clone().requires_grad_()
    (xr * torch.sigmoid(xr)).backward(g)
    assert _same_floats(_swish_grad_reference(g, x), xr.grad)


def test_swish_kernels_refuse_cpu_tensors():
    """The swish's kernel wrappers raise on what the kernels do not take (a
    CPU tensor here), before any build: nothing falls back."""
    from open_duck_playground_tpu_torch.ops import cuda_step

    x = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        cuda_step.swish_forward(x)
    with pytest.raises(ValueError):
        cuda_step.swish_backward(x, x)


@pytest.mark.parametrize("normalize_observations,max_grad_norm", [(True, 1.0), (False, None)])
def test_sgd_body_equals_functional_step(normalize_observations, max_grad_norm):
    """Two consecutive SGD steps of the body against the functional step on
    a copy of the same state: params, Adam count and moments, normalizer
    and the [epochs, nmb] loss terms bit for bit; the body's state keeps its
    tensors (the same objects, updated in place)."""
    hp = _hyper(normalize_observations, max_grad_norm)
    ts = _state(2)
    ref = _clone(ts)
    buffers = ppo.learner_tensors(ts)
    for step in range(2):
        data, perms, ent = _inputs(ts, 10 + step)
        out, losses = ppo.sgd_step(ts, data, perms, ent, hp)
        ref, ref_losses = _functional_sgd_step(ref, data, perms, ent, hp)
        assert out is ts
        _assert_same_learner(ts, ref)
        assert losses.keys() == ref_losses.keys()
        for k, v in losses.items():
            assert v.shape == (E, NMB) and torch.equal(v, ref_losses[k]), (step, k)
    assert all(a is b for a, b in zip(ppo.learner_tensors(ts), buffers))
    assert int(ts.opt_state.count) == 2 * E * NMB
    assert float(ts.normalizer.count) == (2 * T * N if normalize_observations else 0)


def test_restore_full_state_into_existing_buffers():
    """A run of two SGD steps, and the same run saved after its first step
    (full_state, through numpy) and restored into the buffers of another
    run's state: the restore keeps that state's tensors, and its second
    step gives the uninterrupted run's learner bit for bit."""
    hp = _hyper()
    inputs = [_inputs(_state(3), 20 + s) for s in range(2)]
    a = _state(3)
    for x in inputs:
        ppo.sgd_step(a, *x, hp)

    b = _state(3)
    ppo.sgd_step(b, *inputs[0], hp)
    b = b.replace(env_steps=b.env_steps + hp.env_steps_per_training_step)
    arrays = ppo.full_state_to_numpy(ppo.full_state(b, None, {}))
    c = _state(4)
    buffers = ppo.learner_tensors(c)
    c, env_state = ppo.restore_full_state(arrays, c, None, {})
    assert env_state is None and int(c.env_steps) == hp.env_steps_per_training_step
    assert all(x is y for x, y in zip(ppo.learner_tensors(c), buffers))
    _assert_same_learner(c, b)
    ppo.sgd_step(c, *inputs[1], hp)
    _assert_same_learner(c, a)


def test_snapshot_and_restore_of_the_learner():
    """restore_learner puts a snapshot back into the state's own tensors:
    a step taken and undone leaves the learner bit for bit as before."""
    ts = _state(5)
    before = [t.clone() for t in ppo.learner_tensors(ts)]
    saved = ppo.snapshot_learner(ts)
    ppo.sgd_step(ts, *_inputs(ts, 30), _hyper())
    assert not torch.equal(ppo.learner_tensors(ts)[0], before[0])
    ppo.restore_learner(ts, saved)
    assert all(torch.equal(x, y) for x, y in zip(ppo.learner_tensors(ts), before))


def test_sgd_step_choice_off_the_card():
    """On the CPU, at world 1 as in an env-sharded run, the trainer runs the
    same SGD step program as on the card (SGDStepProgram), its body
    eagerly, and its log line says so. Over two consecutive steps with
    other inputs, the program and ppo.sgd_step on copies of one state give
    the learner's tensors and the loss terms bit for bit; the program keeps
    updating the state's own tensors, refuses a rebound one, and captures
    no graph."""
    ts, hp = _state(6), _hyper()
    lines = []
    sgd = ppo.make_sgd_step(ts, hp, EnvShard(0, 1), lines.append)
    assert isinstance(ppo.make_sgd_step(ts, hp, EnvShard(1, 2), lines.append), ppo.SGDStepProgram)
    eager = "run eagerly on cpu (no CUDA graph off the card)"
    assert lines[0] == f"[ppo] SGD step: one replay per training step, {eager}"
    assert lines[1] == ("[ppo] SGD step: one replay per training step at world 2 (no process "
                        "group; 28 sums over the ranks between 29 segments, on fixed buffers), "
                        f"{eager}")
    ref = _clone(ts)
    held = ppo.learner_tensors(ts)
    for k in range(2):
        data, perms, ent = _inputs(ts, 40 + k)
        out, losses = sgd(ts, data, perms, ent, hp, EnvShard(0, 1))
        _, want = ppo.sgd_step(ref, data, perms, ent, hp)
        assert out is ts and all(x is y for x, y in zip(ppo.learner_tensors(ts), held))
        _assert_same_learner(ts, ref)
        assert losses.keys() == want.keys()
        assert all(torch.equal(losses[n], want[n]) for n in want)
    assert sgd.replays == 2 and sgd.info == {} and sgd.graph.graph is None
    with pytest.raises(ValueError, match="reads what it was made for"):
        sgd(_state(6), data, perms, ent, hp)


def test_env_step_makes_no_tensor_from_host_values(tmp_path, monkeypatch):
    """A duck env step (physics stubbed) builds no tensor from host values
    (torch.tensor / torch.as_tensor): on the card each is a pageable copy
    and a host wait; the gravity direction and the up axis are made once
    with the env."""
    from open_duck_playground_tpu_torch.envs import randomize
    from open_duck_playground_tpu_torch.envs.joystick import Joystick

    monkeypatch.setenv("OPEN_DUCK_ASSETS", write_standin(str(tmp_path / "standin")))
    env = Joystick("flat_terrain", device="cpu")
    te = TrainEnv(env, num_envs=2, episode_length=1000,
                  randomization_fn=randomize.domain_randomize,
                  randomization_generator=torch.Generator().manual_seed(0))
    state = te.reset(torch.Generator().manual_seed(1))
    monkeypatch.setattr(env, "physics_step", lambda model, data, ctrl: data)
    made = []

    def spy(name):
        fn = getattr(torch, name)

        def spied(*a, **k):
            made.append(name)
            return fn(*a, **k)
        return spied

    for name in ("tensor", "as_tensor"):
        monkeypatch.setattr(torch, name, spy(name))
    for _ in range(2):
        state = te.step(state, torch.zeros(2, env.action_size))
    assert made == []
    assert all(bool(torch.isfinite(v).all()) for v in state.obs.values())
