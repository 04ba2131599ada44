"""The port's trainer against the JAX package's, module by module, on the
same numpy inputs from a seed, parameters carried across with interop.

- GAE, the networks and the distribution (with injected noise), the
  running statistics, the loss value and its gradients, clipped Adam;
- the lecun-uniform init's statistics;
- one whole training step on the ToyEnv of tests/test_resume.py against a
  line-for-line JAX rebuild of ppo.py:240-320, with the policy noise, the
  permutations and the entropy noise drawn on the JAX side;
- observation_size per task, equal to the JAX env's;
- a CPU smoke of ppo.train on the duck, and that the trainer and the runner
  raise without CUDA unless given the CPU.

The JAX loss, rollout and SGD step are closures inside ppo.train there, so
they are rebuilt here from the package's public nets.* and compute_gae.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from open_duck_playground_tpu.envs.joystick import Joystick as JaxJoystick
from open_duck_playground_tpu.envs.wrapper import TrainEnv as JaxTrainEnv
from open_duck_playground_tpu.train import networks as jnets
from open_duck_playground_tpu.train.ppo import compute_gae as jax_gae
from open_duck_playground_tpu_torch import interop
from open_duck_playground_tpu_torch.envs.joystick import Joystick
from open_duck_playground_tpu_torch.envs.types import State
from open_duck_playground_tpu_torch.envs.wrapper import TrainEnv
from open_duck_playground_tpu_torch.train import networks as nets
from open_duck_playground_tpu_torch.train import optim, ppo
from open_duck_playground_tpu_torch.train import runner as rn
from tests.test_resume import ToyEnv as JaxToyEnv
from tests.torch_helpers import TorchToyEnv, numpy_tree, standin_assets

pytest_plugins = ["tests.torch_lock"]  # never beside tests/test_resume.py (see there)

OBS = {"state": 101, "privileged_state": 212}
ACT = 14


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    with standin_assets(str(tmp_path_factory.mktemp("standin"))) as r:
        yield r


def _t(x):
    return torch.as_tensor(np.array(x))


def _jax_full_params(seed, obs_sizes=OBS, act=ACT, hidden=(512, 256, 128)):
    """A JAX (normalizer, params) with non-trivial statistics, and the same
    carried across to the port."""
    network = jnets.PPONetworks(obs_sizes, act, hidden, hidden)
    params = network.init(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    normalizer = jnets.rs_update(jnets.rs_init(obs_sizes), {
        k: jnp.asarray(rng.randn(2, 32, n).astype(np.float32) * 2.0 + 0.5)
        for k, n in obs_sizes.items()})
    port = interop.ppo_params_from_numpy(numpy_tree(params))
    port_norm = interop.normalizer_from_numpy(numpy_tree(normalizer))
    return network, (normalizer, params), (port_norm, port)


def test_compute_gae_matches_jax():
    T, B = 20, 16
    rng = np.random.RandomState(0)
    rewards = rng.randn(T, B).astype(np.float32)
    values = rng.randn(T, B).astype(np.float32)
    bootstrap = rng.randn(B).astype(np.float32)
    termination = (rng.rand(T, B) < 0.1).astype(np.float32)
    truncation = (rng.rand(T, B) < 0.1).astype(np.float32) * (1 - termination)
    assert termination.any() and truncation.any()
    args = (truncation, termination, rewards, values, bootstrap)
    vs_j, adv_j = jax_gae(*map(jnp.asarray, args), lambda_=0.95, discount=0.97)
    vs_t, adv_t = ppo.compute_gae(*map(_t, args), lambda_=0.95, discount=0.97)
    np.testing.assert_allclose(vs_t.numpy(), np.asarray(vs_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(adv_t.numpy(), np.asarray(adv_j), rtol=1e-5, atol=1e-5)


def test_networks_and_distribution_match_jax():
    """policy_logits, value, dist_create, dist_log_prob and dist_entropy
    (injected noise) at full widths, 101 -> 512-256-128 -> 28 and 212 ->
    512-256-128 -> 1, on 64 obs: atol 1e-5."""
    network, (jn, jp), (tn, tp) = _jax_full_params(0)
    rng = np.random.RandomState(1)
    obs = {k: rng.randn(64, n).astype(np.float32) for k, n in OBS.items()}
    jobs = {k: jnp.asarray(v) for k, v in obs.items()}
    tobs = {k: _t(v) for k, v in obs.items()}
    with torch.no_grad():
        logits = tp.policy_logits(tn, tobs)
        value = tp.value_fn(tn, tobs)
        loc, scale = nets.dist_create(logits)
    jlogits = network.policy_logits(jp, jn, jobs)
    jloc, jscale = jnets.dist_create(jlogits)
    key = jax.random.PRNGKey(2)
    noise = np.asarray(jax.random.normal(key, jloc.shape))
    raw = loc + scale * _t(noise)
    pairs = {
        "logits": (logits, jlogits),
        "value": (value, network.value(jp, jn, jobs)),
        "loc": (loc, jloc),
        "scale": (scale, jscale),
        "log_prob": (nets.dist_log_prob(loc, scale, raw),
                     jnets.dist_log_prob(jloc, jscale, jloc + jscale * noise)),
        "entropy": (nets.dist_entropy(loc, scale, _t(noise)),
                    jnets.dist_entropy(jloc, jscale, key)),
    }
    assert value.shape == (64,) and logits.shape == (64, 2 * ACT)
    for name, (a, b) in pairs.items():
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5, err_msg=name)


def test_running_statistics_match_jax():
    """rs_update over 4 batches of [T, B, dim] on both keys: rtol 1e-5."""
    rng = np.random.RandomState(3)
    js, ts = jnets.rs_init(OBS), nets.rs_init(OBS)
    for _ in range(4):
        batch = {k: (rng.randn(20, 16, n) * 3.0 + 1.5).astype(np.float32)
                 for k, n in OBS.items()}
        js = jnets.rs_update(js, {k: jnp.asarray(v) for k, v in batch.items()})
        ts = nets.rs_update(ts, {k: _t(v) for k, v in batch.items()})
    assert float(ts.count) == float(js.count) == 4 * 20 * 16
    for f in ("mean", "summed_variance", "std"):
        for k in OBS:
            np.testing.assert_allclose(getattr(ts, f)[k].numpy(), np.asarray(getattr(js, f)[k]),
                                       rtol=1e-5, err_msg=f"{f}/{k}")
    x = {k: _t(rng.randn(5, n).astype(np.float32)) for k, n in OBS.items()}
    jx = jnets.rs_normalize(js, {k: jnp.asarray(v.numpy()) for k, v in x.items()})
    for k, v in nets.rs_normalize(ts, x).items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jx[k]), rtol=1e-5, atol=1e-5)


def _hyper(**kw) -> ppo.Hyper:
    """ppo.Hyper with `kw` and, for the rest, ppo.train's defaults."""
    defaults = inspect.signature(ppo.train).parameters
    return ppo.Hyper(**{f.name: kw.get(f.name, defaults[f.name].default)
                        for f in dataclasses.fields(ppo.Hyper)})


HP = dict(entropy_cost=5e-3, discounting=0.97, gae_lambda=0.95, clipping_epsilon=0.2,
          normalize_advantage=True, reward_scaling=1.0)


def _jax_loss(network):
    """ppo.py:196-233, line for line, with the entropy noise's key as rng."""

    def loss_fn(params, normalizer, data, rng):
        logits = network.policy_logits(params, normalizer, data["observation"])
        loc, scale = jnets.dist_create(logits)
        baseline = network.value(params, normalizer, data["observation"])
        terminal_obs = jax.tree_util.tree_map(lambda x: x[-1], data["next_observation"])
        bootstrap_value = network.value(params, normalizer, terminal_obs)

        rewards = data["reward"] * HP["reward_scaling"]
        truncation = data["truncation"]
        termination = (1 - data["discount"]) * (1 - truncation)

        target_lp = jnets.dist_log_prob(loc, scale, data["raw_action"])
        rho = jnp.exp(target_lp - data["log_prob"])

        vs, advantages = jax_gae(truncation, termination, rewards, baseline, bootstrap_value,
                                 lambda_=HP["gae_lambda"], discount=HP["discounting"])
        advantages = (advantages - advantages.mean()) / (advantages.std() + 1e-8)

        eps = HP["clipping_epsilon"]
        surrogate1 = rho * advantages
        surrogate2 = jnp.clip(rho, 1 - eps, 1 + eps) * advantages
        policy_loss = -jnp.mean(jnp.minimum(surrogate1, surrogate2))

        v_error = vs - baseline
        v_loss = jnp.mean(v_error * v_error) * 0.5 * 0.5

        entropy = jnp.mean(jnets.dist_entropy(loc, scale, rng))
        entropy_loss = -HP["entropy_cost"] * entropy

        total = policy_loss + v_loss + entropy_loss
        return total, {"total_loss": total, "policy_loss": policy_loss,
                       "v_loss": v_loss, "entropy_loss": entropy_loss}

    return loss_fn


def _transition(data, device="cpu"):
    return ppo.Transition(**{
        k: ({kk: _t(vv).to(device) for kk, vv in v.items()} if isinstance(v, dict)
            else _t(v).to(device))
        for k, v in data.items()})


def test_loss_and_grads_match_jax():
    """The loss terms to rtol 1e-5; each gradient leaf to max|d| <=
    1e-5 max|g| + 1e-7, at full widths on a [20, 32] minibatch."""
    network, (jn, jp), (tn, tp) = _jax_full_params(4)
    T, b = 20, 32
    rng = np.random.RandomState(5)
    obs = {k: rng.randn(T, b, n).astype(np.float32) for k, n in OBS.items()}
    jloc, jscale = jnets.dist_create(network.policy_logits(
        jp, jn, {k: jnp.asarray(v) for k, v in obs.items()}))
    raw = np.asarray(jloc + jscale * rng.randn(T, b, ACT).astype(np.float32))
    # behaviour log-probs near the target's, so some ratios leave the clip band
    log_prob = np.asarray(jnets.dist_log_prob(jloc, jscale, raw)) + (
        rng.randn(T, b) * 0.3).astype(np.float32)
    done = (rng.rand(T, b) < 0.1).astype(np.float32)
    data = dict(
        observation=obs,
        action=np.tanh(raw),
        reward=rng.randn(T, b).astype(np.float32),
        discount=1.0 - done,
        next_observation={k: rng.randn(T, b, n).astype(np.float32) for k, n in OBS.items()},
        truncation=done * (rng.rand(T, b) < 0.5).astype(np.float32),
        raw_action=raw,
        log_prob=log_prob,
    )
    key = jax.random.PRNGKey(6)
    noise = np.asarray(jax.random.normal(key, (T, b, ACT)))

    (_, jaux), jgrads = jax.value_and_grad(_jax_loss(network), has_aux=True)(
        jp, jn, jax.tree_util.tree_map(jnp.asarray, data), key)
    hp = _hyper(**HP)
    total, aux = ppo.loss_fn(tp, tn, _transition(data), _t(noise), hp)
    grads = torch.autograd.grad(total, list(tp.parameters()))

    rho = np.exp(np.asarray(jnets.dist_log_prob(jloc, jscale, raw)) - log_prob)
    assert ((rho < 0.8) | (rho > 1.2)).mean() > 0.1
    for k, v in aux.items():
        np.testing.assert_allclose(float(v), float(jaux[k]), rtol=1e-5, err_msg=k)
    jg = numpy_tree(jgrads)
    for (path, _), g in zip(interop.brax_paths(tp), grads):
        ref = jg
        for p in path:
            ref = ref[p]
        got = g.numpy().T if path[-1] == "kernel" else g.numpy()
        bound = 1e-5 * np.abs(ref).max() + 1e-7
        assert np.abs(got - ref).max() <= bound, ("/".join(path), np.abs(got - ref).max(), bound)


def test_clipped_adam_matches_optax():
    """The same grads through optax.chain(clip_by_global_norm(1.0),
    adam(3e-4)) and the port for 3 steps, the first and last above the clip,
    the second below: params, mu and nu to rtol 1e-6, atol 1e-9."""
    _, (_, jp), (_, tp) = _jax_full_params(7)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(3e-4))
    jstate = tx.init(jp)
    params = list(tp.parameters())
    tstate = optim.adam_init(params)
    rng = np.random.RandomState(8)
    for norm in (25.0, 0.5, 3.0):
        gtree = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.randn(*x.shape).astype(np.float32)), jp)
        scale = norm / float(optax.global_norm(gtree))
        gtree = jax.tree_util.tree_map(lambda x: x * scale, gtree)
        assert (float(optax.global_norm(gtree)) > 1.0) == (norm > 1.0)
        updates, jstate = tx.update(gtree, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        grads = interop.adam_state_from_numpy(
            {"count": 0, "mu": numpy_tree(gtree), "nu": numpy_tree(gtree)}, tp).mu
        grads = optim.clip_by_global_norm(grads, 1.0)
        tstate = optim.adam(params, grads, tstate, 3e-4)

        adam = jstate[1][0]
        got = interop.adam_state_to_numpy(tstate, tp)
        assert int(got["count"]) == int(adam.count)
        for name, a, b in (("params", interop.ppo_params_to_numpy(tp), numpy_tree(jp)),
                           ("mu", got["mu"], numpy_tree(adam.mu)),
                           ("nu", got["nu"], numpy_tree(adam.nu))):
            for (path, _) in interop.brax_paths(tp):
                x, y = a, b
                for p in path:
                    x, y = x[p], y[p]
                np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-9,
                                           err_msg=f"{name}/{'/'.join(path)}")


def test_lecun_init_statistics():
    """Kernels within +-sqrt(3/fan_in), the 512x256 kernel's variance within
    5% of 1/fan_in, biases zero; the same generator seed gives the same
    parameters."""
    make = lambda s: nets.PPONetworks(OBS, ACT, generator=torch.Generator().manual_seed(s))  # noqa: E731
    a, b = make(0), make(0)
    for (path, p), q in zip(interop.brax_paths(a), b.parameters()):
        assert torch.equal(p, q)
        if path[-1] == "bias":
            assert not p.any()
            continue
        fan_in = p.shape[1]
        assert float(p.detach().abs().max()) <= np.sqrt(3.0 / fan_in)
        if p.shape == (256, 512):
            assert abs(float(p.detach().var()) * fan_in - 1.0) < 0.05
    assert not torch.equal(make(1).policy.hidden_0.weight, a.policy.hidden_0.weight)


# ---------------------------------------------------------------------------
# one training step on the ToyEnv against a JAX rebuild of ppo.py:240-320
# ---------------------------------------------------------------------------

STEP = dict(num_envs=8, unroll_length=4, num_minibatches=2, batch_size=4,
            num_updates_per_batch=2, learning_rate=3e-4, max_grad_norm=1.0, **HP)
TOY_OBS = {"state": 6, "privileged_state": 8}


def _jax_training_step(network, train_env, tx):
    """ppo.py:240-320 with its draws made as there, returned beside the
    results so the port can take the same."""
    T, N = STEP["unroll_length"], STEP["num_envs"]
    nmb, bs = STEP["num_minibatches"], STEP["batch_size"]
    grad_fn = jax.value_and_grad(_jax_loss(network), has_aux=True)

    def rollout(env_state, full_params, key):
        normalizer, params = full_params

        def step_fn(carry, _):
            state, key = carry
            key, k = jax.random.split(key)
            loc, scale = jnets.dist_create(network.policy_logits(params, normalizer, state.obs))
            noise = jax.random.normal(k, loc.shape)
            raw = loc + scale * noise
            action = jnp.tanh(raw)
            nstate = train_env.step(state, action)
            t = dict(observation=state.obs, action=action, reward=nstate.reward,
                     discount=1.0 - nstate.done, next_observation=nstate.obs,
                     truncation=nstate.info["truncation"], raw_action=raw,
                     log_prob=jnets.dist_log_prob(loc, scale, raw))
            return (nstate, key), (t, noise)

        (env_state, _), (data, noise) = jax.lax.scan(step_fn, (env_state, key), None, length=T)
        return env_state, data, noise

    def sgd_step(params, normalizer, opt_state, data, key):
        normalizer = jnets.rs_update(normalizer, data["observation"])

        def minibatch_step(carry, mb_data):
            params, opt_state, key = carry
            key, k = jax.random.split(key)
            (_, aux), grads = grad_fn(params, normalizer, mb_data, k)
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            noise = jax.random.normal(k, mb_data["raw_action"].shape)
            return (params, opt_state, key), (aux, noise)

        def epoch(carry, _):
            params, opt_state, key = carry
            key, kperm, kmb = jax.random.split(key, 3)
            perm = jax.random.permutation(kperm, N)
            shuf = jax.tree_util.tree_map(lambda x: jnp.take(x, perm, axis=1), data)
            mb = jax.tree_util.tree_map(
                lambda x: x.reshape((x.shape[0], nmb, bs) + x.shape[2:]).swapaxes(0, 1), shuf)
            (params, opt_state, _), (aux, noise) = jax.lax.scan(
                minibatch_step, (params, opt_state, kmb), mb)
            return (params, opt_state, key), (aux, perm, noise)

        (params, opt_state, _), (aux, perms, noise) = jax.lax.scan(
            epoch, (params, opt_state, key), None, length=STEP["num_updates_per_batch"])
        return params, normalizer, opt_state, aux, perms, noise

    @jax.jit
    def training_step(params, normalizer, opt_state, env_state, key):
        key, k_roll, k_sgd = jax.random.split(key, 3)
        env_state, data, noise = rollout(env_state, (normalizer, params), k_roll)
        params, normalizer, opt_state, aux, perms, ent = sgd_step(
            params, normalizer, opt_state, data, k_sgd)
        metrics = jax.tree_util.tree_map(jnp.mean, aux)
        return params, normalizer, opt_state, env_state, data, metrics, (noise, perms, ent)

    return training_step


def _toy_state(tree) -> State:
    """A JAX TrainEnv state of the ToyEnv, as numpy, into the port's State."""
    info = {k: _t(v) for k, v in tree["info"].items() if k not in ("rng", "first_data", "first_obs")}
    info["first_data"] = _t(tree["info"]["first_data"])
    info["first_obs"] = {k: _t(v) for k, v in tree["info"]["first_obs"].items()}
    return State(data=_t(tree["data"]), obs={k: _t(v) for k, v in tree["obs"].items()},
                 reward=_t(tree["reward"]), done=_t(tree["done"]),
                 metrics={k: _t(v) for k, v in tree["metrics"].items()}, info=info)


def test_training_step_matches_jax_rebuild():
    """Transitions and the normalizer to atol 1e-6; the params after the
    step to q99 |d| <= 1e-6 and max |d| <= 2 lr (Adam steps): an Adam step
    moves each parameter by up to ~lr, and a near-zero gradient can flip
    its sign on last-bit differences."""
    network = jnets.PPONetworks(TOY_OBS, 3, (32, 32), (32, 32))
    jp = network.init(jax.random.PRNGKey(9))
    jn = jnets.rs_init(TOY_OBS)
    tx = optax.chain(optax.clip_by_global_norm(STEP["max_grad_norm"]),
                     optax.adam(STEP["learning_rate"]))
    jenv = JaxTrainEnv(JaxToyEnv(), num_envs=STEP["num_envs"], episode_length=6)
    env_state = jax.jit(jenv.reset)(jax.random.PRNGKey(10))
    # a few steps in, so that some envs carry truncation and autoreset
    for _ in range(4):
        env_state = jax.jit(jenv.step)(env_state, jnp.zeros((STEP["num_envs"], 3)))
    start = numpy_tree(env_state)
    jp2, jn2, jopt2, jenv2, jdata, jmetrics, (noise, perms, ent) = _jax_training_step(
        network, jenv, tx)(jp, jn, tx.init(jp), env_state, jax.random.PRNGKey(11))

    tp = interop.ppo_params_from_numpy(numpy_tree(jp))
    ts = ppo.TrainingState(params=tp, normalizer=interop.normalizer_from_numpy(numpy_tree(jn)),
                           opt_state=optim.adam_init(list(tp.parameters())),
                           env_steps=torch.zeros((), dtype=torch.int64))
    tenv = TrainEnv(TorchToyEnv(), num_envs=STEP["num_envs"], episode_length=6)
    hp = _hyper(**STEP)
    draws = (_t(noise), _t(perms).long(), _t(ent))
    state = _toy_state(start)
    env_after, data = ppo.rollout(tenv, state, ts.normalizer, tp, draws[0])
    ts2, _, metrics = ppo.training_step(ts, tenv, state, draws, hp)

    jd = numpy_tree(jdata)
    assert float(jd["truncation"].sum()) > 0
    for f in ("action", "reward", "discount", "truncation", "raw_action", "log_prob"):
        np.testing.assert_allclose(getattr(data, f).numpy(), jd[f], rtol=0, atol=1e-6, err_msg=f)
    for f in ("observation", "next_observation"):
        for k in TOY_OBS:
            np.testing.assert_allclose(getattr(data, f)[k].numpy(), jd[f][k], rtol=0, atol=1e-6)
    np.testing.assert_allclose(env_after.obs["state"].numpy(), np.asarray(jenv2.obs["state"]),
                               atol=1e-6)
    norm = interop.normalizer_to_numpy(ts2.normalizer)
    jnorm = numpy_tree(jn2)
    assert float(norm["count"]) == float(jnorm["count"]) == 32
    for f in ("mean", "summed_variance", "std"):
        for k in TOY_OBS:
            np.testing.assert_allclose(norm[f][k], jnorm[f][k], rtol=0, atol=1e-6)
    adam_steps = STEP["num_updates_per_batch"] * STEP["num_minibatches"]
    assert int(ts2.opt_state.count) == adam_steps
    assert int(ts2.env_steps) == hp.env_steps_per_training_step
    d = np.concatenate([
        np.abs(interop.ppo_params_to_numpy(tp)[n]["params"][l][w] - numpy_tree(jp2)[n]["params"][l][w]).ravel()
        for n in ("policy", "value") for l in ("hidden_0", "hidden_1", "hidden_2")
        for w in ("kernel", "bias")])
    assert np.quantile(d, 0.99) <= 1e-6 and d.max() <= 2 * STEP["learning_rate"] * adam_steps, (
        np.quantile(d, 0.99), d.max())
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), float(jmetrics[k]), rtol=1e-3, atol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# the duck
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("task", ["flat_terrain", "flat_terrain_backlash"])
def test_observation_size_matches_jax(root, task):
    want = {"state": (101,), "privileged_state": (212,)}
    assert dict(JaxJoystick(task).observation_size) == want
    env = Joystick(task, device="cpu")
    before = env.generator.get_state()
    assert env.observation_size == want
    assert TrainEnv(env, num_envs=2, episode_length=10).observation_size == want
    assert torch.equal(env.generator.get_state(), before)  # its own stream untouched


def test_ppo_train_smoke_on_the_duck(root):
    """ppo.train on Joystick("flat_terrain", device="cpu"): 4 envs, unroll
    2, 2 x 2 minibatches, 2 evals of 2 envs over 4 steps, widths (32,)."""
    env, eval_env = Joystick("flat_terrain", device="cpu"), Joystick("flat_terrain", device="cpu")
    saved, reports = [], []
    _, (normalizer, params), metrics = ppo.train(
        env, eval_env, num_timesteps=8, episode_length=4, num_envs=4, num_eval_envs=2,
        unroll_length=2, num_minibatches=2, batch_size=2, num_updates_per_batch=2,
        num_evals=2, network_factory={"policy_hidden_layer_sizes": (32,),
                                      "value_hidden_layer_sizes": (32,)},
        progress_fn=lambda s, m: reports.append((s, dict(m))),
        policy_params_fn=lambda s, make_policy, p: saved.append(s))
    assert saved == [0, 8] and [s for s, _ in reports] == [0, 8]
    assert float(normalizer.count) == 8
    assert params.policy.sizes == [101, 32, 28] and params.value.sizes == [212, 32, 1]
    assert {"training/total_loss", "training/sps", "eval/episode_reward",
            "eval/avg_episode_length", "eval/episode_reward/alive"} <= set(metrics)
    for _, m in reports:
        assert all(np.isfinite(v) for v in m.values()), m


def test_trainer_needs_the_card_unless_given_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    kw = dict(num_timesteps=64, episode_length=4, num_envs=4, num_eval_envs=2,
              unroll_length=2, num_minibatches=2, batch_size=2, num_updates_per_batch=1,
              num_evals=2, network_factory={"policy_hidden_layer_sizes": (8,),
                                            "value_hidden_layer_sizes": (8,)})
    with pytest.raises(RuntimeError, match="CUDA"):
        ppo.train(TorchToyEnv(), **kw, device="cuda")
    with pytest.raises(RuntimeError, match="--device cpu"):
        rn.OpenDuckMiniV2Runner(rn.build_parser().parse_args(["--output_dir", str(tmp_path)]))
    _, (normalizer, _), _ = ppo.train(TorchToyEnv(), **kw, device="cpu")
    assert float(normalizer.count) == 64


def test_runner_builds_the_standing_env(root, tmp_path):
    """--env standing --device cpu: the runner's table picks Standing for
    the train and eval envs (obs 85, actions 14); the gait-clock flags and
    their ONNX metadata are Joystick's alone."""
    from open_duck_playground_tpu_torch.envs.standing import Standing

    runner = rn.OpenDuckMiniV2Runner(rn.build_parser().parse_args(
        ["--output_dir", str(tmp_path), "--env", "standing", "--task", "flat_terrain_backlash",
         "--device", "cpu", "--phase_freq_vx_ref", "0.094"]))
    assert isinstance(runner.env, Standing) and isinstance(runner.eval_env, Standing)
    assert runner.obs_size == 85 and runner.action_size == 14
    assert runner.env.observation_size == {"state": (85,), "privileged_state": (153,)}
    assert runner.deploy_metadata is None
    with pytest.raises(ValueError, match="Unknown env"):
        rn.OpenDuckMiniV2Runner(rn.build_parser().parse_args(
            ["--output_dir", str(tmp_path), "--env", "walking", "--device", "cpu"]))
