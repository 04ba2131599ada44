"""The fused CUDA kernel on the card, against its plain PyTorch version.

Every test here is marked `cuda` and skips without a CUDA device: the kernel
has no CPU mode. This file imports no jax, so it runs on a machine without
it; there, skip the repo's conftest (which sets JAX up):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import os

import pytest
import torch

import duck_standin  # tests/ is on sys.path (rootless test dir)
from open_duck_playground_tpu_torch.envs import randomize
from open_duck_playground_tpu_torch.envs.joystick import Joystick
from open_duck_playground_tpu_torch.envs.wrapper import TrainEnv
from open_duck_playground_tpu_torch.mjcf import compile_mjcf
from open_duck_playground_tpu_torch.ops.cuda_step import (
    PROFILE_STAGES,
    FusedPhysics,
    flatten_dr_fields,
)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = duck_standin.write_standin(str(tmp_path_factory.mktemp("standin")))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OPEN_DUCK_ASSETS", root)
        yield root


def _settled(m, n, dev, seed=0):
    return tuple(torch.from_numpy(x).to(dev) for x in duck_standin.settled_states(
        m.keyframe("home"), m.nq, m.nv, m.nu, n, seed=seed))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [("flat_terrain", 1024, False), ("flat_terrain", 1024, True),
                                  ("flat_terrain_backlash", 1024, True),
                                  ("rough_terrain_backlash", 1024, False),
                                  ("rough_terrain_backlash", 1024, True)])
def test_kernel_matches_twin(card, root, case):
    """chip_smoke.py's phase 2 at 1024 envs: all outputs of both variants
    within duck_standin.PARITY_LIMITS (ROUGH_PARITY_LIMITS on the rough
    scene, through the kernel's heightfield branch; quantiles per output and
    per column; see there for their origin)."""
    import chip_smoke  # the repo root is on sys.path under `python -m pytest`

    report = {}
    ok = chip_smoke.phase_kernel_vs_twin([case], report)
    assert ok, {tag: {f: r for f, r in rs.items() if not r["ok"]} for tag, rs in report.items()}


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit, a NaN matching a NaN."""
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0))


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["flat_terrain", "rough_terrain_backlash"])
@pytest.mark.parametrize("B", [1, 33, 1000])
def test_kernel_bit_exact_with_dr_at_ragged_env_counts(card, root, task, B):
    """With DR on, every output of the step and init variants equals the
    twin's bit for bit, at env counts that leave the last block of warps
    part empty (one env per warp, two or more per block)."""
    m = compile_mjcf(os.path.join(root, "xmls", f"scene_{task}.xml"), timestep=0.002)
    fp = FusedPhysics(m)
    assert fp.geometry(B, card)["envs_per_block"] > 1
    qpos, qvel, ctrl = _settled(m, B, card, seed=B)
    warm = torch.zeros_like(qvel)
    dr = flatten_dr_fields(randomize.domain_randomize(
        m.to(card), B, torch.Generator(device=card).manual_seed(3)))
    for n in (10, 1):
        out_k = fp(qpos, qvel, warm, ctrl, n, dr)
        out_p = fp.plain(qpos, qvel, warm, ctrl, n, dr)
        for f, v in out_k.items():
            assert _same(v, out_p[f]), (f, n, float((v - out_p[f]).abs().max()))
    assert fp.launches == 2


@pytest.mark.cuda
def test_stage_profile_counts_every_stage(card, root):
    """The stage-counting build (-DDUCK_PROFILE) computes the same outputs
    and counts clock cycles in every stage."""
    m = compile_mjcf(os.path.join(root, "xmls", "scene_flat_terrain.xml"), timestep=0.002)
    fp, fq = FusedPhysics(m, profile=True), FusedPhysics(m)
    qpos, qvel, ctrl = _settled(m, 64, card)
    warm = torch.zeros_like(qvel)
    out_p = fp(qpos, qvel, warm, ctrl, 10)
    out_q = fq(qpos, qvel, warm, ctrl, 10)
    torch.cuda.synchronize()
    cyc = fp.stage_cycles()
    assert set(cyc) == set(PROFILE_STAGES) and all(v > 0 for v in cyc.values())
    for f, v in out_p.items():
        assert _same(v, out_q[f]), f
    with pytest.raises(RuntimeError, match="profile"):
        fq.stage_cycles()


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(card, root):
    m = compile_mjcf(os.path.join(root, "xmls", "scene_flat_terrain.xml"), timestep=0.002)
    fp = FusedPhysics(m)
    qpos, qvel, ctrl = _settled(m, 8, card)
    with pytest.raises(TypeError):
        fp(qpos.double(), qvel, qvel, ctrl, 1)
    with pytest.raises(ValueError):
        fp(qpos[:, :5], qvel, qvel, ctrl, 1)
    with pytest.raises(ValueError):
        fp(qpos.t().contiguous().t(), qvel, qvel, ctrl, 1)
    with pytest.raises(ValueError):
        fp(qpos, qvel.cpu(), qvel, ctrl, 1)
    assert fp.launches == 0


@pytest.mark.cuda
def test_env_path_runs_through_the_kernel(card, root):
    env = Joystick("flat_terrain", device=card)
    te = TrainEnv(env, num_envs=64, episode_length=1000,
                  randomization_fn=randomize.domain_randomize,
                  randomization_generator=torch.Generator(device=card).manual_seed(0))
    state = te.reset(torch.Generator(device=card).manual_seed(1))
    for _ in range(3):
        state = te.step(state, torch.zeros(64, env.action_size, device=card))
    assert env.physics.launches == 4
    assert state.obs["state"].shape == (64, 101)
    assert state.obs["privileged_state"].shape == (64, 212)
    for v in state.obs.values():
        assert torch.isfinite(v).all()
    # zero action: the duck stands
    assert float(state.done.max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["flat_terrain", "rough_terrain_backlash"])
def test_pipeline_env_path_never_launches_the_kernel(card, root, task):
    """physics="pipeline" on the card: the general pipeline steps the env
    (ops/forward.py, on the env's device), the kernel is never launched,
    and under zero action the duck stands."""
    env = Joystick(task, device=card, physics="pipeline")
    te = TrainEnv(env, num_envs=64, episode_length=1000,
                  randomization_fn=randomize.domain_randomize,
                  randomization_generator=torch.Generator(device=card).manual_seed(0))
    state = te.reset(torch.Generator(device=card).manual_seed(1))
    for _ in range(3):
        state = te.step(state, torch.zeros(64, env.action_size, device=card))
    assert env.physics.launches == 0
    assert state.data.qacc is not None and state.data.qacc.device.type == "cuda"
    for v in (*state.obs.values(), state.data.qpos):
        assert torch.isfinite(v).all()
    assert float(state.done.max()) == 0.0


@pytest.mark.cuda
def test_rough_env_path_runs_through_the_kernel(card, root):
    """The rough path on the card: one launch per reset and per step, and
    under zero action the duck stands on the terrain for 1 s (50 control
    steps) through the kernel's heightfield branch, both soles in contact."""
    env = Joystick("rough_terrain_backlash", device=card)
    te = TrainEnv(env, num_envs=64, episode_length=1000,
                  randomization_fn=randomize.domain_randomize,
                  randomization_generator=torch.Generator(device=card).manual_seed(0))
    state = te.reset(torch.Generator(device=card).manual_seed(1))
    done = torch.zeros(64, device=card)
    for _ in range(50):
        state = te.step(state, torch.zeros(64, env.action_size, device=card))
        done = torch.maximum(done, state.done)
    assert env.physics.launches == 51
    assert state.obs["state"].shape == (64, 101)
    assert state.obs["privileged_state"].shape == (64, 212)
    for v in (*state.obs.values(), state.data.qpos):
        assert torch.isfinite(v).all()
    assert float(done.max()) == 0.0
    m = env.model
    for p in range(m.npair):
        if int(m.pair_type[p]) == 1:  # HFIELD_HULL: the sole rests on the terrain
            assert float(state.data.contact.dist[:, 4 * p].max()) < 1e-3


@pytest.mark.cuda
def test_nan_action_terminates(card, root):
    """NaN action probe: done -> 1 within 3 control steps (the delay buffer
    may serve an older clean action first); the kernel clamps no NaN away."""
    env = Joystick("flat_terrain", device=card)
    te = TrainEnv(env, num_envs=4, episode_length=1000)
    state = te.reset(torch.Generator(device=card).manual_seed(0))
    nan = torch.full((4, env.action_size), float("nan"), device=card)
    done = torch.zeros(4, device=card)
    for _ in range(3):
        state = te.step(state, nan)
        done = torch.maximum(done, state.done)
    assert bool((done == 1).all())


@pytest.mark.cuda
def test_trainer_runs_through_the_kernel(card, root):
    """ppo.train on the card at the recipe's widths (batch 32 x 32
    minibatches = 1024 DR envs, unroll 20, 4 updates, (512, 256, 128)
    networks), one epoch of one training step and two evals of 128 envs
    over 100 steps: finite metrics, the counts, and one kernel launch per
    reset, per env step and per step of each capture's warm-up."""
    from open_duck_playground_tpu_torch.train import ppo

    env = Joystick("flat_terrain_backlash", device=card)
    eval_env = Joystick("flat_terrain_backlash", device=card)
    env.observation_size  # one reset at one env, before the count starts
    env.physics.launches = eval_env.physics.launches = 0
    reports = []
    _, (normalizer, params), metrics = ppo.train(
        env, eval_env, num_timesteps=1024 * 20, episode_length=100, num_envs=1024,
        num_eval_envs=128, unroll_length=20, num_minibatches=32, batch_size=32,
        num_updates_per_batch=4, num_evals=2, randomization_fn=randomize.domain_randomize,
        progress_fn=lambda step, m: reports.append((step, dict(m))))
    assert [s for s, _ in reports] == [0, 1024 * 20]
    for _, m in reports:
        assert all(torch.isfinite(torch.tensor(v)) for v in m.values()), m
    assert {k for k in metrics if k.startswith("training/")} >= {
        "training/total_loss", "training/policy_loss", "training/v_loss",
        "training/entropy_loss", "training/sps"}
    assert float(normalizer.count) == 1024 * 20
    assert params.policy.sizes == [101, 512, 256, 128, 28]
    assert params.value.sizes == [212, 512, 256, 128, 1]
    # the reset and the rollout, replayed as a graph whose capture's warm-up
    # stepped 20 times; each eval's reset and steps, and the eval capture's
    # warm-up step
    assert env.physics.launches == 1 + 20 + 20
    assert eval_env.physics.launches == 2 * (1 + 100) + 1


@pytest.mark.cuda
def test_deploy_engine_runs_through_the_kernel(card, root, tmp_path):
    """SimInfer on the card: a standing policy (seeded params) rolls 20 ticks
    at one env, one kernel launch for the init and one per tick, each at one
    row without DR; then the kernel against its twin from the last state,
    one tick, within duck_standin.DEPLOY_PARITY_LIMITS."""
    import chip_smoke  # the repo root is on sys.path under `python -m pytest`
    from open_duck_playground_tpu_torch.deploy.sim_infer import SimInfer
    from open_duck_playground_tpu_torch.export.export import export_onnx
    from open_duck_playground_tpu_torch.models.open_duck_mini_v2 import constants
    from open_duck_playground_tpu_torch.train import networks as nets

    obs_sizes = {"state": 85, "privileged_state": 153}
    network = nets.PPONetworks(obs_sizes, 14, generator=torch.Generator().manual_seed(0))
    onnx = export_onnx((nets.rs_init(obs_sizes), network), 14, None, 85,
                       output_path=str(tmp_path / "standing.onnx"))
    inf = SimInfer(constants.task_to_xml("flat_terrain_backlash"),
                   constants.reference_motion_path(), onnx, standing=True, device=card)
    inf.commands = [0.0, 0.0, 0.0, 0.2, 0.2, 0.5, 0.0]
    rows = []
    launch = inf.physics._launch
    inf.physics._launch = lambda qpos, *a: (rows.append((qpos.shape[0], a[-1] is None)),
                                            launch(qpos, *a))[1]
    for _ in range(20):
        inf.step_control(inf.control_step())
    assert inf.physics.launches == 1 + 20 and rows == [(1, True)] * 20
    assert all(o.shape == (85,) and bool((torch.from_numpy(o).isfinite()).all())
               for o in inf.saved_obs)
    d = inf.data
    ctrl = torch.tensor(inf.motor_targets, dtype=torch.float32, device=card)[None]
    fp = FusedPhysics(inf.model)
    accel = int(inf.model.sensor_adr[inf.model.sensor("accelerometer")])
    args = (d.qpos, d.qvel, d.qacc_warmstart, ctrl, 10, None)
    assert chip_smoke.parity_table("deploy B=1 step", fp(*args), fp.plain(*args), accel, "step",
                                   False, False, {}, duck_standin.DEPLOY_PARITY_LIMITS["step"])


@pytest.mark.cuda
def test_trace_sees_one_fused_launch_per_env_step(card, root, tmp_path):
    """utils.profiling.trace records the card's kernels: three annotated
    steps of a 64-env flat DR env hold one fused kernel launch each, tied to
    their step by chip_smoke's trace split."""
    import chip_smoke
    from open_duck_playground_tpu_torch.utils import profiling

    env = Joystick("flat_terrain", device=card, seed=0)
    te = TrainEnv(env, num_envs=64, episode_length=1000,
                  randomization_fn=randomize.domain_randomize,
                  randomization_generator=torch.Generator(device=card).manual_seed(0))
    state = te.reset(torch.Generator(device=card).manual_seed(1))
    state = te.step(state, torch.zeros(64, env.action_size, device=card))
    with profiling.trace(str(tmp_path), device=card):
        for _ in range(3):
            with profiling.annotate("env_step"):
                state = te.step(state, torch.zeros(64, env.action_size, device=card))
        torch.cuda.synchronize()
    split = chip_smoke.trace_split(chip_smoke.read_trace(str(tmp_path / "trace.json")),
                                   ("env_step",))
    assert split["env_step"]["fused_per_instance"] == [1, 1, 1]
    assert split["env_step"]["launches"] > 1 and split["_unattributed"] == 0
    assert split["env_step"]["waits"] == 0  # no host value made into a tensor per step


def _small_trainer_inputs(card, physics="kernel"):
    """A 64-env flat backlash DR env through the kernel (or `physics`) and
    train()'s init at (32, 16) networks, with hyperparameters for 4
    minibatches of 16, 2 updates, unroll 8."""
    import dataclasses
    import inspect

    from open_duck_playground_tpu_torch.train import ppo

    num_envs = 64
    kw = dict(num_envs=num_envs, unroll_length=8, num_minibatches=4, batch_size=16,
              num_updates_per_batch=2)
    defaults = inspect.signature(ppo.train).parameters
    hp = ppo.Hyper(**{f.name: kw.get(f.name, defaults[f.name].default)
                      for f in dataclasses.fields(ppo.Hyper)})
    gens = ppo.seeded_generators(0, card)
    env = Joystick("flat_terrain_backlash", device=card, physics=physics)
    te = TrainEnv(env, num_envs=num_envs, episode_length=1000,
                  randomization_fn=randomize.domain_randomize,
                  randomization_generator=gens["randomization"])
    nf = {"policy_hidden_layer_sizes": (32, 16), "value_hidden_layer_sizes": (32, 16)}
    obs_sizes = {k: v[0] for k, v in env.observation_size.items()}

    def init():
        return ppo.init_training_state(obs_sizes, env.action_size, nf,
                                       ppo.seeded_generators(0, card)["net"], card)

    return hp, gens, env, te, init


@pytest.mark.cuda
def test_captured_sgd_step_matches_eager_body(card, root):
    """ppo.SGDStepProgram against the eager ppo.sgd_step on the card, on the
    same rollouts and draws for 3 SGD steps: params, Adam state, normalizer
    and loss terms bit for bit, one replay per step. Then both states take a
    full state, are restored from it (into the captured buffers: the graph
    keeps them) and take one more step: still bit for bit."""
    from open_duck_playground_tpu_torch.train import ppo

    hp, gens, env, te, init = _small_trainer_inputs(card)
    eager, graphed = init(), init()
    cap = ppo.SGDStepProgram(graphed, hp)
    state = te.reset(gens["reset"])

    def step(state):
        noise, perms, ent = ppo.draw_training_step(gens["epoch"], hp, env.action_size, card)
        state, data = ppo.rollout(te, state, eager.normalizer, eager.params, noise)
        _, la = ppo.sgd_step(eager, data, perms, ent, hp)
        _, lb = cap(graphed, data, perms, ent, hp)
        for a, b in zip(ppo.learner_tensors(eager), ppo.learner_tensors(graphed)):
            assert torch.equal(a, b)
        assert all(torch.equal(la[k], lb[k]) for k in la)
        return state

    for _ in range(3):
        state = step(state)
    assert cap.replays == 3 and cap.info["pool_bytes"] > 0
    saved = ppo.full_state_to_numpy(ppo.full_state(eager, None, {}))
    for ts in (eager, graphed):
        ppo.restore_full_state(saved, ts, None, {})
    step(state)
    assert cap.replays == 4


@pytest.mark.cuda
def test_profile_breakdown_leaves_captured_training_untouched(card, root):
    """ppo.train on the card (64 flat backlash DR envs, one epoch of two
    training steps, no eval env) with and without profile_breakdown: the
    breakdown captures the graph and times its replays on throwaway draws,
    and the same seed gives bit-identical params and normalizer."""
    from open_duck_playground_tpu_torch import interop
    from open_duck_playground_tpu_torch.train import ppo

    def run(profile_breakdown):
        env = Joystick("flat_terrain_backlash", device=card)
        _, (normalizer, params), _ = ppo.train(
            env, None, num_timesteps=2 * 64 * 8, episode_length=100, num_envs=64,
            unroll_length=8, num_minibatches=4, batch_size=16, num_updates_per_batch=2,
            num_evals=2, randomization_fn=randomize.domain_randomize,
            network_factory={"policy_hidden_layer_sizes": (32, 16),
                             "value_hidden_layer_sizes": (32, 16)},
            profile_breakdown=profile_breakdown)
        return interop.normalizer_to_numpy(normalizer), list(params.parameters())

    norm_a, params_a = run(False)
    norm_b, params_b = run(True)
    assert "sgd_graph" in ppo.LAST_PROFILE_BREAKDOWN
    for f in ("mean", "summed_variance", "std"):
        for k in norm_a[f]:
            assert (norm_a[f][k] == norm_b[f][k]).all()
    assert norm_a["count"] == norm_b["count"] == 2 * 64 * 8
    assert all(torch.equal(a, b) for a, b in zip(params_a, params_b))


def _bitwise(a, b) -> bool:
    from open_duck_playground_tpu_torch.utils.graphs import tree_leaves

    ta, tb = tree_leaves(a), tree_leaves(b)
    bits = lambda x: x.reshape(-1).contiguous().view(torch.uint8)  # noqa: E731
    return ta.keys() == tb.keys() and all(
        x.dtype == tb[k].dtype and torch.equal(bits(x), bits(tb[k])) for k, x in ta.items())


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["flat_terrain", "rough_terrain_backlash"])
def test_captured_env_step_matches_eager(card, root, task):
    """wrapper.EnvStepProgram against TrainEnv.step on the card, 128 DR envs,
    episode_length 4, 7 steps from one reset and one env generator state,
    env 0 given a NaN action at step 1: every step's state bit for bit (NaN
    for NaN), the env generator's state after the run, one fused launch per
    replay. Then the generator and the state are set back and the replays
    repeat the run: a replay obeys set_state."""
    from open_duck_playground_tpu_torch.envs.wrapper import EnvStepProgram
    from open_duck_playground_tpu_torch.utils.graphs import clone_tree

    B = 128
    env = Joystick(task, device=card, seed=1)
    te = TrainEnv(env, num_envs=B, episode_length=4, randomization_fn=randomize.domain_randomize,
                  randomization_generator=torch.Generator(device=card).manual_seed(0))
    actions = torch.rand((7, B, env.action_size), generator=torch.Generator(device=card)
                         .manual_seed(2), device=card) * 2 - 1
    actions[1, 0] = float("nan")
    start = te.reset(torch.Generator(device=card).manual_seed(3))
    g0 = env.generator.get_state()
    eager, state = [], start
    for a in actions:
        state = te.step(state, a)
        eager.append(state)
    g_eager = env.generator.get_state()

    cap = EnvStepProgram(te)
    cap.capture(start, actions[0])
    for _ in range(2):
        env.generator.set_state(g0)
        n0 = env.physics.launches
        state = start
        for k, a in enumerate(actions):
            state = cap(state, a)
            assert _bitwise(state, eager[k]), k
        assert torch.equal(env.generator.get_state(), g_eager)
        assert env.physics.launches - n0 == len(actions)
    assert cap.replays == 2 * len(actions) and cap.graph.info["fused_launches_per_replay"] == 1
    assert bool(torch.isnan(eager[1].data.qpos[0]).any())
    assert _bitwise(clone_tree(start), start)


@pytest.mark.cuda
def test_captured_rollout_matches_eager(card, root):
    """ppo.RolloutProgram against ppo.rollout on the card (64 flat backlash
    DR envs, unroll 8, (32, 16) networks): 2 consecutive rollouts from one
    reset and one env generator state, the final states, the Transitions
    and the generator's state bit for bit; then a captured SGD step updates
    the policy in place and a third rollout of each still agrees."""
    from open_duck_playground_tpu_torch.train import ppo
    from open_duck_playground_tpu_torch.utils.graphs import clone_tree

    hp, gens, env, te, init = _small_trainer_inputs(card)
    ts = init()
    sgd = ppo.SGDStepProgram(ts, hp)
    roll = ppo.RolloutProgram(te, ts.normalizer, ts.params, hp)
    start = te.reset(gens["reset"])
    draws = [ppo.draw_training_step(gens["epoch"], hp, env.action_size, card) for _ in range(3)]
    g0 = env.generator.get_state()
    eager, state = [], start
    for noise, _, _ in draws[:2]:
        state, data = ppo.rollout(te, state, ts.normalizer, ts.params, noise)
        eager.append((state, data))
    g_eager = env.generator.get_state()
    env.generator.set_state(g0)
    state = start
    for k, (noise, _, _) in enumerate(draws[:2]):
        state, data = roll(te, state, ts.normalizer, ts.params, noise)
        assert _bitwise(state, eager[k][0]) and _bitwise(data, eager[k][1]), k
    assert torch.equal(env.generator.get_state(), g_eager)

    _, perms, ent = draws[2]
    sgd(ts, data, perms, ent, hp)
    g1, before = env.generator.get_state(), clone_tree(state)
    want = ppo.rollout(te, before, ts.normalizer, ts.params, draws[2][0])
    env.generator.set_state(g1)
    got = roll(te, state, ts.normalizer, ts.params, draws[2][0])
    assert _bitwise(got[0], want[0]) and _bitwise(got[1], want[1])
    # per env step one fused physics launch and the policy's 2 swishes
    assert roll.replays == 3 and roll.graph.info["launches_per_replay"] == {
        "fused_physics_step": hp.unroll_length, "duck_swish": 2 * hp.unroll_length}


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["flat_terrain", "rough_terrain_backlash"])
def test_captured_pipeline_env_step_matches_eager(card, root, task):
    """wrapper.EnvStepProgram on physics="pipeline" against TrainEnv.step on
    the card, 64 DR envs, episode_length 2, 3 steps from one reset and one
    env generator state (every env autoresets at step 2): every step's
    state bit for bit, the pipeline's Data and Contact fields included, the
    env generator's state after the run; the kernel is never launched."""
    from open_duck_playground_tpu_torch.envs.wrapper import EnvStepProgram

    B = 64
    env = Joystick(task, device=card, seed=1, physics="pipeline")
    te = TrainEnv(env, num_envs=B, episode_length=2, randomization_fn=randomize.domain_randomize,
                  randomization_generator=torch.Generator(device=card).manual_seed(0))
    actions = torch.rand((3, B, env.action_size), generator=torch.Generator(device=card)
                         .manual_seed(2), device=card) * 2 - 1
    start = te.reset(torch.Generator(device=card).manual_seed(3))
    g0 = env.generator.get_state()
    eager, state = [], start
    for a in actions:
        state = te.step(state, a)
        eager.append(state)
    g_eager = env.generator.get_state()

    cap = EnvStepProgram(te)
    cap.capture(start, actions[0])
    env.generator.set_state(g0)
    state = start
    for k, a in enumerate(actions):
        state = cap(state, a)
        assert _bitwise(state, eager[k]), k
    assert torch.equal(env.generator.get_state(), g_eager)
    assert state.data.contact.efc_valid is not None and bool((state.info["steps"] == 1).all())
    assert env.physics.launches == 0 and cap.replays == len(actions)
    assert cap.graph.info["fused_launches_per_replay"] == 0


@pytest.mark.cuda
def test_captured_pipeline_rollout_matches_eager(card, root):
    """ppo.RolloutProgram on physics="pipeline" (one env step per graph,
    replayed unroll_length times a call) against ppo.rollout on the card
    (64 flat backlash DR envs, unroll 8, (32, 16) networks): 2 consecutive
    rollouts from one reset and one env generator state, the final states,
    the Transitions and the generator's state bit for bit."""
    from open_duck_playground_tpu_torch.train import ppo

    hp, gens, env, te, init = _small_trainer_inputs(card, physics="pipeline")
    ts = init()
    roll = ppo.make_rollout(te, ts, hp)
    assert isinstance(roll, ppo.RolloutProgram) and roll.span == 1
    start = te.reset(gens["reset"])
    noises = [ppo.draw_training_step(gens["epoch"], hp, env.action_size, card)[0]
              for _ in range(2)]
    g0 = env.generator.get_state()
    eager, state = [], start
    for noise in noises:
        state, data = ppo.rollout(te, state, ts.normalizer, ts.params, noise)
        eager.append((state, data))
    g_eager = env.generator.get_state()
    env.generator.set_state(g0)
    state = start
    for k, noise in enumerate(noises):
        state, data = roll(te, state, ts.normalizer, ts.params, noise)
        assert _bitwise(state, eager[k][0]) and _bitwise(data, eager[k][1]), k
    assert torch.equal(env.generator.get_state(), g_eager)
    assert roll.replays == 2 * hp.unroll_length and env.physics.launches == 0
    assert roll.graph.info["env_steps_per_replay"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("deterministic", [False, True])
def test_captured_eval_matches_run_eval(card, root, deterministic):
    """ppo.run_eval through an EvalStepProgram against the eager eval_step on
    the card (64 flat backlash envs, DR off, 50 steps, episode_length 20 so
    that envs stop counting): every metric and both generators' states
    equal."""
    from open_duck_playground_tpu_torch.train import ppo

    hp, gens, env, te, init = _small_trainer_inputs(card)
    ts = init()
    eval_env = Joystick("flat_terrain_backlash", device=card)
    ete = TrainEnv(eval_env, num_envs=64, episode_length=20)
    g = torch.Generator(device=card)
    cap = ppo.EvalStepProgram(ete, ts.normalizer, ts.params, g, deterministic)
    runs = []
    for step in (ppo.eval_step, cap, cap):
        g.manual_seed(4)
        eval_env.generator.manual_seed(5)
        out = ppo.run_eval(ete, ts.normalizer, ts.params, g, episode_length=50,
                           deterministic=deterministic, step=step)
        runs.append(({k: float(v) for k, v in out.items()}, g.get_state(),
                     eval_env.generator.get_state()))
    for out, ga, gb in runs[1:]:
        assert out == runs[0][0]
        assert torch.equal(ga, runs[0][1]) and torch.equal(gb, runs[0][2])
    assert runs[0][0]["eval/avg_episode_length"] <= 20
    assert cap.replays == 100


@pytest.mark.cuda
def test_captured_programs_free_without_the_collector(card, root):
    """Each captured program, once captured and dropped, frees itself and
    its graph at once, with Python's cyclic collector off: a reference
    cycle would leave the graph to the collector, which may run while
    another graph captures, and destroying a graph then invalidates that
    capture."""
    import gc
    import weakref

    from open_duck_playground_tpu_torch.envs.wrapper import EnvStepProgram
    from open_duck_playground_tpu_torch.train import ppo

    hp, gens, env, te, init = _small_trainer_inputs(card)
    ts = init()
    state = te.reset(gens["reset"])
    noise, perms, ent = ppo.draw_training_step(gens["epoch"], hp, env.action_size, card)
    ete = TrainEnv(Joystick("flat_terrain_backlash", device=card), num_envs=16,
                   episode_length=10)
    g = torch.Generator(device=card).manual_seed(0)
    gc.collect()
    gc.disable()
    try:
        roll = ppo.RolloutProgram(te, ts.normalizer, ts.params, hp)
        _, data = roll(te, state, ts.normalizer, ts.params, noise)
        sgd = ppo.SGDStepProgram(ts, hp)
        sgd(ts, data, perms, ent, hp)
        step = EnvStepProgram(te)
        step(state, torch.zeros(hp.num_envs, env.action_size, device=card))
        ev = ppo.EvalStepProgram(ete, ts.normalizer, ts.params, g, False)
        ppo.run_eval(ete, ts.normalizer, ts.params, g, episode_length=2, step=ev)
        objs = (roll, roll.graph, sgd, sgd.graph, step, step.graph, ev, ev.graph)
        refs = [weakref.ref(o) for o in objs]
        del roll, sgd, step, ev, objs, data
        assert [r() is None for r in refs] == [True] * len(refs)
    finally:
        gc.enable()


@pytest.mark.cuda
def test_gait_playback_on_the_card_matches_the_cpu(card, root):
    from open_duck_playground_tpu_torch.deploy import ref_motion_viewer

    feet = [ref_motion_viewer.playback(periods=1, out=None, device=d) for d in (card, "cpu")]
    assert feet[0].shape == feet[1].shape
    assert abs(feet[0] - feet[1]).max() <= 1e-5


@pytest.mark.cuda
def test_sharded_step_replays_match_eager_at_world_2(card, root, tmp_path):
    """Two gloo ranks sharing the card, 64 flat backlash DR envs (32 per
    rank), unroll 4, 4 minibatches of 16, 2 epochs: two training steps
    through the captured rollout and the SGD segment chain equal the eager
    bodies' from the same init and global draws, bit for bit on each rank
    (Transitions, env state, params, Adam state, normalizer, loss terms,
    generators); one rollout replay per step with 4 fused launches, and
    each SGD step 2 * 2 + 3 * 8 = 28 collectives between 29 segments (56
    in the first captured step: its warm-up runs the body eagerly)."""
    from torch_dist_worker import run_ranks  # tests/ is on sys.path, as for duck_standin

    ranks = run_ranks("sharded_graph_vs_eager", tmp_path, "flat_terrain_backlash", 64, 3,
                      timeout_s=600, device="cuda")
    for r in ranks:
        assert r["kinds"] == ["RolloutProgram", "SGDStepProgram"]
        assert r["equal"] == [{p: True for p in ("data", "state", "learner", "losses",
                                                 "generators")}] * 2, r["equal"]
        assert r["want_collectives"] == 28
        # the graphs' first call adds its capture's eager warm-up, collectives included
        assert r["collectives"] == [[28, 28], [56, 28]]
        assert r["segments"] == 29 and r["replays"] == [2, 2] and r["fused_per_replay"] == 4


def _recipe_learner(dev, seed=0):
    """The recipe's 16 parameter tensors (both MLPs (512, 256, 128), obs 101
    and 212, 14 actions: 493,469 floats) and a fresh Adam state, on `dev`."""
    from open_duck_playground_tpu_torch.train import networks as nets
    from open_duck_playground_tpu_torch.train import optim

    net = nets.PPONetworks({"state": 101, "privileged_state": 212}, 14,
                           generator=torch.Generator().manual_seed(seed))
    params = [p.detach().to(dev) for p in net.parameters()]
    return params, optim.adam_init(params)


def _gradients(params, norm, gen, views=False):
    """Seeded gradients of global norm `norm`; with `views`, views into one
    flat buffer from a one-float offset, as the env-sharded step's sum over
    the ranks hands them over (most not 16-byte aligned)."""
    from open_duck_playground_tpu_torch.train import optim

    g = [torch.randn(p.shape, generator=gen).to(p.device) for p in params]
    g = [x * (norm / float(optim.global_norm(g))) for x in g]
    if not views:
        return g
    flat = torch.cat([g[0].new_zeros(1)] + [x.reshape(-1) for x in g])
    out, at = [], 1
    for x in g:
        out.append(flat[at:at + x.numel()].view_as(x))
        at += x.numel()
    return out


def _plain_step(params, grads, state, max_grad_norm):
    from open_duck_playground_tpu_torch.train import optim

    if max_grad_norm is not None:
        grads = optim.clip_by_global_norm(grads, max_grad_norm)
    optim.adam(params, grads, state, 3e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("max_grad_norm,views", [(1.0, False), (None, False), (1.0, True)])
def test_fused_clip_and_adam_equals_the_plain_functions(card, max_grad_norm, views):
    """optim.clip_and_adam on the card (the optimizer's kernel) against
    clip_by_global_norm + adam on the card, on the recipe's 16 shapes, 3
    steps with the clip taken on the first and last: params, count, mu and
    nu bit for bit, on the same tensor objects; the tracer counts 3 fused
    steps and no plain one."""
    from open_duck_playground_tpu_torch.train import optim
    from open_duck_playground_tpu_torch.utils import profiling

    params, state = _recipe_learner(card)
    ref_params, ref = [p.clone() for p in params], optim.clone_state(state)
    tensors = [*params, state.count, *state.mu, *state.nu]
    gen = torch.Generator().manual_seed(1)
    profiling.reset()
    for norm in (25.0, 0.5, 3.0):
        g = _gradients(params, norm, gen, views)
        assert optim.clip_and_adam(params, g, state, 3e-4, max_grad_norm) is state
        _plain_step(ref_params, g, ref, max_grad_norm)
    torch.cuda.synchronize()
    counters = profiling.summary()["counters"]
    assert counters["optim.fused_steps"] == 3 and counters["optim.plain_steps"] == 0
    assert all(a is b for a, b in zip([*params, state.count, *state.mu, *state.nu], tensors))
    for x, y in zip(tensors, [*ref_params, ref.count, *ref.mu, *ref.nu]):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("max_grad_norm", [1.0, None])
def test_fused_clip_and_adam_in_a_captured_graph(card, max_grad_norm):
    """The same step recorded as a CUDA graph (utils.graphs.GraphedBody, as
    the SGD step's body is) and replayed twice on new gradients copied into
    its inputs (the clip taken, then not), against the plain functions run
    eagerly: bit for bit after each replay. One fused step recorded per
    replay; the tracer counts the warm-up's and the two replays'; the
    graph holds at most 60 kernel and memcpy nodes (the plain functions
    record 347 at these shapes: 331 kernel and 16 memcpy nodes)."""
    from open_duck_playground_tpu_torch.ops import cuda_step
    from open_duck_playground_tpu_torch.train import optim
    from open_duck_playground_tpu_torch.utils import profiling
    from open_duck_playground_tpu_torch.utils.graphs import GraphedBody

    params, state = _recipe_learner(card)
    ref_params, ref = [p.clone() for p in params], optim.clone_state(state)
    tensors = [*params, state.count, *state.mu, *state.nu]
    static = [torch.zeros_like(p) for p in params]
    graphed = GraphedBody(lambda: optim.clip_and_adam(params, static, state, 3e-4, max_grad_norm),
                          tensors, device=card, kernels=[cuda_step.ADAM])
    gen = torch.Generator().manual_seed(2)
    profiling.reset()
    for norm in (25.0, 0.5):
        g = _gradients(params, norm, gen)
        for s, x in zip(static, g):
            s.copy_(x)
        graphed.replay()
        _plain_step(ref_params, g, ref, max_grad_norm)
        torch.cuda.synchronize()
        for x, y in zip(tensors, [*ref_params, ref.count, *ref.mu, *ref.nu]):
            assert torch.equal(x, y)
    assert profiling.summary()["counters"]["optim.fused_steps"] == 3
    assert graphed.info["fused_launches_per_replay"] == 1
    assert graphed.info["kernel_nodes"] + graphed.info["memcpy_nodes"] <= 60, graphed.info


def _gae_inputs(T, b, dev, seed):
    """ppo.gae's arguments for a minibatch as the rollout makes it, seeded:
    data's [T, b] reward, discount (1 - done) and truncation (done envs
    only), the [T, b] baseline and [b] bootstrap value; ends of both kinds
    mixed (~20% done, half of them truncated) and a NaN reward at (T // 2,
    b // 3)."""
    from open_duck_playground_tpu_torch.train import ppo

    gen = torch.Generator().manual_seed(seed)
    reward = torch.randn(T, b, generator=gen) * 3
    done = (torch.rand(T, b, generator=gen) < 0.2).float()
    truncation = (torch.rand(T, b, generator=gen) < 0.5).float() * done
    reward[T // 2, b // 3] = float("nan")
    data = ppo.Transition(observation=None, action=None, reward=reward.to(dev),
                          discount=(1 - done).to(dev), next_observation=None,
                          truncation=truncation.to(dev), raw_action=None, log_prob=None)
    return {"data": data, "baseline": (torch.randn(T, b, generator=gen) * 5).to(dev),
            "bootstrap_value": (torch.randn(b, generator=gen) * 5).to(dev)}


def _plain_gae(data, baseline, bootstrap_value, hp):
    """compute_gae on loss_points' inputs, as the CPU's path runs it."""
    from open_duck_playground_tpu_torch.train import ppo

    termination = (1 - data.discount) * (1 - data.truncation)
    return ppo.compute_gae(data.truncation, termination, data.reward * hp.reward_scaling,
                           baseline, bootstrap_value, lambda_=hp.gae_lambda,
                           discount=hp.discounting)


def _same_gae(got, want, b):
    """vs and advantages equal bit for bit, the NaN in column b // 3 alone."""
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               and torch.isnan(x).any(0).nonzero().flatten().tolist() == [b // 3]
               for x, y in zip(got, want))


GAE_SHAPES = [(20, 256), (5, 17)]  # the recipe's unroll x batch, and an unaligned one


@pytest.mark.cuda
@pytest.mark.parametrize("T,b", GAE_SHAPES)
@pytest.mark.parametrize("reward_scaling", [1.0, 0.37])
def test_gae_kernel_equals_compute_gae(card, T, b, reward_scaling):
    """ppo.gae on the card (one launch of the GAE kernel) against the plain
    compute_gae on the same CUDA tensors: vs and advantages bit for bit,
    the NaN kept in its column; the tracer counts one fused step and no
    plain one."""
    import types

    from open_duck_playground_tpu_torch.train import ppo
    from open_duck_playground_tpu_torch.utils import profiling

    hp = types.SimpleNamespace(reward_scaling=reward_scaling, discounting=0.97, gae_lambda=0.95)
    inputs = _gae_inputs(T, b, card, seed=T + b)
    profiling.reset()
    got = ppo.gae(**inputs, hp=hp)
    want = _plain_gae(**inputs, hp=hp)
    torch.cuda.synchronize()
    counters = profiling.summary()["counters"]
    assert counters["gae.fused_steps"] == 1 and counters["gae.plain_steps"] == 0
    assert _same_gae(got, want, b)


@pytest.mark.cuda
@pytest.mark.parametrize("T,b", GAE_SHAPES)
def test_gae_kernel_in_a_captured_graph(card, T, b):
    """ppo.gae recorded as a CUDA graph (utils.graphs.GraphedBody, as the SGD
    step's body is), its outputs in the graph's pool, replayed on two new
    minibatches copied into its inputs, against compute_gae run eagerly:
    bit for bit after each replay. The graph is the kernel's one node; one
    fused step recorded per replay, the warm-up's and the replays' counted."""
    import types

    from open_duck_playground_tpu_torch.ops import cuda_step
    from open_duck_playground_tpu_torch.train import ppo
    from open_duck_playground_tpu_torch.utils import profiling
    from open_duck_playground_tpu_torch.utils.graphs import GraphedBody, copy_into

    hp = types.SimpleNamespace(reward_scaling=0.37, discounting=0.97, gae_lambda=0.95)
    static = _gae_inputs(T, b, card, seed=0)
    out = {}

    def body():
        out["gae"] = ppo.gae(**static, hp=hp)

    graphed = GraphedBody(body, [], device=card, kernels=[cuda_step.GAE])
    profiling.reset()
    for seed in (1, 2):
        fresh = _gae_inputs(T, b, card, seed)
        copy_into(static, fresh)
        graphed.replay()
        want = _plain_gae(**fresh, hp=hp)
        torch.cuda.synchronize()
        assert _same_gae(out["gae"], want, b), seed
    assert profiling.summary()["counters"]["gae.fused_steps"] == 3
    assert graphed.info["fused_launches_per_replay"] == 1
    assert graphed.info["kernel_nodes"] == 1 and graphed.info["memcpy_nodes"] == 0, graphed.info


def _swish_values(shape, seed, dev, unaligned=False):
    """Seeded x (normal, scaled by 6) and g (normal) of `shape` on `dev`, with
    special values at the head of x: +-0, +-inf, NaN, subnormals, |x| past 88
    where exp(-x) overflows or sigmoid underflows, FLT_MAX; g large where
    g * x overflows. With `unaligned`, each is a view into a buffer from a
    one-float offset (not 16-byte aligned: the kernels' scalar path)."""
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(shape, generator=gen) * 6).reshape(-1)
    g = torch.randn(shape, generator=gen).reshape(-1)
    tiny, big = torch.finfo(torch.float32).tiny, torch.finfo(torch.float32).max
    special = torch.tensor([0.0, -0.0, float("inf"), float("-inf"), float("nan"), tiny / 8,
                            -tiny / 8, tiny, 88.5, -88.5, 89.0, -89.0, 104.0, -104.0, 1e30, -1e30,
                            big, -big, 1e10, -1e10])
    n = min(len(special), x.numel())
    x[:n] = special[:n]
    g[max(n - 2, 0):n] = 1e30  # g * x overflows at x = +-1e10
    out = []
    for t in (x, g):
        t = t.to(dev)
        if unaligned:
            t = torch.cat([t.new_zeros(1), t])[1:]
        out.append(t.view(shape))
    return out


def _same_floats(a, b) -> bool:
    """Bit for bit where neither is NaN, and NaN where the other is."""
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))
                and torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32)))


@pytest.mark.cuda
def test_swish_forward_kernel_equals_torch_on_every_float(card):
    """The swish's forward kernel (cuda_step.swish_forward) against
    x * torch.sigmoid(x) on the card over every float32 bit pattern (2**32
    values in chunks of 2**28): bit for bit, NaN where torch gives NaN
    (payloads not compared). This holds the kernel's expf, built with
    -fmad=false, to torch's."""
    from open_duck_playground_tpu_torch.ops import cuda_step

    chunk, bad, examples = 1 << 28, 0, []
    for lo in range(0, 1 << 32, chunk):
        bits = (torch.arange(lo, lo + chunk, dtype=torch.int64, device=card) - (1 << 31))
        x = bits.to(torch.int32).view(torch.float32)
        del bits
        got, want = cuda_step.swish_forward(x), x * torch.sigmoid(x)
        nan = torch.isnan(want)
        diff = (torch.isnan(got) != nan) | (~nan & (got.view(torch.int32) != want.view(torch.int32)))
        n = int(diff.sum())
        if n and len(examples) < 8:
            idx = diff.nonzero().flatten()[:8 - len(examples)]
            examples += [(hex(int(x.view(torch.int32)[i]) & 0xFFFFFFFF), float(x[i]),
                          float(got[i]), float(want[i])) for i in idx.tolist()]
        bad += n
        del x, got, want, nan, diff
    assert bad == 0, f"{bad} floats differ; (x bits, x, kernel, torch): {examples}"


SWISH_CASES = [((20, 256, 512), False), ((20, 256, 256), False), ((20, 256, 128), False),
               ((7, 33), False), ((20, 256, 128), True)]  # the SGD step's, odd, unaligned


@pytest.mark.cuda
@pytest.mark.parametrize("shape,unaligned", SWISH_CASES)
def test_swish_kernels_equal_torch_autograd(card, shape, unaligned):
    """networks.swish on the card (the forward kernel, then the backward
    kernel in the backward pass) against x * torch.sigmoid(x) and its
    autograd gradient on the card, on special and random values: output
    and gradient bit for bit; the tracer counts 2 fused calls and no plain
    one."""
    from open_duck_playground_tpu_torch.train import networks as nets
    from open_duck_playground_tpu_torch.utils import profiling

    x, g = _swish_values(shape, len(shape) + shape[-1], card, unaligned)
    assert (x.data_ptr() % 16 != 0) == unaligned
    xp = x.clone().requires_grad_()
    want = xp * torch.sigmoid(xp)
    want.backward(g)
    profiling.reset()
    xk = x.requires_grad_()
    got = nets.swish(xk)
    got.backward(g)
    torch.cuda.synchronize()
    counters = profiling.summary()["counters"]
    assert counters["swish.fused_calls"] == 2 and counters["swish.plain_calls"] == 0
    assert _same_floats(got.detach(), want.detach())
    assert _same_floats(xk.grad, xp.grad)


@pytest.mark.cuda
def test_swish_kernels_in_a_captured_graph(card):
    """networks.swish's forward and backward recorded as a CUDA graph
    (utils.graphs.GraphedBody, as the SGD step records them) and replayed on
    two new inputs copied into its static ones, against torch's swish and
    autograd run eagerly: bit for bit after each replay; two swish launches
    recorded per replay, the warm-up's and the replays' counted."""
    from open_duck_playground_tpu_torch.ops import cuda_step
    from open_duck_playground_tpu_torch.train import networks as nets
    from open_duck_playground_tpu_torch.utils import profiling
    from open_duck_playground_tpu_torch.utils.graphs import GraphedBody

    shape = (20, 256, 512)
    static_x, static_g = _swish_values(shape, 0, card)
    out = {}

    def body():
        xr = static_x.detach().requires_grad_()
        y = nets.swish(xr)
        y.backward(static_g)
        out.update(y=y.detach(), gx=xr.grad)

    graphed = GraphedBody(body, [], device=card, kernels=[cuda_step.SWISH])
    profiling.reset()
    for seed in (1, 2):
        x, g = _swish_values(shape, seed, card)
        static_x.copy_(x)
        static_g.copy_(g)
        graphed.replay()
        xp = x.clone().requires_grad_()
        want = xp * torch.sigmoid(xp)
        want.backward(g)
        torch.cuda.synchronize()
        assert _same_floats(out["y"], want.detach()) and _same_floats(out["gx"], xp.grad), seed
    assert profiling.summary()["counters"]["swish.fused_calls"] == 6
    assert graphed.info["launches_per_replay"] == {"duck_swish": 2}, graphed.info
