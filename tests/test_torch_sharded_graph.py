"""The env-sharded SGD step with static per-rank minibatches, as a chain of
segments around its collectives, on 2 gloo ranks of this machine.

In the JAX package the sharded training step is one SPMD program: XLA
places the collectives inside it (``ppo.py:140-149, 263-300``). Here each
rank takes every position of every global minibatch, its own envs' rows at
its members' positions and a masked stand-in elsewhere (`ppo.sgd_points`),
so that every minibatch has the world-1 shape; the body is a generator that
yields a fixed buffer at each collective point, and on the card each
stretch between two points is a CUDA graph segment
(`utils.graphs.GraphedBody`). On the CPU the segments run eagerly with the
collectives between them (`ppo.sgd_step`, and `ppo.SGDStepProgram`).
Checked here:

1. the chain against the step as it stood, with host-built member lists
   (`torch_dist_worker._members`): its sums run over other lengths, so the
   results agree to rounding; and against world size 1 to the bounds of
   test_torch_dist.py::test_world_2_matches_world_1_on_the_toy_env;
2. the chain against the same masked step written straight, each
   collective in line: bit for bit;
3. the collective points: as many as `ppo.sgd_collectives` gives, the same
   buffer objects at the same addresses in every run (what a replayed
   segment reads and writes), summed in place;
4. no segment reads a tensor back to the host, makes one from host data or
   synchronizes (the host member lists do);
5. on a sharded CUDA env, make_rollout, make_eval_step and make_sgd_step
   make the programs of the shard and say they are captured, checked
   without launching anything; on the CPU the SGD step program runs the
   chain eagerly and equals ppo.sgd_step bit for bit over two steps.

Inputs: seeded numpy, 32 envs (16 per rank), unroll 4, 4 minibatches of 8,
2 epochs, (16, 16) networks. The replays against the eager bodies on the
card are tests/test_torch_cuda.py::test_sharded_step_replays_match_eager_at_world_2
and chip_smoke.py phase 5.
"""

import types

import numpy as np
import pytest
import torch

from open_duck_playground_tpu_torch.envs.wrapper import TrainEnv
from open_duck_playground_tpu_torch.parallel.dist import EnvShard
from open_duck_playground_tpu_torch.train import ppo
from tests.torch_dist_worker import (
    SEG_NF,
    SEG_OBS,
    run_ranks,
    seg_hyper,
    seg_world_1,
)

pytest_plugins = ["tests.torch_lock"]  # never beside tests/test_resume.py (see there)

SEED = 5


def _hp_kw():
    hp = seg_hyper()
    return {f: getattr(hp, f) for f in hp.__dataclass_fields__}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's sgd_segment_checks, from one gloo run of 2 ranks."""
    return run_ranks("sgd_segment_checks", tmp_path_factory.mktemp("segments"), _hp_kw(), SEED)


def _params_diff(a, b):
    flat = lambda t: np.concatenate([np.ravel(v) for v in _leaves(t)])  # noqa: E731
    return np.abs(flat(a) - flat(b))


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield np.asarray(tree)


def test_masked_members_match_host_members_and_world_1(ranks):
    """The chain against the host-member step at world 2: params q99 |d| <=
    1e-7 and max |d| <= 1e-5, Adam moments and normalizer to atol 1e-6,
    loss terms to rtol 1e-5 (the masked sums add zeros and run over the
    whole minibatch, so the additions are ordered otherwise); against world
    1: params q99 <= 1e-6 and max <= 2 lr per Adam step, normalizer to
    rtol 1e-6 and atol 1e-6 (its summed variances are ~500 here) and its
    count exactly, loss terms rtol 1e-3; the params the same on both
    ranks."""
    hp = seg_hyper()
    one = seg_world_1(_hp_kw(), SEED)
    adam_steps = hp.num_updates_per_batch * hp.num_minibatches
    for r in ranks:
        chain, host = r["chain"], r["host"]
        d = _params_diff(chain["params"], host["params"])
        assert np.quantile(d, 0.99) <= 1e-7 and d.max() <= 1e-5, (np.quantile(d, 0.99), d.max())
        for a, b in zip(chain["learner"], host["learner"]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        for k, v in chain["losses"].items():
            np.testing.assert_allclose(v, host["losses"][k], rtol=1e-5, atol=1e-7, err_msg=k)
        d = _params_diff(chain["params"], one["params"])
        assert np.quantile(d, 0.99) <= 1e-6 and d.max() <= 2 * hp.learning_rate * adam_steps
        n_params = len(list(ppo.init_training_state(SEG_OBS, 3, SEG_NF, torch.Generator(),
                                                    "cpu").params.parameters()))
        norm_a, norm_b = chain["learner"][1 + 3 * n_params:], one["learner"][1 + 3 * n_params:]
        for a, b in zip(norm_a, norm_b):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
        assert chain["learner"][n_params] == one["learner"][n_params] == adam_steps
        for k, v in chain["losses"].items():
            np.testing.assert_allclose(v, one["losses"][k], rtol=1e-3, atol=1e-5, err_msg=k)
    assert not _params_diff(ranks[0]["chain"]["params"], ranks[1]["chain"]["params"]).any()


def test_segment_chain_equals_straight_masked_step(ranks):
    """The segments run with the collectives between them give the step
    written straight, each collective in line, bit for bit: params, Adam
    count and moments, normalizer, loss terms."""
    for r in ranks:
        chain, straight = r["chain"], r["masked"]
        assert len(chain["learner"]) == len(straight["learner"])
        for i, (a, b) in enumerate(zip(chain["learner"], straight["learner"])):
            assert a.dtype == b.dtype and np.array_equal(a, b), i
        for k, v in chain["losses"].items():
            assert np.array_equal(v, straight["losses"][k]), k


def test_collective_points_are_fixed_buffers_summed_in_place(ranks):
    """sgd_collectives' count of points (2 per obs key, 3 per minibatch
    step: 28 here), the same buffer objects at the same addresses in two
    runs on one Collectives, one buffer per kind of point; all_reduce_sum_
    sums in place, counts itself, and is one dist.collective span of the
    tracer, with its host time, when the tracer is on."""
    hp = seg_hyper()
    want = 2 * len(SEG_OBS) + 3 * hp.num_updates_per_batch * hp.num_minibatches
    for r in ranks:
        first, second = r["points"]
        assert r["collectives_expected"] == want == len(first) == 28
        assert first == second
        assert len(set(first)) == 2 * len(SEG_OBS) + 3
        inp = r["in_place"]
        assert inp["same"] and inp["counted"] == 2
        assert list(inp["spans"]) == ["dist.collective"]
        assert inp["spans"]["dist.collective"]["count"] == 1
        assert inp["spans"]["dist.collective"]["host_ms"] > 0
        np.testing.assert_array_equal(inp["value"], [6.0, 8.0])  # (1 + 2, 2 + 2), summed twice


def test_sharded_sgd_body_is_safe_to_capture(ranks):
    """Between its collective points the sharded SGD body makes no tensor
    from host data, reads nothing back to the host and never synchronizes
    (its minibatches are static: every rank takes every position, masked);
    the host member lists the step used before copy the permutations to the
    host, which the same spy catches."""
    for r in ranks:
        assert r["spy_segments"] == r["collectives_expected"] + 1
        assert r["spy_calls"] == []
        assert {"cpu", "numpy", "from_numpy"} <= set(r["spy_host_members"])


class _CardEnv:
    """An env that says it lives on a card, for the selection logic alone:
    nothing here launches (constructing a captured program records
    nothing until its first call)."""

    action_size = 3
    observation_size = {"state": (6,), "privileged_state": (8,)}
    model = None
    physics_mode = "kernel"

    def __init__(self, shard):
        self.device = torch.device("cuda", 0)
        self.shard = shard
        self.generator = object()
        self.physics = types.SimpleNamespace(launches=0)


def test_captured_forms_are_chosen_for_a_sharded_cuda_env(ranks):
    """At world 2 on a (stand-in) CUDA env and learner, make_rollout,
    make_eval_step and make_sgd_step make the programs of the shard and log
    that they are captured, and what they run; nothing is captured before
    a first call, and the SGD step refuses another shard. On the CPU at
    world 2 (each gloo rank) the same SGD step program runs its body
    eagerly, says so, and over two consecutive steps equals ppo.sgd_step
    bit for bit: learner and loss terms."""
    hp = seg_hyper()
    shard = EnvShard(1, 2, "cuda:0", backend="gloo")
    ts = ppo.init_training_state(SEG_OBS, 3, SEG_NF, torch.Generator().manual_seed(0), "cpu")
    card_ts = ts.replace(env_steps=types.SimpleNamespace(device=torch.device("cuda", 0)))
    te = TrainEnv(_CardEnv(shard), num_envs=16, episode_length=10)
    g = torch.Generator()
    lines = []
    roll = ppo.make_rollout(te, ts, hp, lines.append)
    ev = ppo.make_eval_step(te, ts, g, False, lines.append)
    sgd = ppo.make_sgd_step(card_ts, hp, shard, lines.append)
    assert isinstance(roll, ppo.RolloutProgram) and roll.graph is None
    assert isinstance(ev, ppo.EvalStepProgram) and ev.graph is None
    assert isinstance(sgd, ppo.SGDStepProgram) and sgd.graph is None and sgd.between is not None
    card = "CUDA graphs on cuda:0, captured at the first call"
    sums = "28 sums over the ranks between 29 segments, on fixed buffers"
    assert lines == [
        f"[ppo] rollout: one replay per training step ({hp.unroll_length} env steps), {card}",
        f"[ppo] eval step: one replay per eval step, {card}",
        f"[ppo] SGD step: one replay per training step at world 2 (gloo; {sums} in pinned host "
        f"memory), {card}"]
    with pytest.raises(ValueError, match="reads what it was made for"):
        sgd(card_ts, None, None, None, hp, EnvShard(0, 2, "cuda:0", backend="gloo"))

    for r in ranks:
        assert r["program"] == {"lines": [
            f"[ppo] SGD step: one replay per training step at world 2 (gloo; {sums}), run "
            "eagerly on cpu (no CUDA graph off the card)"], "equal": [True, True], "replays": 2}
