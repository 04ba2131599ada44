"""The port's tracer (utils/profiling.py): spans and counters recorded by the
package itself, on one clock with the card.

On the CPU, where spans carry host times only:

- off, an eager training step and an eval episode record no span and no
  stamp, and add no annotation to a running torch.profiler; a span is then
  one shared null context;
- on, they give the span tree the package promises: names, parents, unit
  ids, and per rollout 20 `policy` and 20 `env.step` spans, each env step
  holding one `physics`; under torch.profiler each span is an annotation;
- the summary's arithmetic on hand-made intervals: idle is the window less
  the union of the stamped intervals, each gap goes to the innermost host
  span open when it began (or to "outside"), self time is the span's time
  less what its children cover, a host-only span takes its children's hull;
- the bound (`dropped`), the counters since `reset()`, `sample()`, and
  `add` (a closed host span timed by its caller);
- README's example path of the rollout's `physics` is the eager path with
  the graph's layers (`ppo.rollout.replay`, `graph.replay`) inside it.

On the card (marked `cuda`, skipped without one): five rollout replays
enqueued back to back without a host wait each keep their own 20 `physics`
intervals, and a training step holds README's example path 20 times; the
SGD graph's `kernel_nodes` and `memcpy_nodes` together equal the
profiler's kernel count for one replay (the driver runs each memcpy node
as a `memcpy32_post` kernel), and its memset nodes the profiler's memsets;
a graph captured with the tracer off holds no stamp node. This file imports no jax; on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py
"""

import ctypes
import json
import os
import re
import time

import pytest
import torch

import duck_standin  # tests/ is on sys.path (rootless test dir)
from open_duck_playground_tpu_torch.envs import randomize
from open_duck_playground_tpu_torch.envs.joystick import Joystick
from open_duck_playground_tpu_torch.envs.wrapper import TrainEnv
from open_duck_playground_tpu_torch.train import ppo
from open_duck_playground_tpu_torch.utils import profiling

NF = {"policy_hidden_layer_sizes": (32,), "value_hidden_layer_sizes": (32,)}
T = 20  # the recipe's unroll
README = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "README.md")
NAMES = ("ppo.draws", "ppo.training_step", "ppo.rollout", "ppo.sgd", "policy", "env.step",
         "physics", "env.reset", "ppo.run_eval", "ppo.eval_step")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = duck_standin.write_standin(str(tmp_path_factory.mktemp("standin")))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OPEN_DUCK_ASSETS", root)
        yield root


@pytest.fixture
def tracer():
    """The tracer off and empty before and after each test."""
    profiling.disable()
    profiling.reset()
    yield profiling
    profiling.disable()
    profiling.reset()


def _cheap_physics(env, monkeypatch):
    """The fused kernel's plain version replaced by a cheap one (the state
    held, the duck upright), behind FusedPhysics.__call__ and its span."""
    widths = env.physics.out_widths()
    up = int(env.model.sensor_adr[env.model.sensor("upvector")])

    def plain(qpos, qvel, warm, ctrl, n_substeps, dr=None):
        out = {k: torch.zeros(qpos.shape[0], w) for k, w in widths.items()}
        out.update(qpos=qpos.clone(), qvel=qvel.clone(), qacc_warmstart=warm.clone())
        out["sensordata"][:, up + 2] = 1.0
        return out

    monkeypatch.setattr(env.physics, "plain", plain)


@pytest.fixture
def duck(root, monkeypatch):
    """A 4-env training batch and a 2-env eval batch of the flat backlash
    duck on the CPU, DR on for training, and a learner of (32,) widths."""
    env = Joystick("flat_terrain_backlash", device="cpu", seed=3)
    _cheap_physics(env, monkeypatch)
    te = TrainEnv(env, num_envs=4, episode_length=50, randomization_fn=randomize.domain_randomize,
                  randomization_generator=torch.Generator().manual_seed(0))
    ev = TrainEnv(env, num_envs=2, episode_length=3)
    obs = {k: v[0] for k, v in env.observation_size.items()}
    ts = ppo.init_training_state(obs, env.action_size, NF, torch.Generator().manual_seed(1),
                                 "cpu")
    hp = ppo.Hyper(num_envs=4, unroll_length=T, num_minibatches=2, batch_size=2,
                   num_updates_per_batch=1, action_repeat=1, learning_rate=3e-4,
                   entropy_cost=5e-3, discounting=0.97, gae_lambda=0.95, clipping_epsilon=0.2,
                   normalize_advantage=True, reward_scaling=1.0, normalize_observations=True,
                   max_grad_norm=1.0)
    return env, te, ev, ts, hp


def _train_and_eval(duck, steps=1):
    env, te, ev, ts, hp = duck
    g = torch.Generator().manual_seed(2)
    state = te.reset(torch.Generator().manual_seed(4))
    for _ in range(steps):
        draws = ppo.draw_training_step(g, hp, env.action_size, "cpu")
        ts, state, _ = ppo.training_step(ts, te, state, draws, hp)
    ppo.run_eval(ev, ts.normalizer, ts.params, torch.Generator().manual_seed(5),
                 episode_length=3)


def _readme_key() -> str:
    """The path of README's tracer example: s["paths"]["<path>"]."""
    with open(README) as f:
        (key,) = re.findall(r'\bs\["paths"\]\["([^"]+)"\]', f.read())
    return key


def _annotations(prof) -> set:
    return {e.name for e in prof.events()} & set(NAMES)


def test_off_records_nothing_and_annotates_nothing(tracer, duck):
    assert not profiling.enabled()
    assert profiling.span("physics") is profiling.span("env.step", torch.device("cpu"), True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _train_and_eval(duck)
    s = profiling.summary()
    assert profiling.spans() == []
    assert s["spans"] == {} and s["stamps"] == 0 and s["dropped"] == 0
    assert s["device_idle_pct"] is None
    assert _annotations(prof) == set()


def test_on_gives_the_span_tree(tracer, duck):
    profiling.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _train_and_eval(duck, steps=2)
    profiling.disable()
    sp = profiling.spans()
    assert all(s["device"] is None and s["host"][1] >= s["host"][0] for s in sp)  # the CPU
    name = [s["name"] for s in sp]
    kids = {i: [j for j, c in enumerate(sp) if c["parent"] == i] for i in range(len(sp))}

    def children(i, n=None):
        return [j for j in kids[i] if n is None or name[j] == n]

    # the reset, then each training step (its draws outside it, unit 0)
    tops = [i for i, s in enumerate(sp) if s["parent"] is None]
    assert [name[i] for i in tops] == ["env.reset", "ppo.draws", "ppo.training_step",
                                       "ppo.draws", "ppo.training_step", "ppo.run_eval"]
    assert [sp[i]["unit"] for i in tops] == [0, 0, 1, 0, 2, 3]
    assert [name[j] for j in kids[tops[0]]] == ["physics"]
    for step in (tops[2], tops[4]):
        assert [name[j] for j in kids[step]] == ["ppo.rollout", "ppo.sgd"]
        (roll,) = children(step, "ppo.rollout")
        assert [name[j] for j in kids[roll]] == ["policy", "env.step"] * T
        for e in children(roll, "env.step"):
            assert [name[j] for j in kids[e]] == ["physics"]
        under = [j for j in range(len(sp)) if sp[j]["unit"] == sp[step]["unit"]]
        assert all(name[j] != "ppo.draws" for j in under)
    ev = tops[5]
    assert [name[j] for j in kids[ev]] == ["env.reset"] + ["ppo.eval_step"] * 3
    for j in children(ev, "ppo.eval_step"):
        assert sp[j]["unit"] == sp[ev]["unit"]  # nested units take the open one
        assert [name[k] for k in kids[j]] == ["env.step"]
    s = profiling.summary()
    assert s["units"] == 3 and s["stamps"] == 0
    assert s["spans"]["physics"]["count"] == 2 * T + 3 + 2  # 2 rollouts, 3 eval steps, 2 resets
    path = "ppo.training_step/ppo.rollout/env.step/physics"
    assert s["paths"][path]["count"] == 2 * T
    # README's path is this one with the captured rollout's layers inside
    assert _readme_key().replace("ppo.rollout.replay/graph.replay/", "") == path
    assert s["counters"]["physics.launches"] == 0  # the plain version launches nothing
    assert _annotations(prof) == set(NAMES)


def _span(name, parent, host=None, device=None, unit=0):
    return {"name": name, "parent": parent, "unit": unit, "host": host, "device": device}


def test_summary_arithmetic_on_hand_made_intervals():
    """A host-only root holding two stamped children and a replay of a
    template of two stamped spans (ns, on one clock):

        host:   root [0, 100]; a [10, 30]; b [40, 90]
        device: a [20, 35]; b [50, 60]; b/x [52, 55]; b/y [57, 58]; c [70, 80]

    c is a stamped child of root with no host time (a replay's span). The
    union is [20, 35] + [50, 60] + [70, 80] = 35 of a 60 ns window: idle 25
    ns, 41.67%. The gap [35, 50] began while b was not yet open and a had
    closed: root's; [60, 70] began inside b."""
    sp = [_span("root", None, host=(0, 100), unit=1),
          _span("a", 0, host=(10, 30), device=(20, 35), unit=1),
          _span("b", 0, host=(40, 90), device=(50, 60), unit=1),
          _span("x", 2, device=(52, 55), unit=1),
          _span("y", 2, device=(57, 58), unit=1),
          _span("c", 0, device=(70, 80), unit=1)]
    s = profiling.summarize(sp)
    assert s["window_ms"] == pytest.approx(60e-6)
    assert s["busy_ms"] == pytest.approx(35e-6)
    assert s["device_idle_pct"] == pytest.approx(100 * 25 / 60)
    assert s["idle_by_span"] == pytest.approx({"root": 15e-6, "b": 10e-6}, rel=1e-9)
    assert s["idle_gaps"] == [["root", pytest.approx(15e-6)], ["b", pytest.approx(10e-6)]]
    root, b = s["spans"]["root"], s["spans"]["b"]
    assert root["host_ms"] == pytest.approx(100e-6)
    assert root["self_host_ms"] == pytest.approx((100 - 20 - 50) * 1e-6)
    assert root["device_ms"] == pytest.approx(60e-6)  # the hull of its children: [20, 80]
    assert root["self_device_ms"] == pytest.approx((60 - 15 - 10 - 10) * 1e-6)
    assert b["device_ms"] == pytest.approx(10e-6)
    assert b["self_device_ms"] == pytest.approx((10 - 3 - 1) * 1e-6)
    assert b["self_host_ms"] == pytest.approx(50e-6)  # its children have no host time
    assert s["paths"]["root/b/x"]["device_ms"] == pytest.approx(3e-6)
    assert s["units"] == 1 and s["stamps"] == 10
    # a gap that opens with no host span open goes to "outside"
    s = profiling.summarize([_span("r", None, host=(0, 10), device=(0, 20)),
                             _span("s", None, host=(30, 40), device=(35, 40))])
    assert s["idle_by_span"] == {"outside": pytest.approx(15e-6)}
    assert s["units"] == 0  # unit 0 is outside any unit


def test_bound_counts_what_it_drops(tracer, monkeypatch):
    monkeypatch.setattr(profiling, "RECORDS", 3)
    profiling.enable()
    for _ in range(5):
        with profiling.span("s"):
            pass
    s = profiling.summary()
    assert s["spans"]["s"]["count"] == 3 and s["dropped"] == 2
    profiling.reset()
    assert profiling.summary()["dropped"] == 0


def test_counters_run_from_reset(tracer):
    class Thing:
        def __init__(self):
            self.n = 5

    a = Thing()
    profiling.watch(a, "n", "things")
    profiling.reset()
    a.n += 2
    b = Thing()
    profiling.watch(b, "n", "things")
    assert profiling.summary()["counters"]["things"] == 2 + 5
    del b
    assert profiling.summary()["counters"]["things"] == 2  # a counter lives with its object


def test_add_records_a_closed_host_span(tracer):
    profiling.add("off", 1, 2)  # off: not recorded
    profiling.enable()
    with profiling.span("graph.capture", unit=True):
        t0 = time.perf_counter_ns()
        profiling.add("graph.capture.warmup", t0, t0 + 5000)
    profiling.add("alone", 10, 30)
    sp = profiling.spans()
    assert [(s["name"], s["parent"], s["unit"], s["device"]) for s in sp] == [
        ("graph.capture", None, 1, None), ("graph.capture.warmup", 0, 1, None),
        ("alone", None, 0, None)]
    assert sp[1]["host"] == (t0, t0 + 5000) and sp[2]["host"] == (10, 30)
    assert profiling.summary()["spans"]["graph.capture.warmup"]["host_ms"] == 5e-3


def test_the_kernel_library_hands_over_the_stamp(tracer, monkeypatch):
    from open_duck_playground_tpu_torch.ops import cuda_step

    assert profiling._STAMPER is cuda_step._stamp
    monkeypatch.setattr(profiling, "_STAMPER", None)
    with pytest.raises(RuntimeError, match="stamp_with"):
        profiling._launch(0, 8, 1, 0)


def test_sample_leaves_an_off_tracer_off(tracer):
    with profiling.span("before"):
        pass  # off: not recorded
    with profiling.sample() as host_ms:
        with profiling.span("dist.collective"):
            sum(range(1000))
        with profiling.span("dist.collective"):
            pass
    assert host_ms["dist.collective"] > 0
    assert not profiling.enabled() and profiling.spans() == []
    profiling.enable()
    with profiling.span("kept"):
        with profiling.sample() as inner:
            with profiling.span("dist.collective"):
                pass
    assert set(inner) == {"dist.collective"}
    assert [s["name"] for s in profiling.spans()] == ["kept", "dist.collective"]


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: stamps and graphs run on the card")
    return torch.device("cuda")


def _card_learner(card, B=1024, mb=32):
    env = Joystick("flat_terrain_backlash", device=card, seed=3)
    te = TrainEnv(env, num_envs=B, episode_length=1000,
                  randomization_fn=randomize.domain_randomize,
                  randomization_generator=torch.Generator(device=card).manual_seed(0))
    obs = {k: v[0] for k, v in env.observation_size.items()}
    ts = ppo.init_training_state(obs, env.action_size, NF,
                                 torch.Generator(device=card).manual_seed(1), card)
    hp = ppo.Hyper(num_envs=B, unroll_length=T, num_minibatches=B // mb, batch_size=mb,
                   num_updates_per_batch=2, action_repeat=1, learning_rate=3e-4,
                   entropy_cost=5e-3, discounting=0.97, gae_lambda=0.95, clipping_epsilon=0.2,
                   normalize_advantage=True, reward_scaling=1.0, normalize_observations=True,
                   max_grad_norm=1.0)
    return env, te, ts, hp


@pytest.mark.cuda
def test_replays_enqueued_back_to_back_keep_their_stamps(card, root, tracer):
    """The rollout graph captured with the tracer on (1024 DR envs); five
    replays enqueued with no host wait between them; then each replay span
    holds its own 20 `physics` intervals, in order, inside it, and the
    replays do not overlap."""
    env, te, ts, hp = _card_learner(card)
    profiling.enable()
    roll = ppo.make_rollout(te, ts, hp)
    g = torch.Generator(device=card).manual_seed(2)
    state = te.reset(torch.Generator(device=card).manual_seed(4))
    draws = ppo.draw_training_step(g, hp, env.action_size, card)
    state, _ = roll(te, state, ts.normalizer, ts.params, draws[0])  # captures
    torch.cuda.synchronize()
    assert roll.graph.info["stamp_nodes"] == 2 + 2 * 3 * T  # the segment; policy, env.step, physics
    profiling.reset()
    for _ in range(5):
        state, _ = roll(te, state, ts.normalizer, ts.params, draws[0])
    torch.cuda.synchronize()
    sp = profiling.spans()
    replays = [i for i, s in enumerate(sp) if s["name"] == "ppo.rollout.replay"]
    assert len(replays) == 5 and all(sp[r]["device"] is None for r in replays)  # host only
    last_end = None
    for r in replays:
        (g,) = [i for i, s in enumerate(sp) if s["parent"] == r]
        assert sp[g]["name"] == "graph.replay"
        d0, d1 = sp[g]["device"]
        assert last_end is None or d0 >= last_end
        last_end = d1
        phys = [s["device"] for s in sp if s["name"] == "physics"
                and sp[s["parent"]]["parent"] == g]
        assert len(phys) == T
        assert all(d0 <= a < b <= d1 for a, b in phys)
        assert all(phys[k][1] <= phys[k + 1][0] for k in range(T - 1))
    s = profiling.summary()
    assert s["paths"]["ppo.rollout.replay/graph.replay/env.step/physics"]["count"] == 5 * T
    assert s["counters"]["physics.launches"] == 5 * T and s["counters"]["graph.replays"] == 5
    assert s["dropped"] == 0 and 0 <= s["device_idle_pct"] < 100
    # a training step of the captured rollout and SGD graphs holds README's path
    sgd = ppo.make_sgd_step(ts, hp)
    profiling.reset()
    ppo.training_step(ts, te, state, draws, hp, None, sgd, roll)
    torch.cuda.synchronize()
    assert profiling.summary()["paths"][_readme_key()]["count"] == T


@pytest.mark.cuda
def test_sgd_kernel_nodes_equal_the_profilers_kernel_count(card, root, tracer, tmp_path):
    """One replay of a captured SGD graph (256 envs, 8 x 32 minibatches, 2
    epochs) under the profiler: its kernels are the graph's kernel nodes
    and, one each, its device-to-device memcpy nodes, which the CUDA driver
    runs as kernels (`memcpy32_post`): the count `sgd_graph_kernels` reads.
    Its memsets are the memset nodes."""
    env, te, ts, hp = _card_learner(card, B=256)
    g = torch.Generator(device=card).manual_seed(2)
    roll = ppo.make_rollout(te, ts, hp)
    sgd = ppo.make_sgd_step(ts, hp)
    state = te.reset(torch.Generator(device=card).manual_seed(4))
    noise, perms, ent = ppo.draw_training_step(g, hp, env.action_size, card)
    state, data = roll(te, state, ts.normalizer, ts.params, noise)
    sgd(ts, data, perms, ent, hp)  # captures
    torch.cuda.synchronize()
    nodes = sgd.info["kernel_nodes"]
    assert profiling.summary()["graphs"]["[ppo] SGD step"]["kernel_nodes"] == nodes
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        sgd.graph.graphs[0].replay()
        torch.cuda.synchronize()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    copies = [k for k in kernels if k.startswith("memcpy")]  # memcpy nodes, run as kernels
    assert nodes > 1000 and len(kernels) == nodes + sgd.info["memcpy_nodes"]
    assert len(copies) == sgd.info["memcpy_nodes"]
    assert sum(e.get("cat") == "gpu_memset" for e in events) == sgd.info["memset_nodes"]


@pytest.mark.cuda
def test_a_graph_captured_off_holds_no_stamp(card, root, tracer):
    """The eval step captured twice, the tracer off then on: the graph
    captured on holds its stamp nodes beside the same kernel nodes of the
    program (kernel_nodes leaves the stamps out), the one captured off holds
    none, and its replays add no span inside the replay."""
    env = Joystick("flat_terrain_backlash", device=card, seed=3)
    ev = TrainEnv(env, num_envs=64, episode_length=10)
    obs = {k: v[0] for k, v in env.observation_size.items()}
    ts = ppo.init_training_state(obs, env.action_size, NF,
                                 torch.Generator(device=card).manual_seed(1), card)
    info = {}
    for on in (False, True):
        (profiling.enable if on else profiling.disable)()
        g = torch.Generator(device=card).manual_seed(5)
        step = ppo.make_eval_step(ev, ts, g, False)
        carry = ppo.eval_start(ev.reset(g))
        carry = step(ev, ts.normalizer, ts.params, g, carry)
        torch.cuda.synchronize()
        info[on] = dict(step.graph.info)
        if not on:
            profiling.enable()
            profiling.reset()
            step(ev, ts.normalizer, ts.params, g, carry)
            torch.cuda.synchronize()
            names = [s["name"] for s in profiling.spans()]
            assert names == ["ppo.eval_step", "ppo.eval_step.replay"]
    assert "stamp_nodes" not in info[False] and info[True]["stamp_nodes"] == 2 * 3
    assert info[False]["kernel_nodes"] == info[True]["kernel_nodes"] > 100


class _FakeCard:
    """The stamp kernel's arithmetic on host memory, with a graph's
    semantics: a launch inside a capture the tracer records runs nothing
    and becomes a node; `replay` runs a segment's nodes in order."""

    def __init__(self):
        self.nodes = []

    def launch(self, ring, count, capacity, dev):
        node = (ring, count, capacity)
        if profiling._TRACER.capture is not None:
            self.nodes.append(node)
        else:
            self.run(node)

    @staticmethod
    def run(node):
        ring, count, capacity = node
        c = ctypes.c_int64.from_address(count)
        if c.value < capacity:
            ctypes.c_int64.from_address(ring + 8 * c.value).value = time.perf_counter_ns()
        c.value += 1

    def capture(self, body):
        tpl = profiling.template(CARD)
        self.nodes = []
        with profiling.recording(tpl):
            body()
        return tpl, list(self.nodes)

    def replay(self, tpl, nodes):
        for node in nodes:
            self.run(node)
        profiling.replayed(tpl)


CARD = torch.device("cuda", 0)


@pytest.fixture
def fake_card(tracer, monkeypatch):
    """The tracer's device path on the CPU: rings in host memory, stamps
    by _FakeCard, no synchronize, no capture of torch's own."""
    card = _FakeCard()
    monkeypatch.setattr(profiling, "_launch", card.launch)
    monkeypatch.setattr(profiling, "_ring_device", lambda dev: torch.device("cpu"))
    monkeypatch.setattr(profiling, "RING", 64)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(profiling._TRACER, "rings", {})
    return card


def _body():
    for _ in range(2):
        with profiling.span("env.step", CARD):
            with profiling.span("physics", CARD):
                time.sleep(1e-4)


def test_the_ring_keeps_each_replays_stamps_in_order(fake_card):
    """Eager stamps and replays of a captured template interleaved: each
    replay's spans land at the slots the host counts, under the span open
    at the replay, nested as captured; replays made with the tracer off
    keep the host's count with the card's; past the ring's end the spans
    are dropped and the count goes on."""
    profiling.enable()
    tpl, nodes = fake_card.capture(_body)
    assert [e[:2] for e in tpl.entries] == [("graph.replay", -1), ("env.step", 0), ("physics", 1),
                                            ("env.step", 0), ("physics", 3)]
    assert [e[2:] for e in tpl.entries] == [(0, 9), (1, 4), (2, 3), (5, 8), (6, 7)]
    assert tpl.n == 10
    profiling.disable()
    fake_card.replay(tpl, nodes)  # off: not recorded, but counted
    profiling.enable()
    with profiling.span("ppo.rollout", unit=True):
        for _ in range(3):
            with profiling.span("ppo.rollout.copy_in", CARD):
                pass
            with profiling.span("ppo.rollout.replay"):
                fake_card.replay(tpl, nodes)
    sp = profiling.spans()
    reps = [i for i, s in enumerate(sp) if s["name"] == "graph.replay"]
    assert len(reps) == 3 and {sp[sp[r]["parent"]]["name"] for r in reps} == {
        "ppo.rollout.replay"}
    last = None
    for r in reps:
        inner = [i for i, s in enumerate(sp) if s["parent"] == r]
        assert [sp[i]["name"] for i in inner] == ["env.step"] * 2
        for i in inner:
            (phys,) = [s for s in sp if s["parent"] == i]
            a, b = sp[i]["device"]
            assert sp[r]["device"][0] <= a <= phys["device"][0] < phys["device"][1] <= b
            assert sp[r]["unit"] == sp[i]["unit"] == phys["unit"] == 1
            assert last is None or a >= last
            last = b
    ring = profiling._TRACER.rings[0]
    assert ring.head == 10 + 3 * (2 + 10) == int(ring.t[profiling.RING])  # 46
    s = profiling.summary()
    assert s["dropped"] == 0 and s["stamps"] == 3 * (2 + 10)
    for _ in range(3):  # 46 + 2 x 10 > 64: the second replay does not fit, nor the third
        fake_card.replay(tpl, nodes)
    assert profiling.summary()["dropped"] == 2 * 5 and ring.head == 76
    profiling.reset()
    assert ring.head == 0 == int(ring.t[profiling.RING])
    fake_card.replay(tpl, nodes)
    assert [s["name"] for s in profiling.spans()] == ["graph.replay"] + ["env.step", "physics"] * 2
