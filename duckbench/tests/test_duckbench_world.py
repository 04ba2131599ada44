"""A cell on more than one card, on the CPU: the ranks' path at gloo world 2
on the tests' tiny size (the same units on every rank, the followed steps
gathered on rank 0 and held against the one-process reference bit for bit,
faults that only a many-rank run can have), the launcher's ends of a rank
that fails or hangs, the four-chip rule of the manifest, and the
configuration keys that pick the port's engine and the reference's env."""

from __future__ import annotations

import copy
import json
import multiprocessing
import os
import socket
import subprocess
import sys
import time

import pytest

from duckbench import check, faults, manifest, program, ranks, run

TRAIN4 = "joystick_flat_backlash.train4"
WORLD = 2
CASES = [("sound", {"trace": True, "rounding": True}), ("half_batch", {"fault": "half_batch"}),
         ("answer_altered", {"fault": "answer_altered"}),
         ("exchange_skipped", {"fault": "exchange_skipped"})]
TIMEOUT_S = 600.0


@pytest.fixture(scope="module")
def world_runs(tmp_path_factory):
    """Every case's result on every rank, from one gloo group of WORLD ranks."""
    from world_worker import rank_main

    out = str(tmp_path_factory.mktemp("world"))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, WORLD, port, out, TRAIN4,
                                                 copy.deepcopy(CASES), 987_654_321_019))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    t0 = time.monotonic()
    for p in procs:
        p.join(max(TIMEOUT_S - (time.monotonic() - t0), 0.1))
    hung = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not hung, f"ranks still running after {TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * WORLD
    runs = {}
    for name, _ in CASES:
        runs[name] = []
        for r in range(WORLD):
            with open(os.path.join(out, f"{name}.rank{r}.json")) as f:
                runs[name].append(json.load(f))
    return runs


def test_every_rank_runs_the_same_units_and_rank_0_reports_the_world(world_runs):
    for name, results in world_runs.items():
        assert len({res["attempted"] for res in results}) == 1, name
        assert results[0]["attempted"] >= 1
        assert results[0]["device"]["count"] == WORLD
        assert set(results[1]) == {"attempted", "rank"} and results[1]["rank"] == 1


def test_a_sound_world_run_is_correct_against_the_one_process_reference(world_runs):
    res = world_runs["sound"][0]
    assert res["correct"] is True, res["checks"]
    assert res["checks"]["env_gap"]["value"] == 0.0  # every draw at the global shape
    assert set(res["checks"]) == set(manifest.limits(TRAIN4))
    m = res["metrics"]
    assert {"rollout_ms.world4", "sgd_ms.world4", "step_mfu.world4"} <= set(m)
    # the CPU runs no NCCL kernel and captures no graph
    assert "sgd_collective_ms.world4" not in m and "sgd_graph_segments.world4" not in m
    assert set(res["partials"]) == set(res["checks"])
    assert res["partials"]["env_gap"] == 0.0  # the physics sums over no envs
    # the normalizer's chain: the program's against the reference's own
    assert res["checks"]["norm_gap"]["value"] < 1e-5
    assert set(res["unfollowed"]) == set(res["checks"]) - {"norm_gap"}
    assert set(res["leaves"]) == {"program", "partials"}


def test_the_chain_of_normalizer_updates_reads_rounding_alone():
    """norm_gap: the ranks' partial sums read rounding against the
    one-process chain, a near-constant feature's too; the sums of other
    observations do not."""
    import torch

    from duckbench import precision
    from duckbench.ref.train import networks as nets

    g = torch.Generator().manual_seed(3)
    features = ((1.0, 0.0), (1e-4, 0.7), (0.0, 5.0))  # (std, mean): spread, near-constant, constant
    steps = [torch.cat([torch.randn(20, 64, 1, generator=g) * s + m for s, m in features], -1)
             for _ in range(3)]

    def chain(envs=slice(None), world=1):
        state, out = nets.rs_init({"state": 3}, "cpu"), []
        for x in steps:
            with precision.rank_partials(torch.nn.Identity(), world):
                state = nets.rs_update(state, {"state": x[:, envs]})
            out.append(check.clone(state))
        return out

    one = chain()
    assert check.norm_gap(one, one) == 0.0
    assert check.norm_gap(chain(world=4), one) < 1e-5
    assert check.norm_gap(chain(slice(0, 32)), chain(slice(32, 64))) > 1e-3


@pytest.mark.parametrize("fault", ["half_batch", "answer_altered", "exchange_skipped"])
def test_a_broken_world_run_is_not_correct(world_runs, fault):
    assert fault in faults.FAULTS
    res = world_runs[fault][0]
    assert res["correct"] is False, res["checks"]


def _ranks(body: str) -> list:
    """A command whose rank r (torch.distributed.run's RANK) runs `body`."""
    return [sys.executable, "-c", "import os, sys, time; r = int(os.environ['RANK']); "
            "assert os.environ['" + ranks.T0 + "']; " + body]


def test_the_launcher_ends_every_rank_when_one_fails(tmp_path):
    t0 = time.monotonic()
    code, out = ranks.launch(_ranks(f"open(r'{tmp_path}/%d' % r, 'w').close(); "
                                    "time.sleep(0.5 if r == 1 else 60); sys.exit(7 * (r == 1))"),
                             3, 50.0, t0)
    assert code != 0 and out == ""
    assert time.monotonic() - t0 < 45
    assert sorted(os.listdir(tmp_path)) == ["0", "1", "2"]


def test_the_launcher_ends_ranks_that_hang_at_its_timeout():
    t0 = time.monotonic()
    code, _ = ranks.launch(_ranks("time.sleep(0.1 if r == 0 else 120)"), 2, 5.0, t0)
    assert code == 124
    assert time.monotonic() - t0 < 5.0 + ranks.CLOSE_S


def test_the_launcher_passes_on_rank_0s_output():
    code, out = ranks.launch(_ranks("r or print('a'); r or print('{\"x\": 1}')"), 2, 60.0,
                             time.monotonic())
    assert code == 0 and out.splitlines() == ["a", '{"x": 1}']


def test_a_four_card_cell_without_four_cards_exits_3_with_no_result():
    out = subprocess.run([sys.executable, "-m", "duckbench.run", "--workload", TRAIN4,
                          "--seed", "3", "--seconds", "1", "--trace", "0"],
                         cwd=manifest.ROOT, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 3
    assert out.stdout.strip() == ""


def test_the_manifest_takes_the_world4_cell_and_refuses_a_second_four_card_cell():
    bench = manifest.load()
    assert manifest.validate(bench) == []
    four = [w for w in bench["workloads"] if w["chips"] == 4]
    assert [w["name"] for w in four] == [TRAIN4]
    broken = copy.deepcopy(bench)
    broken["workloads"].append(dict(four[0], name="joystick_rough_backlash.train4",
                                    config="joystick_rough_backlash"))
    assert any("4 chips" in e for e in manifest.validate(broken))


def test_a_pipeline_configuration_builds_the_ports_pipeline_env():
    run.prepare()
    cfg = manifest.config(manifest.load(), "joystick_flat_backlash")
    env = program._env(dict(cfg, env_overrides={"sim_dt": 0.01}, physics="pipeline"), "cpu")
    assert env.physics_mode == "pipeline"
    assert program._env(dict(cfg, env_overrides={"sim_dt": 0.01}), "cpu").physics_mode == "kernel"


def test_an_unknown_env_names_the_missing_reference_module():
    from duckbench.ref.envs.joystick import Joystick

    assert check.ref_env_class("joystick") is Joystick
    with pytest.raises(ValueError, match="duckbench/ref/envs/hopping.py"):
        check.ref_env_class("hopping")


def test_the_partials_reading_changes_rounding_alone():
    """precision.rank_partials: a Linear's forward is the plain one and its
    weight gradient is the plain one to float32 rounding; the reference's
    module-level sums over envs come in parts; all restored after."""
    import torch

    from duckbench import precision
    from duckbench.ref.train import networks as ref_networks

    g = torch.Generator().manual_seed(5)
    layer = torch.nn.Linear(300, 64)
    x = torch.randn(20, 256, 300, generator=g)
    w0 = torch.randn(20, 256, 64, generator=g)

    def grads():
        layer.zero_grad()
        y = layer(x)
        (y * w0).sum().backward()
        return y.detach(), layer.weight.grad.clone(), layer.bias.grad.clone()

    y, gw, gb = grads()
    with precision.rank_partials(layer, 4):
        y4, gw4, gb4 = grads()
        assert ref_networks.torch is not torch
        s = ref_networks.torch.sum(x, dim=(0, 1))
    assert torch.equal(y4, y)
    assert not torch.equal(gw4, gw)
    torch.testing.assert_close(gw4, gw, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(gb4, gb, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s, x.sum(dim=(0, 1)), rtol=1e-4, atol=1e-4)
    assert ref_networks.torch is torch
    assert torch.equal(grads()[1], gw)
