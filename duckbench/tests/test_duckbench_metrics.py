"""The arithmetic of the metrics from fixed inputs: the two rates over a
window, the idle union and gaps of a trace, the kernel's roofline and the
whole step's share of the peak from the frozen counts. CPU only."""

from __future__ import annotations

import pytest

from duckbench import counts, manifest, readers, roofline, run, trace


@pytest.fixture(scope="module")
def cfg():
    return manifest.config(manifest.load(), "joystick_flat_backlash")


def test_rates_are_the_window_work_over_the_window_time():
    ctx = {"loop": "train", "env_steps": 3 * 163840, "window_s": 1.25, "setup_s": 17.5}
    assert run.E2E["train_env_sps"](ctx) == 3 * 163840 / 1.25
    assert run.E2E["eval_env_sps"](ctx) is None
    assert run.E2E["setup_s"](ctx) == 17.5
    ctx = {"loop": "eval", "env_steps": 2 * 1024 * 1000, "window_s": 4.0, "setup_s": 9.0}
    assert run.E2E["eval_env_sps"](ctx) == 512000.0
    assert run.E2E["train_env_sps"](ctx) is None


def test_a_split_rate_is_its_stems_in_the_cells_it_lists(tmp_path):
    """train_env_sps.hfield is train_env_sps's arithmetic, reported in the
    heightfield cell alone, under a bound of its own."""
    bench = manifest.load()
    by_name = {m["name"]: m for m in bench["end_to_end"]}
    flat, rough = by_name["train_env_sps"], by_name["train_env_sps.hfield"]
    assert flat["workloads"] == ["joystick_flat_backlash.train"]
    assert rough["workloads"] == ["joystick_rough_backlash.train"]
    assert flat["bound"] < rough["bound"]
    for m in bench["per_layer"]:
        if m["name"].endswith(".hfield"):
            assert m["moves"] == "train_env_sps.hfield"


def test_idle_is_one_minus_the_union_of_device_intervals():
    events = [
        {"cat": "user_annotation", "name": trace.WINDOW, "ts": 0, "dur": 100},
        {"cat": "user_annotation", "name": "sgd", "ts": 50, "dur": 40},
        {"cat": "kernel", "name": "physics_step_kernel(DuckModel)", "ts": 10, "dur": 20},
        {"cat": "kernel", "name": "gemm", "ts": 20, "dur": 20},  # overlaps the first
        {"cat": "gpu_memcpy", "name": "Memcpy DtoD", "ts": 60, "dur": 10},
        {"cat": "kernel", "name": "add", "ts": 80, "dur": 10},
        {"cat": "kernel", "name": "gemm", "ts": 95, "dur": 10},  # ends past the window
        {"cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 100},
    ]
    spans, work = trace.parse_events(events)
    s = trace.summarize(spans, work, "physics_step_kernel")
    # from the first device operation (10) to the last inside (90): the
    # host's start [0, 10] and its closing wait [90, 100] are not idle
    assert s["window_s"] == pytest.approx(80e-6)
    assert s["busy_s"] == pytest.approx(50e-6)  # [10, 40], [60, 70] and [80, 90]
    assert s["kernel_launches"] == 1 and s["kernel_s"] == pytest.approx(20e-6)
    assert s["device_ops"][0] == ["physics_step_kernel(DuckModel)", pytest.approx(20e-6)]
    gaps = dict((round(g * 1e6), n) for n, g in s["idle_gaps"])
    assert gaps == {20: "host", 10: "sgd"}
    assert 1.0 - s["busy_s"] / s["window_s"] == pytest.approx(0.375)


def test_kernel_roofline_from_the_frozen_counts(cfg):
    c = cfg["counts"]
    b = roofline.kernel_bound_s(c, True, 8192, 10)
    flops = c["physics_flops_per_env_substep"]["dr"] * 8192 * 10
    assert b["flops"] == flops and b["bound_by"] == "operations"
    assert b["bound_s"] == pytest.approx(flops / 67e12)
    assert b["bytes"] == 4 * 8192 * c["physics_words_per_env"]["dr"]
    t = {"kernel_launches": 4, "kernel_s": 4 * 10 * b["bound_s"]}
    ctx = {"loop": "train", "cfg": cfg, "trace": t}
    assert readers.kernel_roofline(ctx, "train") == pytest.approx(10.0)
    # the eval loop: 1024 rows, no randomization
    e = roofline.kernel_bound_s(c, False, 1024, 10)
    t = {"kernel_launches": 2, "kernel_s": 2 * e["bound_s"]}
    ctx = {"loop": "eval", "cfg": cfg, "trace": t}
    assert readers.kernel_roofline(ctx, "eval") == pytest.approx(100.0)
    assert readers.kernel_roofline(dict(ctx, trace={"kernel_launches": 0, "kernel_s": 0.0}),
                                   "eval") is None


def test_the_work_of_a_training_step_and_an_eval_step(cfg):
    f = roofline.training_step_flops(cfg)
    policy = 2 * (101 * 512 + 512 * 256 + 256 * 128 + 128 * 28)
    value = 2 * (212 * 512 + 512 * 256 + 256 * 128 + 128 * 1)
    assert f["rollout_policy"] == policy * 8192 * 20
    assert f["physics"] == cfg["counts"]["physics_flops_per_env_substep"]["dr"] * 8192 * 10 * 20
    back_p = policy + 2 * (512 * 256 + 256 * 128 + 128 * 28)
    back_v = value + 2 * (512 * 256 + 256 * 128 + 128 * 1)
    per_mb = 20 * 256 * (policy + back_p + value + back_v) + 256 * value
    assert f["sgd"] == per_mb * 32 * 4
    assert 2.0e12 < f["total"] < 2.5e12
    e = roofline.eval_step_flops(cfg)
    assert e["total"] == (cfg["counts"]["physics_flops_per_env_substep"]["nominal"] * 1024 * 10
                          + policy * 1024)
    ctx = {"loop": "train", "units": 10, "window_s": 4.0, "flops_per_unit": f}
    assert readers.step_mfu(ctx, "train") == pytest.approx(100 * 10 * f["total"] / 4.0 / 67e12)
    assert readers.step_mfu(dict(ctx, units=0), "train") is None


def test_mean_ms_reads_the_parts_it_has():
    ctx = {"spans": {"rollout": [1.0, 2.0, 3.0]}}
    assert readers.mean_ms(ctx, "rollout") == 2.0
    assert readers.mean_ms(ctx, "sgd") is None


@pytest.mark.parametrize("name", ["joystick_flat_backlash", "joystick_rough_backlash"])
def test_frozen_counts_are_what_counts_makes(name):
    cfg = manifest.config(manifest.load(), name)
    assert counts.counts(cfg) == cfg["counts"]
