"""BENCHMARK.json against the benchmark's rules, discovery by name, and the
import check by whole top-level names. CPU only, no run of the port."""

from __future__ import annotations

import copy
import json
import os
import shutil
import sys

import pytest

from duckbench import manifest, run


@pytest.fixture(scope="module")
def bench():
    return manifest.load()


def test_manifest_keeps_the_rules(bench):
    assert manifest.validate(bench) == []


def test_every_cell_reports_setup_another_metric_and_a_per_layer_metric(bench):
    for w in bench["workloads"]:
        e2e = [m["name"] for m in manifest.cell_metrics(bench, w["name"], "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.cell_metrics(bench, w["name"], "per_layer")


@pytest.mark.parametrize("break_it, says", [
    (lambda b: b["workloads"][0].update(name="has space"), "is not a name"),
    (lambda b: b["end_to_end"][0].update(unit="env steps per s"), "unit"),
    (lambda b: b["per_layer"][0].update(moves="no_such_metric"), "moves"),
    (lambda b: b["per_layer"][0].update(workloads=["no.such.cell"]), "workloads"),
    (lambda b: b["end_to_end"].pop(), "setup_s"),
    (lambda b: b["end_to_end"][0].update(bound=0.5), "bound"),
    (lambda b: b["configs"][0].update(reduced=["hidden_size"]), "width"),
    (lambda b: b["workloads"][0].update(chips=2), "chips"),
    (lambda b: b["per_layer"][0].update(why="no extra keys"), "keys"),
    (lambda b: b.update(run_seconds=52), "run_seconds"),
    (lambda b: b["workloads"].append(dict(b["workloads"][0], name="again")), "another cell"),
])
def test_manifest_refuses_what_breaks_the_rules(bench, break_it, says):
    broken = copy.deepcopy(bench)
    break_it(broken)
    errs = manifest.validate(broken)
    assert any(says in e for e in errs), errs


def test_a_cell_and_metric_dropped_in_as_files_are_found(bench, tmp_path):
    """A later change adds a configuration, a traffic mix, a metric and a
    cell's limits as new files, and entries in BENCHMARK.json: no file that
    is there is edited."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(manifest.ROOT, "duckbench"), root / "duckbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = copy.deepcopy(bench)
    cfg = manifest.config(bench, "joystick_flat_backlash")
    cfg["name"] = "standing_flat_backlash"
    (root / "duckbench" / "configs" / "standing_flat_backlash.json").write_text(json.dumps(cfg))
    (root / "duckbench" / "traffic" / "train_long.json").write_text(
        json.dumps({"loop": "train", "follow": 2, "physics_steps": 1, "trace_units": 1}))
    (root / "duckbench" / "metrics" / "units_done.py").write_text(
        "def read(ctx):\n    return float(ctx['units'])\n")
    (root / "duckbench" / "limits" / "standing_flat_backlash.train_long.json").write_text(
        json.dumps({"numbers": {"env_gap": {"limit": 0.0}}}))
    b["configs"].append({"name": "standing_flat_backlash", "source": "https://example.org/x",
                         "file": "duckbench/configs/standing_flat_backlash.json",
                         "reduced": [], "why": "a new configuration"})
    b["workloads"].append({"name": "standing_flat_backlash.train_long",
                           "config": "standing_flat_backlash", "traffic": "train_long",
                           "chips": 1, "why": "a new cell"})
    b["end_to_end"][0]["workloads"].append("standing_flat_backlash.train_long")
    b["per_layer"].append({"name": "units_done", "unit": "units", "better": "higher",
                           "source": "host_clock", "layer": "harness", "moves": "train_env_sps",
                           "workloads": ["standing_flat_backlash.train_long"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    assert manifest.validate(b, str(root)) == []
    assert manifest.config(b, "standing_flat_backlash", str(root))["task"] == cfg["task"]
    assert manifest.traffic("train_long", str(root))["follow"] == 2
    assert manifest.limits("standing_flat_backlash.train_long", str(root)) == {"env_gap": 0.0}
    assert manifest.reader("units_done", str(root))({"units": 7}) == 7.0
    names = [m["name"] for m in manifest.cell_metrics(b, "standing_flat_backlash.train_long",
                                                      "per_layer")]
    assert names == ["units_done"]
    # without its reader file the metric is refused
    os.remove(root / "duckbench" / "metrics" / "units_done.py")
    assert any("units_done" in e for e in manifest.validate(b, str(root)))


def test_every_per_layer_metric_has_a_reader(bench):
    for m in bench["per_layer"]:
        assert callable(manifest.reader(m["name"]))


def test_import_check_compares_whole_top_level_names(monkeypatch):
    for name in ("open_duck_playground_tpu_torch", "open_duck_playground_tpu_torch.train.ppo",
                 "jax_like", "flaxen", "duckbench.ref"):
        monkeypatch.setitem(sys.modules, name, sys)
    before = run.banned_modules()
    assert not set(before) & {"open_duck_playground_tpu_torch", "jax_like", "flaxen"}
    for name, top in (("open_duck_playground_tpu.envs", "open_duck_playground_tpu"),
                      ("jax.numpy", "jax"), ("jaxlib", "jaxlib"), ("flax.linen", "flax")):
        monkeypatch.setitem(sys.modules, name, sys)
        assert top in run.banned_modules()


def test_the_benchmark_imports_no_jax():
    """Neither the harness nor its reference loads jax, flax or the JAX
    package (the modules of this process after importing all of them)."""
    import importlib
    import pkgutil
    import subprocess

    mods = [m.name for m in pkgutil.walk_packages([os.path.join(manifest.ROOT, "duckbench")],
                                                  "duckbench.")
            if ".tests" not in m.name]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "from duckbench import run\nprint(run.banned_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    assert importlib.util.find_spec("duckbench.run") is not None
