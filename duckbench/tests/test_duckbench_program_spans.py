"""The readers of the program's own counts on hand-made contexts: the
kernels an SGD replay runs (its kernel and memcpy nodes, as the program
keeps them by graph name), in the flat train cell only; nothing where the
program keeps no count. CPU only."""

from __future__ import annotations

import pytest

from duckbench import manifest
from open_duck_playground_tpu_torch.utils import profiling


@pytest.fixture
def graphs(monkeypatch):
    """The program's graph counts, empty for the test."""
    monkeypatch.setattr(profiling, "_GRAPHS", {})
    return profiling


def test_sgd_graph_kernels_reads_the_sgd_graphs_kernel_nodes(graphs):
    read = manifest.reader("sgd_graph_kernels")
    assert read({"loop": "train"}) is None  # no SGD graph captured
    graphs.note_graph("[ppo] rollout", kernel_nodes=4021, memcpy_nodes=167, memset_nodes=52,
                      segments=1)
    graphs.note_graph("[ppo] SGD step", kernel_nodes=87123, memcpy_nodes=2311,
                      memset_nodes=1156, segments=1)
    assert read({"loop": "train"}) == 87123 + 2311  # memcpy nodes run as kernels; memsets not
    assert read({"loop": "eval"}) is None
    graphs.note_graph("[ppo] SGD step", kernel_nodes=90001, memcpy_nodes=3, memset_nodes=0,
                      segments=389)  # the latest capture's
    assert read({"loop": "train"}) == 90004


def test_sgd_graph_kernels_is_nothing_where_the_program_keeps_no_count(monkeypatch):
    monkeypatch.delattr(profiling, "graphs")
    assert manifest.reader("sgd_graph_kernels")({"loop": "train"}) is None


def test_the_benchmark_keeps_its_rules_with_the_new_metric():
    bench = manifest.load()
    assert manifest.validate(bench) == []
    (m,) = [m for m in bench["per_layer"] if m["name"] == "sgd_graph_kernels"]
    assert m["source"] == "program_counter" and m["moves"] == "train_env_sps"
    assert m["workloads"] == ["joystick_flat_backlash.train"]
    layers = {x["layer"] for x in bench["per_layer"] if x["name"].startswith("sgd_ms")}
    assert m["layer"] in layers
