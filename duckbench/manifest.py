"""BENCHMARK.json and the files it names, found by name.

Every configuration, traffic mix, per-layer metric and set of correctness
limits is a file of its own under this folder, so that a cell or a metric is
added by adding files and entries, not by editing what is here:

- ``configs/<config>.json``: a configuration as it is run (the manifest
  names the file);
- ``traffic/<traffic>.json``: a traffic mix, read by ``traffic.py``;
- ``metrics/<metric>.py``: the reader of one per-layer metric, a function
  ``read(ctx)`` that returns a number or None (nothing to read);
- ``limits/<cell>.json``: the limits of the numbers a cell's correctness
  check compares, with the readings they were set from.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import Any, Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = ("command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer")
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
WORKLOAD_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
E2E_SOURCES = ("host_clock", "device_trace")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
# a width never names a cut (the contract's list; scale keys may be cut)
_WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|expansion|_dim$|_rank$)")


def load(path: str = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def _line(s: Any, most: int = 200) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= most and "\n" not in s and "\t" not in s


def validate(bench: dict, root: str = ROOT) -> List[str]:
    """Every way `bench` breaks the benchmark's rules, as sentences (empty
    when it keeps them): keys, names, units, sources, bounds, `moves` and
    `workloads` that point at nothing, files outside `paths` or missing,
    more four-chip cells than a quarter of the cells (one always may), and
    cells that report no setup_s, no other end-to-end metric or no
    per-layer metric."""
    errs: List[str] = []
    if sorted(bench) != sorted(TOP_KEYS):
        errs.append(f"top-level keys {sorted(bench)} are not {sorted(TOP_KEYS)}")
        return errs
    paths = bench["paths"]
    if not (isinstance(paths, list) and 1 <= len(paths) <= 16
            and all(isinstance(p, str) and PATH.match(p) and not p.startswith("/")
                    and ".." not in p.split("/") for p in paths)):
        errs.append(f"paths {paths!r}: 1 to 16 relative directories")
    cmd = bench["command"]
    if not (isinstance(cmd, list) and 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)):
        errs.append("command: a list of at most 32 one-line words")
    rs = bench["run_seconds"]
    if not (isinstance(rs, int) and not isinstance(rs, bool) and 1 <= rs <= 51):
        errs.append(f"run_seconds {rs!r}: a whole number from 1 to 51")

    def under_paths(f: str) -> bool:
        return any(f == p or f.startswith(p.rstrip("/") + "/") for p in paths)

    names: Dict[str, str] = {}

    def name_ok(kind: str, n: Any) -> bool:
        if not (isinstance(n, str) and NAME.match(n)):
            errs.append(f"{kind} name {n!r} is not a name")
            return False
        if n in names and names[n] == kind:
            errs.append(f"two {kind}s are named {n}")
        names.setdefault(n, kind)
        return True

    configs = bench["configs"]
    if not (isinstance(configs, list) and 1 <= len(configs) <= 24):
        errs.append("configs: 1 to 24 entries")
        configs = []
    files = set()
    for c in configs:
        if set(c) != CONFIG_KEYS:
            errs.append(f"config {c.get('name')}: keys {sorted(c)} are not {sorted(CONFIG_KEYS)}")
            continue
        name_ok("config", c["name"])
        for k in ("source", "why"):
            if not _line(c[k]):
                errs.append(f"config {c['name']}: {k} is not one line of 1 to 200 characters")
        f = c["file"]
        if not (isinstance(f, str) and under_paths(f) and os.path.isfile(os.path.join(root, f))):
            errs.append(f"config {c['name']}: file {f!r} is not a file under paths")
        if f in files:
            errs.append(f"config {c['name']}: file {f} is another configuration's")
        files.add(f)
        red = c["reduced"]
        if not (isinstance(red, list) and len(red) <= 16 and all(
                isinstance(k, str) and NAME.match(k) for k in red)):
            errs.append(f"config {c['name']}: reduced is not a list of at most 16 names")
        elif any(_WIDTH.search(k) for k in red):
            errs.append(f"config {c['name']}: reduced names a width")

    cells = bench["workloads"]
    if not (isinstance(cells, list) and 1 <= len(cells) <= 24):
        errs.append("workloads: 1 to 24 cells")
        cells = []
    cfg_names = {c.get("name") for c in configs}
    pairs = set()
    for w in cells:
        if set(w) != WORKLOAD_KEYS:
            errs.append(f"workload {w.get('name')}: keys {sorted(w)} are not "
                        f"{sorted(WORKLOAD_KEYS)}")
            continue
        name_ok("workload", w["name"])
        if not (isinstance(w["traffic"], str) and NAME.match(w["traffic"])):
            errs.append(f"workload {w['name']}: traffic {w['traffic']!r} is not a name")
        elif not os.path.isfile(traffic_path(w["traffic"], root)):
            errs.append(f"workload {w['name']}: no traffic file for {w['traffic']}")
        if w["config"] not in cfg_names:
            errs.append(f"workload {w['name']}: config {w['config']} is not in configs")
        if w["chips"] not in (1, 4):
            errs.append(f"workload {w['name']}: chips {w['chips']!r} is not 1 or 4")
        if not _line(w["why"]):
            errs.append(f"workload {w['name']}: why is not one line of 1 to 200 characters")
        if (w["config"], w["traffic"]) in pairs:
            errs.append(f"workload {w['name']}: its config and traffic are another cell's")
        pairs.add((w["config"], w["traffic"]))
        if not os.path.isfile(limits_path(w["name"], root)):
            errs.append(f"workload {w['name']}: no limits file")
    four = [w.get("name") for w in cells if w.get("chips") == 4]
    if len(four) > max(1, len(cells) // 4):
        errs.append(f"workloads {four} ask for 4 chips: at most a quarter of the cells, "
                    "rounded down, or one")
    used = {w.get("config") for w in cells}
    for c in configs:
        if c.get("name") not in used:
            errs.append(f"config {c.get('name')} is used by no cell")
    cell_names = {w.get("name") for w in cells}

    e2e = bench["end_to_end"]
    layer = bench["per_layer"]
    if not (isinstance(e2e, list) and 1 <= len(e2e) <= 16):
        errs.append("end_to_end: 1 to 16 metrics")
        e2e = []
    if not (isinstance(layer, list) and 1 <= len(layer) <= 128):
        errs.append("per_layer: 1 to 128 metrics")
        layer = []
    e2e_names = set()
    for m in e2e + layer:
        is_e2e = m in e2e
        keys = (E2E_KEYS if is_e2e else LAYER_KEYS)
        if not (keys <= set(m) <= keys | {"workloads"}):
            errs.append(f"metric {m.get('name')}: keys {sorted(m)} are not {sorted(keys)} "
                        f"(and workloads)")
            continue
        name_ok("metric", m["name"])
        if not (isinstance(m["unit"], str) and UNIT.match(m["unit"])):
            errs.append(f"metric {m['name']}: unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            errs.append(f"metric {m['name']}: better {m['better']!r}")
        if m["source"] not in (E2E_SOURCES if is_e2e else SOURCES):
            errs.append(f"metric {m['name']}: source {m['source']!r}")
        if "workloads" in m and not (isinstance(m["workloads"], list) and m["workloads"]
                                     and set(m["workloads"]) <= cell_names):
            errs.append(f"metric {m['name']}: workloads name cells that do not exist")
        if is_e2e:
            e2e_names.add(m["name"])
            b = m["bound"]
            if not (isinstance(b, (int, float)) and 0.01 <= b <= 0.25):
                errs.append(f"metric {m['name']}: bound {b!r} is not in [0.01, 0.25]")
        else:
            if not _line(m["layer"]):
                errs.append(f"metric {m['name']}: layer is not one line")
            if not os.path.isfile(reader_path(m["name"], root)):
                errs.append(f"metric {m['name']}: no reader metrics/{m['name']}.py")
    if "setup_s" not in e2e_names:
        errs.append("no setup_s among the end-to-end metrics")
    for m in layer:
        if isinstance(m, dict) and m.get("moves") not in e2e_names:
            errs.append(f"metric {m.get('name')}: moves {m.get('moves')!r} is no end-to-end metric")
    for w in cells:
        if "name" not in w:
            continue
        rep = [m["name"] for m in e2e if reports(m, w["name"])]
        if "setup_s" not in rep or len(rep) < 2:
            errs.append(f"workload {w['name']}: reports {rep}, not setup_s and another")
        if not any(reports(m, w["name"]) for m in layer):
            errs.append(f"workload {w['name']}: reports no per-layer metric")
        for m in layer:
            if reports(m, w["name"]) and not any(
                    e["name"] == m.get("moves") and reports(e, w["name"]) for e in e2e):
                errs.append(f"metric {m['name']} in {w['name']}: moves a metric the cell "
                            "does not report")
    return errs


def reports(metric: dict, cell: str) -> bool:
    """Whether `metric` is reported in the cell named `cell`."""
    return "workloads" not in metric or cell in metric["workloads"]


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: str = ROOT) -> dict:
    """The configuration `name` as its file holds it."""
    for c in bench["configs"]:
        if c["name"] == name:
            with open(os.path.join(root, c["file"])) as f:
                return json.load(f)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic_path(name: str, root: str = ROOT) -> str:
    return os.path.join(root, "duckbench", "traffic", f"{name}.json")


def traffic(name: str, root: str = ROOT) -> dict:
    with open(traffic_path(name, root)) as f:
        return json.load(f)


def limits_path(cell: str, root: str = ROOT) -> str:
    return os.path.join(root, "duckbench", "limits", f"{cell}.json")


def limits(cell: str, root: str = ROOT) -> Dict[str, float]:
    """{number: limit} of the cell's correctness check."""
    with open(limits_path(cell, root)) as f:
        return {k: float(v["limit"]) for k, v in json.load(f)["numbers"].items()}


def reader_path(metric: str, root: str = ROOT) -> str:
    return os.path.join(root, "duckbench", "metrics", f"{metric}.py")


def reader(metric: str, root: str = ROOT) -> Callable[[dict], Optional[float]]:
    """The `read(ctx)` function of the metric's own file, loaded by path (a
    metric's name may hold dots)."""
    path = reader_path(metric, root)
    spec = importlib.util.spec_from_file_location(f"duckbench_metric_{len(path)}_{abs(hash(path))}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, kind: str) -> List[dict]:
    """The metrics of `kind` ("end_to_end" or "per_layer") the cell reports."""
    return [m for m in bench[kind] if reports(m, cell)]
