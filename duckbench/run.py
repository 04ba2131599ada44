"""Run one cell of the benchmark once and print its result line.

    python3 -m duckbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (BENCHMARK.json names the cells). A run:

1. writes the stand-in duck's scenes into build/duckbench/assets/ of the
   checkout (fixed path; the port builds its kernel into build/kernels/);
2. builds the cell's program (``program.py``) from ``--seed`` and drives it
   through the traffic's followed steps (``check.follow_*``), which capture
   every CUDA graph the window replays: all of it is set-up (``setup_s``);
3. measures for ``--seconds``: back-to-back training steps or eval episodes,
   whole ones, the window closing at the first unit boundary past
   ``--seconds`` (the rates are over all the window's work and time);
   with ``--trace 1`` CUDA events time the parts of each unit, and after the
   window the profiler traces the traffic's ``trace_units`` more, enqueued
   back to back;
4. reads the card's peak memory, frees the program, and runs the plain
   reference over the followed steps (``check.py``): ``correct`` is whether
   every number compared is within its limit (``limits/<cell>.json``);
5. prints the result as the last line of standard output, the numbers
   compared beside their limits as the last lines of standard error.

With ``--trace 0`` the metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (each read by ``metrics/<name>.py``).
Without CUDA, or with fewer cards than the cell asks for, it exits 3 and
prints no result; it exits 4 if jax, jaxlib, flax or the JAX package has
been imported by the end. Every float32 product runs with TF32 off.
"""

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Dict, Optional  # noqa: E402

from duckbench import manifest, standin  # noqa: E402

BANNED = ("jax", "jaxlib", "flax", "open_duck_playground_tpu")
BUILD = os.path.join(manifest.ROOT, "build", "duckbench")
ASSETS = os.path.join(BUILD, "assets")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def banned_modules() -> list:
    """The banned top-level packages among the modules loaded (whole names:
    the port's package begins with the JAX package's name)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def prepare() -> None:
    """The stand-in scenes (rewritten only when the generator changed) and
    the build and kernel caches, all at fixed paths inside the checkout."""
    import fcntl
    import hashlib

    with open(standin.__file__, "rb") as f:
        stamp = hashlib.sha256(f.read()).hexdigest()
    path = os.path.join(ASSETS, ".stamp")
    os.makedirs(ASSETS, exist_ok=True)
    with open(os.path.join(BUILD, ".assets.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # processes that share a checkout write it once
        found = None
        if os.path.exists(path):
            with open(path) as f:
                found = f.read()
        if found != stamp:
            standin.write_standin(ASSETS)
            with open(path, "w") as f:
                f.write(stamp)
    os.environ["OPEN_DUCK_ASSETS"] = ASSETS
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(BUILD, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(BUILD, "triton")
    os.environ["USE_FLAX"] = "0"


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Timer:
    """CUDA events (host clock on the CPU) around named parts of a unit."""

    def __init__(self, device):
        import torch

        self.cuda = torch.device(device).type == "cuda"
        self.torch = torch
        self.marks: Dict[str, list] = {}

    def wrap(self, name: str, fn):
        def call(*a, **k):
            if self.cuda:
                e0 = self.torch.cuda.Event(enable_timing=True)
                e1 = self.torch.cuda.Event(enable_timing=True)
                e0.record()
                out = fn(*a, **k)
                e1.record()
            else:
                e0 = time.perf_counter()
                out = fn(*a, **k)
                e1 = time.perf_counter()
            self.marks.setdefault(name, []).append((e0, e1))
            return out
        return call

    def ms(self) -> Dict[str, list]:
        """Each part's milliseconds per call (after a synchronize)."""
        if self.cuda:
            return {k: [a.elapsed_time(b) for a, b in v] for k, v in self.marks.items()}
        return {k: [(b - a) * 1e3 for a, b in v] for k, v in self.marks.items()}


def _train_unit(prog, timer: Optional[Timer] = None, annotate=None):
    draws = prog.draws()
    roll, sgd = prog.roll, prog.sgd
    if timer is not None:
        roll, sgd = timer.wrap("rollout", roll), timer.wrap("sgd", sgd)
    if annotate is not None:
        roll, sgd = annotate("rollout", roll), annotate("sgd", sgd)
    prog.step(draws, roll=roll, sgd=sgd)


def _eval_unit(prog, timer: Optional[Timer] = None, annotate=None):
    reset, step = prog.reset, prog.step
    if timer is not None:
        reset, step = timer.wrap("eval_reset", reset), timer.wrap("eval_step", step)
    if annotate is not None:
        reset, step = annotate("eval_reset", reset), annotate("eval_step", step)
    carry = reset()
    for _ in range(prog.steps):
        carry = step(carry)
    prog.summary(carry)


UNITS = {"train": _train_unit, "eval": _eval_unit}
IN_FLIGHT = 4  # units enqueued ahead of the one the host waits for


def window(prog, loop: str, seconds: float, device, timer: Optional[Timer] = None) -> dict:
    """Whole units back to back until `seconds` have passed, then every unit
    enqueued finishes inside the window. The host waits for the card only
    at unit boundaries, keeping IN_FLIGHT units enqueued ahead of it, so
    that a stall of the host (it shares its cores with other machines) up
    to that long does not idle the card."""
    import torch

    unit = UNITS[loop]
    cuda = torch.device(device).type == "cuda"
    _sync(device)
    start = time.monotonic()
    units, steps0, pending = 0, prog.env_steps, []
    while time.monotonic() - start < seconds:
        unit(prog, timer)
        units += 1
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            pending.append(ev)
            if len(pending) > IN_FLIGHT:
                pending.pop(0).synchronize()
    _sync(device)
    return dict(units=units, window_s=time.monotonic() - start, env_steps=prog.env_steps - steps0)


def traced(prog, loop: str, units: int, device) -> dict:
    """`units` more units under torch.profiler, each part annotated, after
    one unit under it untraced (the profiler's own warm-up); the trace's
    summary (trace.summarize). The host enqueues the traced units back to
    back, as in the window, and waits for the card only after the last;
    the traced window runs from the first device operation to the last.
    The Chrome trace is written to a temporary file and deleted once read."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    from duckbench import roofline, trace

    def annotate(name, fn):
        def call(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return call

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    fd, path = tempfile.mkstemp(prefix="duckbench_trace_", suffix=".json")
    os.close(fd)
    _sync(device)
    with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
        UNITS[loop](prog, annotate=annotate)
        _sync(device)
        prof.step()
        with record_function(trace.WINDOW):
            for _ in range(units):
                UNITS[loop](prog, annotate=annotate)
            _sync(device)
        prof.step()
    try:
        spans, work = trace.read_trace(path)
    finally:
        os.remove(path)
    out = trace.summarize(spans, work, roofline.FUSED_KERNEL)
    out["units"] = units
    return out


def run_cell(bench: dict, cell: dict, seed: int, seconds: float, with_trace: bool, device,
             cfg: Optional[dict] = None, traffic_mix: Optional[dict] = None,
             limits: Optional[Dict[str, float]] = None, fault: Optional[str] = None,
             control: bool = False, rounding: bool = False, t0: float = T0) -> dict:
    """One run of `cell`; returns the result line's dict (without printing).
    `cfg`, `traffic_mix` and `limits` default to the cell's files; `fault`
    plants one of faults.FAULTS in the program; `control` adds the
    control's numbers under "control", `rounding` the rounding reading's
    under "rounding"; set-up is counted from `t0`."""
    import torch

    from duckbench import check, faults, program, roofline, traffic

    prepare()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg or manifest.config(bench, cell["config"])
    mix = traffic_mix or manifest.traffic(cell["traffic"])
    limits = manifest.limits(cell["name"]) if limits is None else limits
    loop = mix["loop"]
    sd = traffic.seeds(seed)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    with faults.planted(fault):
        prog = program.program(cfg, loop, sd, device, log=log)
        faults.plant_in_program(fault, prog)
        if loop == "train":
            rec = check.follow_train(prog, mix["follow"])
        else:
            sampled = traffic.sample(sd["sample"], prog.steps, mix["sampled_steps"])
            rec = check.follow_eval(prog, sampled)
        _sync(device)
        setup_s = time.monotonic() - t0
        timer = Timer(device) if with_trace else None
        win = window(prog, loop, seconds, device, timer)
        parts = timer.ms() if timer is not None else {}
        summary = traced(prog, loop, mix["trace_units"], device) if with_trace else None
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    params0 = traffic.weights(sd["weights"], program.param_shapes(cfg), device)
    program.free(prog)

    t_ref = time.monotonic()
    if loop == "train":
        ref = check.reference_train(cfg, sd, device, rec, mix["physics_steps"])
        numbers = check.compare_train(check.program_train(rec, mix["physics_steps"]), ref, params0)
    else:
        ref = check.reference_eval(cfg, sd, device, rec)
        numbers = check.compare_eval(check.program_eval(rec), ref)
    ref_s = time.monotonic() - t_ref
    variants = {}
    for name, on in (("control", control), ("rounding", rounding)):
        if not on:
            continue
        kw = {name: True}
        if loop == "train":
            got = check.reference_train(cfg, sd, device, rec, mix["physics_steps"], **kw)
            variants[name] = check.compare_train(got, ref, params0)
        else:
            variants[name] = check.compare_eval(check.reference_eval(cfg, sd, device, rec, **kw),
                                                ref)
    correct = check.judge(numbers, limits)

    units = win["units"]
    flops = (roofline.training_step_flops(cfg) if loop == "train"
             else {k: v * (cfg["ppo"]["episode_length"] // cfg["ppo"]["action_repeat"])
                   for k, v in roofline.eval_step_flops(cfg).items()})
    ctx = dict(cfg=cfg, cell=cell, traffic=mix, loop=loop, spans=parts, trace=summary,
               window_s=win["window_s"], units=units, env_steps=win["env_steps"],
               flops_per_unit=flops, setup_s=setup_s)
    kind = "per_layer" if with_trace else "end_to_end"
    metrics = {}
    for m in manifest.cell_metrics(bench, cell["name"], kind):
        value = (E2E[m["name"].split(".")[0]](ctx) if kind == "end_to_end"
                 else manifest.reader(m["name"])(ctx))
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": units, "failed": 0, "metrics": metrics,
              "device": dev}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result.update(variants)
    result["reference_s"] = ref_s
    result["checks"] = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    return result


# the end-to-end metrics, taken by the benchmark itself on the host's clock;
# a metric named <stem>.<part> (a split of one quantity over kinds of cell,
# each with a bound of its own) is its stem's
E2E = {
    "train_env_sps": lambda ctx: ctx["env_steps"] / ctx["window_s"] if ctx["loop"] == "train"
    else None,
    "eval_env_sps": lambda ctx: ctx["env_steps"] / ctx["window_s"] if ctx["loop"] == "eval"
    else None,
    "setup_s": lambda ctx: ctx["setup_s"],
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        log("[duckbench] --seed must be a whole number >= 0")
        return 2
    bench = manifest.load()
    errs = manifest.validate(bench)
    if errs:
        log("[duckbench] BENCHMARK.json breaks the benchmark's rules:\n  " + "\n  ".join(errs))
        return 2
    cell = manifest.workload(bench, args.workload)
    try:
        import torch
    except ImportError as e:
        log(f"[duckbench] no torch: {e}")
        return 3
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"[duckbench] {args.workload} needs {cell['chips']} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 3
    torch.set_num_threads(1)  # the host only enqueues work: one thread, fewer neighbours
    result = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace), "cuda")
    found = banned_modules()
    if found:
        log(f"[duckbench] the run imported {', '.join(found)}: the benchmark measures the "
            "PyTorch port alone")
        return 4
    log(f"[duckbench] correct {result['correct']}")
    for k, v in result["checks"].items():
        log(f"[duckbench] check {k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
