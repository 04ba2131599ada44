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

A cell whose ``chips`` is more than 1 runs as that many ranks, one card
each (``ranks.py``): the command starts them, and each runs steps 1 to 3 on
its rows of the env batch, in step with the others; rank 0's clock closes
the window, rank 0's units are traced, the followed steps are gathered on
rank 0, and rank 0 alone runs the reference and prints the result, which
the command passes on once every rank has ended well. ``setup_s`` counts
from the command's start.
"""

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Dict, Optional  # noqa: E402

from duckbench import manifest, ranks, standin  # noqa: E402

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


def window(prog, loop: str, seconds: float, device, timer: Optional[Timer] = None,
           shard=None) -> dict:
    """Whole units back to back until `seconds` have passed, then every unit
    enqueued finishes inside the window. The host waits for the card only
    at unit boundaries, keeping IN_FLIGHT units enqueued ahead of it, so
    that a stall of the host (it shares its cores with other machines) up
    to that long does not idle the card. With a `shard` of world > 1,
    ``window_ranks``."""
    import torch

    if shard is not None and shard.world > 1:
        return window_ranks(prog, loop, seconds, device, shard, timer)
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


def window_ranks(prog, loop: str, seconds: float, device, shard,
                 timer: Optional[Timer] = None) -> dict:
    """`window` on every rank of `shard`, each running the same whole units:
    after each unit rank 0 says on the stream whether its clock has passed
    `seconds` (a broadcast of one flag, copied to the host), and every rank
    reads that unit's flag when it waits for the unit, IN_FLIGHT units
    later on the card (at once on the CPU), so that all stop after the same
    unit and the host waits for nothing more than the one-card window."""
    import torch
    import torch.distributed as dist

    unit = UNITS[loop]
    cuda = torch.device(device).type == "cuda"
    ahead = IN_FLIGHT if cuda else 0
    flag = torch.zeros(1, dtype=torch.int32, device=device)
    seen = torch.zeros(ahead + 2, dtype=torch.int32, pin_memory=cuda)
    shard.barrier()
    _sync(device)
    start = time.monotonic()
    units, steps0, pending, end = 0, prog.env_steps, [], None
    while end is None or units < end:
        unit(prog, timer)
        flag.fill_(int(shard.is_main and time.monotonic() - start >= seconds))
        dist.broadcast(flag, 0)
        slot = units % len(seen)
        seen[slot:slot + 1].copy_(flag, non_blocking=cuda)
        ev = None
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
        pending.append((slot, ev))
        units += 1
        if len(pending) > ahead:
            slot, ev = pending.pop(0)
            if ev is not None:
                ev.synchronize()
            if end is None and int(seen[slot]):
                end = units
    _sync(device)
    return dict(units=units, window_s=time.monotonic() - start, env_steps=prog.env_steps - steps0)


def traced(prog, loop: str, units: int, device, shard=None) -> Optional[dict]:
    """`units` more units under torch.profiler, each part annotated, after
    one unit under it untraced (the profiler's own warm-up); the trace's
    summary (trace.summarize). The host enqueues the traced units back to
    back, as in the window, and waits for the card only after the last;
    the traced window runs from the first device operation to the last.
    The Chrome trace is written to a temporary file and deleted once read.
    With a `shard`, rank 0 is traced and every other rank runs the same
    units untraced (None)."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    from duckbench import roofline, trace

    if shard is not None and not shard.is_main:
        for _ in range(units + 1):
            UNITS[loop](prog)
        _sync(device)
        return None

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
             control: bool = False, rounding: bool = False, follow_only: bool = False,
             t0: float = T0, shard=None) -> dict:
    """One run of `cell`; returns the result line's dict (without printing).
    `cfg`, `traffic_mix` and `limits` default to the cell's files; `fault`
    plants one of faults.FAULTS in the program; `control` adds the
    control's numbers under "control", `rounding` the rounding reading's
    under "rounding" and, on many ranks, the readings of ``rank_readings``;
    `follow_only` leaves the reference's own start out (train cells: no
    env_gap); set-up is counted from `t0`. With a `shard` (ranks.join) this
    process runs its rows of the cell; on ranks other than 0 the dict holds
    only the units run ("attempted") and the rank."""
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
    world = 1 if shard is None else shard.world
    main = shard is None or shard.is_main
    if world > 1 and loop != "train":
        raise ValueError(f"{cell['name']}: only the train loop runs on more than one card")
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    with faults.planted(fault):
        prog = program.program(cfg, loop, sd, device, log=log if main else None, shard=shard)
        faults.plant_in_program(fault, prog)
        if loop == "train":
            rec = check.follow_train(prog, mix["follow"])
        else:
            sampled = traffic.sample(sd["sample"], prog.steps, mix["sampled_steps"])
            rec = check.follow_eval(prog, sampled)
        _sync(device)
        setup_s = time.monotonic() - t0
        timer = Timer(device) if with_trace else None
        win = window(prog, loop, seconds, device, timer, shard)
        parts = timer.ms() if timer is not None else {}
        summary = traced(prog, loop, mix["trace_units"], device, shard) if with_trace else None
    peak = ranks.fullest(torch.cuda.max_memory_allocated(device) if cuda else 0, shard)
    if loop == "train":
        rec = ranks.gather_train(rec, shard)
    params0 = traffic.weights(sd["weights"], program.param_shapes(cfg), device)
    program.free(prog)
    if not main:
        return {"attempted": win["units"], "rank": shard.rank}

    t_ref = time.monotonic()
    variants = {}
    if loop == "train":
        steps = mix["physics_steps"]

        def ref_train(follow_normalizer=world > 1, **kw):  # check.py: many cards follow
            return check.reference_train(cfg, sd, device, rec, steps,
                                         follow_normalizer=follow_normalizer, **kw)

        start = {} if follow_only else check.reference_start(cfg, sd, device, rec, steps)
        ref = ref_train(start=start)
        got = check.program_train(rec, steps)
        numbers = check.compare_train(got, ref, params0)
        ref_s = time.monotonic() - t_ref
        for name, on in (("control", control), ("rounding", rounding)):
            if on:
                variants[name] = check.compare_train(
                    ref_train(start={} if follow_only else None, **{name: True}), ref, params0)
        if rounding and world > 1:
            variants.update(rank_readings(got, ref, params0, world, ref_train, start))
    else:
        ref = check.reference_eval(cfg, sd, device, rec)
        numbers = check.compare_eval(check.program_eval(rec), ref)
        ref_s = time.monotonic() - t_ref
        for name, on in (("control", control), ("rounding", rounding)):
            if on:
                variants[name] = check.compare_eval(
                    check.reference_eval(cfg, sd, device, rec, **{name: True}), ref)
    correct = check.judge(numbers, limits)

    units = win["units"]
    flops = (roofline.training_step_flops(cfg) if loop == "train"
             else {k: v * (cfg["ppo"]["episode_length"] // cfg["ppo"]["action_repeat"])
                   for k, v in roofline.eval_step_flops(cfg).items()})
    ctx = dict(cfg=cfg, cell=cell, traffic=mix, loop=loop, spans=parts, trace=summary,
               window_s=win["window_s"], units=units, env_steps=win["env_steps"],
               flops_per_unit=flops, setup_s=setup_s, world=world)
    kind = "per_layer" if with_trace else "end_to_end"
    metrics = {}
    for m in manifest.cell_metrics(bench, cell["name"], kind):
        value = (E2E[m["name"].split(".")[0]](ctx) if kind == "end_to_end"
                 else manifest.reader(m["name"])(ctx))
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": world, "memory_peak_bytes": int(peak)}
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


def rank_readings(got: dict, ref: dict, params0, world: int, ref_train, start: dict) -> dict:
    """The readings of a cell on `world` ranks that its limits are set
    from, beside the rounding reading: "partials", the reference with its
    sums over envs taken as the ranks' partials in the program's place;
    "unfollowed", the program against the reference with its own
    normalizer; "partials_unfollowed", the partials' reference with its own
    normalizer against the reference with its own, the room that rounding
    alone would need without following; "leaves", grad_gap's and
    change_gap's gap of each leaf, of the program and of the partials."""
    from duckbench import check

    partials = ref_train(partials=world, start=start)
    own = ref_train(follow_normalizer=False, start=start)
    leaves = {}
    for name, side in (("program", got), ("partials", partials)):
        leaves[name] = {"grad_gap": check.leaf_gaps(side["mu1"], ref["mu1"]),
                        "change_gap": check.leaf_gaps(*check.changes(side, ref, params0))}
    return {"partials": check.compare_train(partials, ref, params0),
            "unfollowed": check.compare_train(got, own, params0),
            "partials_unfollowed": check.compare_train(
                ref_train(follow_normalizer=False, partials=world, start=start), own, params0),
            "leaves": leaves}


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
    if not cards_for(cell):
        return 3
    t0 = ranks.rank_t0()
    if cell["chips"] > 1 and t0 is None:
        code, out = ranks.launch([sys.executable, "-m", "duckbench.run", *launcher_argv(argv)],
                                 cell["chips"], ranks.run_limit_s(), T0)
        lines = out.strip().splitlines()
        if code or not lines:
            log(f"[duckbench] the ranks ended with {code}: no result")
            return code or 5
        for line in lines[:-1]:
            log(line)
        result, shard = json.loads(lines[-1]), None
    else:
        import torch

        torch.set_num_threads(1)  # the host only enqueues work: one thread, fewer neighbours
        shard = join(cell, t0)
        try:
            result = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace),
                              "cuda" if shard is None else shard.device, t0=t0 or T0,
                              shard=shard)
        finally:
            if shard is not None:
                ranks.leave()
    found = banned_modules()
    if found:
        log(f"[duckbench] the run imported {', '.join(found)}: the benchmark measures the "
            "PyTorch port alone")
        return 4
    if shard is not None and not shard.is_main:
        return 0
    report(result)
    print(json.dumps(result), flush=True)
    return 0


def launcher_argv(argv) -> list:
    return list(sys.argv[1:] if argv is None else argv)


def cards_for(cell: dict) -> bool:
    """Whether CUDA has the cards `cell` asks for (logged when it has not)."""
    try:
        import torch
    except ImportError as e:
        log(f"[duckbench] no torch: {e}")
        return False
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < cell["chips"]:
        log(f"[duckbench] {cell['name']} needs {cell['chips']} CUDA device(s); {n} available")
        return False
    return True


def join(cell: dict, t0: Optional[float], timeout_s: float = ranks.RUN_S):
    """A rank's EnvShard (None for a one-card cell's single process, whose
    `t0` is None): the stand-in scenes and caches first, then the process
    group, whose collectives raise after waiting `timeout_s`. Only rank 0
    keeps its standard output; the others' goes to standard error."""
    if t0 is None:
        return None
    world = int(os.environ["WORLD_SIZE"])
    if world != cell["chips"]:
        raise ValueError(f"a rank of a world of {world}; {cell['name']} asks for "
                         f"{cell['chips']} cards")
    if int(os.environ["RANK"]) != 0:
        sys.stdout.flush()
        os.dup2(2, 1)
    prepare()
    return ranks.join(timeout_s=timeout_s)


def report(result: dict) -> None:
    """The numbers compared beside their limits, as the last lines of
    standard error."""
    log(f"[duckbench] correct {result['correct']}")
    for k, v in result["checks"].items():
        log(f"[duckbench] check {k} {v['value']!r} limit {v['limit']!r}")


if __name__ == "__main__":
    sys.exit(main())
