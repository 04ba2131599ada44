"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py    # build, kernel vs twin, main path

Phases:
1. build the fused physics kernel (ops/csrc/physics_step.cu) with nvcc into
   build/kernels/, or reuse an earlier build of the same source; print
   ptxas' registers, stack and spills, and the launch geometry at each main
   path's shape (shared bytes per env, envs per block, resident blocks per
   SM, waves);
2. kernel vs its plain PyTorch version ("twin", ops/lane_physics.py) on the
   card: the step variant (10 substeps) and the init variant (1 substep)
   from settled stand-in states, and the init variant from tilted ones
   (its kinematic outputs only), at 1024 and 4096 envs, DR off and on, the
   backlash scene at 1024, and the heightfield scenes: rough at 1024 (DR
   off and on) and 8192 (DR on), the 64x64 judge scene at 1024. For each
   output (the accelerometer apart from the other sensors), |kernel - twin|
   q50 / q95 / worst column's q95 / max. Fails on any non-finite value or
   on any of these above its limit (tests/duck_standin.py, PARITY_LIMITS
   and, for the heightfield scenes, ROUGH_PARITY_LIMITS: the step variant's
   q50 no looser than 10x the TPU kernel's q50 in the JAX package's
   kernel-vs-eager table, RESULTS.md; the init variant's site_xpos /
   site_xmat / contact_dist also within 1e-4);
3. the flat main path: TrainEnv(Joystick("flat_terrain", device="cuda"),
   num_envs=4096, DR on), reset, then 100 steps of random actions. Checks
   the kernel's launch count (1 for the reset + 100), the obs shapes, that
   everything is finite; prints env-steps/s and the kernel's and the twin's
   time for one control step at 4096 envs;
3b. the rough main path: the same with Joystick("rough_terrain_backlash")
   at 8192 envs, through the kernel's heightfield branch.

The kernels line gives, per kernel, its launches on its main path, its
largest |kernel - twin| there (step variant, DR on, all outputs), its time
and the twin's for one control step, and its bound: the larger of the
twin's arithmetic (counted per env and substep on the CPU under a torch
dispatch mode, both sides of every `where` included) over the H100's 67
TFLOP/s of float32 and the bytes it must move (state, DR fields, table and
outputs, each once) over 3.35 TB/s.

Assets: $OPEN_DUCK_ASSETS if set, else the generated stand-in duck
(tests/duck_standin.py), written into build/standin_assets/.

Exits non-zero, printing no result, if CUDA is unavailable or any phase
fails. The last line of stdout is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
# phase 2: (task, envs, DR on)
CASES = (("flat_terrain", 1024, False), ("flat_terrain", 1024, True),
         ("flat_terrain", 4096, False), ("flat_terrain", 4096, True),
         ("flat_terrain_backlash", 1024, True),
         ("rough_terrain_backlash", 1024, False), ("rough_terrain_backlash", 1024, True),
         ("rough_terrain_backlash", 8192, True), ("rough_judge_backlash", 1024, True))
# main paths: (task, envs); DR on, 100 steps of random actions
FLAT_MAIN, ROUGH_MAIN = ("flat_terrain", 4096), ("rough_terrain_backlash", 8192)
N_STEPS = 100
PEAK_F32_FLOPS, PEAK_BYTES_PER_S = 67e12, 3.35e12  # H100 SXM, non-tensor float32; HBM3
# the arithmetic aten ops the bound counts (each output element one operation)
ARITH_OPS = frozenset((
    "add", "sub", "rsub", "mul", "div", "neg", "abs", "sqrt", "reciprocal", "sin", "cos",
    "exp2", "floor", "sign", "maximum", "minimum", "clamp", "clamp_min", "clamp_max", "where",
    "lt", "le", "gt", "ge", "eq", "ne", "bitwise_and", "bitwise_or", "bitwise_not"))


def log(*a):
    print(*a, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def standin():
    """tests/duck_standin.py, loaded by file path: an installed top-level
    `tests` package would shadow ours."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "duck_standin", os.path.join(ROOT, "tests", "duck_standin.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def asset_root() -> str:
    root = os.environ.get("OPEN_DUCK_ASSETS")
    if root:
        return root
    root = standin().write_standin(os.path.join(ROOT, "build", "standin_assets"))
    os.environ["OPEN_DUCK_ASSETS"] = root
    return root


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def phase_build():
    """Build the kernel, print ptxas' report and, for each main path's
    shape, the launch geometry: shared memory per env, envs (warps) per
    block, resident blocks per SM and waves."""
    from open_duck_playground_tpu_torch.mjcf import compile_mjcf
    from open_duck_playground_tpu_torch.models.open_duck_mini_v2 import constants
    from open_duck_playground_tpu_torch.ops import cuda_step

    t0 = time.perf_counter()
    so = cuda_step.build_library()
    log(f"[build] {os.path.relpath(so, ROOT)} in {time.perf_counter() - t0:.2f} s")
    with open(so + ".log") as f:
        for line in f.read().splitlines():
            if "registers" in line or "stack" in line or "spill" in line:
                log(f"[build] ptxas: {line.strip()}")
    log(f"[build] limits {cuda_step.kernel_limits()}")
    for task, B in (FLAT_MAIN, ROUGH_MAIN):
        fp = cuda_step.FusedPhysics(compile_mjcf(constants.task_to_xml(task), timestep=0.002))
        geo = fp.geometry(B, torch.device("cuda"))
        log(f"[build] geometry {task} B={B}: {fp.packed()['layout']['env_bytes']} shared bytes "
            f"per env, {geo['envs_per_block']} envs per block, {geo['blocks_per_sm']} blocks "
            f"({geo['warps_per_sm']} warps) resident per SM of {geo['sms']}, {geo['blocks']} "
            f"blocks in {geo['waves']} waves")


def phase_kernel_vs_twin(cases, report) -> bool:
    """Kernel vs twin in each case: the step and init variants from settled
    states, and the init variant from tilted states. Fills `report` with the
    parity readings and returns whether all are within their limits."""
    from open_duck_playground_tpu_torch.envs import randomize
    from open_duck_playground_tpu_torch.mjcf import compile_mjcf
    from open_duck_playground_tpu_torch.models.open_duck_mini_v2 import constants
    from open_duck_playground_tpu_torch.ops.cuda_step import FusedPhysics, flatten_dr_fields

    sd = standin()
    dev = torch.device("cuda")
    ok = True
    for task, B, with_dr in cases:
        rough = "rough" in task
        m = compile_mjcf(constants.task_to_xml(task), timestep=0.002)
        fp = FusedPhysics(m)
        accel = int(m.sensor_adr[m.sensor("accelerometer")])
        states = {name: [torch.from_numpy(x).to(dev) for x in make(
            m.keyframe("home"), m.nq, m.nv, m.nu, B, seed=B + int(with_dr))]
            for name, make in (("settled", sd.settled_states), ("tilted", sd.tilted_states))}
        dr = None
        if with_dr:
            g = torch.Generator(device=dev).manual_seed(7)
            dr = flatten_dr_fields(randomize.domain_randomize(m.to(dev), B, g))
        for variant, n, start in (("step", 10, "settled"), ("init", 1, "settled"),
                                  ("tilted", 1, "tilted")):
            qpos, qvel, ctrl = states[start]
            warm = torch.zeros_like(qvel)
            out_k = fp(qpos, qvel, warm, ctrl, n, dr)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out_p = fp.plain(qpos, qvel, warm, ctrl, n, dr)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            tag = f"{task} B={B} dr={int(with_dr)} {variant}"
            if variant == "step":
                ms = cuda_ms(lambda: fp(qpos, qvel, warm, ctrl, n, dr), reps=10)
                log(f"[time] {tag}: kernel {ms:.3f} ms, twin {plain_ms:.1f} ms per control step")
            log(f"[parity] {tag}")
            log("| field | q50 | q95 | worst col q95 (col) | max | |twin| q95 | |")
            log("|---|---|---|---|---|---|---|")
            np_k, np_p = (sd.parity_outputs({k: v.cpu() for k, v in o.items()}, accel)
                          for o in (out_k, out_p))
            for f in sd.parity_limits(variant, with_dr, rough):
                r = sd.parity(np_k[f], np_p[f], variant, with_dr, f, rough)
                ok &= r["ok"]
                flips = f", {r['flips']} flips" if r["flips"] else ""
                log(f"| {f} | {r['q50']:.1e} | {r['q95']:.1e} | {r['col_q95']:.1e} ({r['col']}) "
                    f"| {r['max']:.1e}{flips} | {r['scale']:.1e} | {'OK' if r['ok'] else 'FAIL'} |")
                report.setdefault(tag, {})[f] = r
    return ok


def flops_per_env_substep(fp, dr) -> float:
    """The twin's arithmetic for one substep of `fp`'s scene, per env:
    output elements of the ARITH_OPS aten ops, counted at 4 envs on the
    CPU (both sides of every `where` included)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    m, n = fp.model, 4
    sd = standin()
    qpos, qvel, ctrl = (torch.from_numpy(x) for x in sd.settled_states(
        m.keyframe("home"), m.nq, m.nv, m.nu, n))
    dr_cpu = None if dr is None else {k: v[:n].cpu() for k, v in dr.items()}

    class Count(TorchDispatchMode):
        flops = 0.0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket.__name__.rstrip("_") in ARITH_OPS:
                Count.flops += out.numel() / n
            return out

    with Count():
        fp.plain(qpos, qvel, torch.zeros_like(qvel), ctrl, 1, dr_cpu)
    return Count.flops


def step_bound(fp, B: int, n_substeps: int, dr, per_env_substep: float) -> dict:
    """The least time the card could take for one call of `fp` at B envs,
    n_substeps, with these DR fields: the larger of its arithmetic over
    the float32 peak and its bytes (state in, DR fields, heightfield table,
    outputs, each once) over the memory rate."""
    m = fp.model
    words_per_env = m.nq + 2 * m.nv + m.nu + sum(fp.out_widths().values())
    if dr is not None:
        words_per_env += sum(v.shape[1] for v in dr.values())
    table = 0 if m.hfield_data is None else m.hfield_data.numel()
    nbytes = 4 * (B * words_per_env + table)
    flops = per_env_substep * B * n_substeps
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return dict(flops_per_env_substep=per_env_substep, flops=flops, bytes=nbytes,
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def phase_main_path(task: str, B: int) -> dict:
    """TrainEnv(Joystick(task), B envs, DR on): reset, then N_STEPS steps of
    random actions, with the kernel's launch count set to 0 just before and
    read just after; then one control step at this shape timed, kernel vs
    twin, and its bound."""
    from open_duck_playground_tpu_torch.envs import randomize
    from open_duck_playground_tpu_torch.envs.joystick import Joystick
    from open_duck_playground_tpu_torch.envs.wrapper import TrainEnv
    from open_duck_playground_tpu_torch.ops.cuda_step import flatten_dr_fields

    dev = torch.device("cuda")
    env = Joystick(task, device=dev, seed=0)
    te = TrainEnv(env, num_envs=B, episode_length=1000,
                  randomization_fn=randomize.domain_randomize,
                  randomization_generator=torch.Generator(device=dev).manual_seed(0))
    g = torch.Generator(device=dev).manual_seed(2)
    actions = torch.rand((N_STEPS, B, env.action_size), generator=g, device=dev) * 2 - 1

    env.physics.launches = 0
    t0 = time.perf_counter()
    state = te.reset(torch.Generator(device=dev).manual_seed(1))
    torch.cuda.synchronize()
    t_reset = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(N_STEPS):
        state = te.step(state, actions[i])
    torch.cuda.synchronize()
    t_steps = time.perf_counter() - t0
    launches = env.physics.launches

    finite = all(bool(torch.isfinite(v).all()) for v in (
        *state.obs.values(), state.reward, state.data.qpos))
    shapes = {k: tuple(v.shape) for k, v in state.obs.items()}
    rate = B * N_STEPS / t_steps
    log(f"[main] {task} B={B}: reset {t_reset:.3f} s; {N_STEPS} steps {t_steps:.3f} s; "
        f"env-steps/s {rate:.1f}; launches {launches}; obs {shapes}; "
        f"done {float(state.done.mean()):.3f}; finite {finite}")
    ok = (launches == 1 + N_STEPS and shapes == {"state": (B, 101), "privileged_state": (B, 212)}
          and finite)

    # one control step at the main path's shape: kernel vs twin, same inputs
    data = state.data
    dr = flatten_dr_fields(te.model)
    args = (data.qpos.contiguous(), data.qvel.contiguous(),
            data.qacc_warmstart.contiguous(), data.ctrl.contiguous(), env.n_substeps, dr)
    per_env_substep = flops_per_env_substep(env.physics, dr)
    timed = {}
    for variant, n in (("step", env.n_substeps), ("init", 1)):
        ms = cuda_ms(lambda: env.physics(*args[:4], n, dr), reps=20)
        t0 = time.perf_counter()
        env.physics.plain(*args[:4], n, dr)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        bound = step_bound(env.physics, B, n, dr, per_env_substep)
        log(f"[main] {task}: {variant} variant ({n} substeps) at {B} envs (DR on): kernel "
            f"{ms:.3f} ms, twin {plain_ms:.1f} ms; bound {bound['bound_ms']:.4f} ms by "
            f"{bound['bound_by']} ({per_env_substep:.0f} flops per env and substep, "
            f"{bound['flops']:.4g} flops, {bound['bytes']} bytes)")
        timed[variant] = dict(ms=ms, plain_ms=plain_ms, **bound)
    return dict(ok=ok, launches=launches, rate=rate, **timed["step"])


def kernel_entry(name: str, replaces: str, main: dict, report: dict, case: str) -> dict:
    """One entry of the kernels line: launches, times and bound from the
    main path's run; max_abs_err from phase 2's step variant at the main
    path's shape, over all outputs (contact_dist over slots valid on both
    sides: a slot valid on one side only reads 1e10 on the other)."""
    rs = report[case]
    worst = max(rs, key=lambda f: rs[f]["max"])
    return {
        "name": name,
        "route": "cuda",
        "source": "open_duck_playground_tpu_torch/ops/csrc/physics_step.cu",
        "replaces": replaces,
        "launches": main["launches"],
        "max_abs_err": rs[worst]["max"],
        "max_abs_err_of": f"{case}: step variant, all outputs; largest in {worst}",
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,  # no PyTorch call computes a physics step
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"[env] gpu {gpu_line()}")
    log(f"[env] assets {asset_root()}")

    phase_build()
    report = {}  # {case: {field: parity reading}}
    ok = phase_kernel_vs_twin(CASES, report)
    flat = phase_main_path(*FLAT_MAIN)
    rough = phase_main_path(*ROUGH_MAIN)
    if not (ok and flat["ok"] and rough["ok"]):
        log("[chip_smoke] FAILED")
        return 1
    log(json.dumps({"kernels": [
        kernel_entry("fused_physics_step", "open_duck_playground_tpu/ops/pallas_step.py:225",
                     flat, report, f"{FLAT_MAIN[0]} B={FLAT_MAIN[1]} dr=1 step"),
        kernel_entry("fused_physics_step_hfield",
                     "open_duck_playground_tpu/ops/pallas_step.py:225 (has_hf=True)",
                     rough, report, f"{ROUGH_MAIN[0]} B={ROUGH_MAIN[1]} dr=1 step"),
    ]}))
    log(gpu_line())
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
