"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py    # build, kernel vs twin, main path

Phases:
1. build the fused physics kernel (ops/csrc/physics_step.cu) with nvcc into
   build/kernels/, or reuse an earlier build of the same source; print
   ptxas' registers, stack and spills, and the launch geometry at each main
   path's shape (shared bytes per env, envs per block, resident blocks per
   SM, waves);
2. kernel vs its plain PyTorch version ("twin", ops/lane_physics.py) on the
   card: the step variant (SIDE_SUBSTEPS substeps; at the main paths'
   shapes with DR on, flat 4096 and rough 8192, phase 3 holds a whole
   control step instead) and the init variant (1 substep) from settled
   stand-in states, and the init variant from tilted ones
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
   num_envs=4096, DR on), reset, then 100 steps of random actions, first
   eagerly (TrainEnv.step), then from the same reset and generator states
   through an EnvStepProgram (one CUDA graph replay per step). Checks the
   kernel's launch count in each run (1 for the reset + 100), the two final
   states and the env generator's states equal bit for bit, the obs
   shapes, that everything is finite, one graph launch per captured step;
   prints env-steps/s of both runs, host launches per env step of each
   (GRAPH_TRACE_STEPS steps under the profiler) and the kernel's and the
   twin's time for one control step at 4096 envs from the main path's last
   state, whose outputs must agree within phase 2's limits (the kernels
   line's max_abs_err);
3b. the rough main path: the same with Joystick("rough_terrain_backlash")
   at 8192 envs, through the kernel's heightfield branch;
4a. the optimizer's kernel (ops/csrc/adam.cu, optim.clip_and_adam) against
   the plain functions (clip_by_global_norm + adam) at the recipe's 16
   parameter tensors, bit for bit over 3 steps, with the clip, without it,
   and on gradient views no tensor of which is 16-byte aligned; its time
   per launch, the fused and the plain step's and torch.optim.Adam's fused
   step's, each from calls recorded in one CUDA graph (phase_optimizer);
   then the GAE kernel (ops/csrc/gae.cu, ppo.gae) against the plain
   compute_gae on the same card tensors at the recipe's unroll x batch and
   an unaligned shape, with both kinds of episode end and a NaN, bit for bit
   eagerly and replayed in a graph; its time per launch and the plain
   path's, from calls recorded in one CUDA graph (phase_gae); then the
   swish's two kernels (ops/csrc/swish.cu, networks.swish) against torch's
   x * sigmoid(x) and its autograd gradient at the SGD step's largest
   activation, [5120, 512], with special values, bit for bit; each kernel's
   time per launch against its bound by bytes and against the plain torch
   kernels it replaces (2 forward, 4 backward), from calls recorded in one
   CUDA graph on inputs rotated past the L2 cache; its ptxas report
   (phase_swish);
4. the trainer: first the captured SGD step against its eager body
   (sgd_graph_vs_eager: SGD_GRAPH_STEPS steps at the recipe's widths,
   equal bit for bit; host launches per minibatch step, capture seconds,
   graph pool bytes) and the captured rollout against the eager one
   (rollout_graph_vs_eager: ROLLOUT_GRAPH_ROLLOUTS rollouts at the recipe's
   widths, states, Transitions and generator states bit for bit); then
   OpenDuckMiniV2Runner (--env joystick --task
   flat_terrain_backlash, on cuda) and ppo.train with the runner's recipe and
   callbacks (checkpoint + ONNX at every eval) and profile_breakdown=True, at
   8192 DR envs, batch 256 x 32 minibatches, unroll 20, 4 updates per batch,
   (512, 256, 128) networks, 1024 eval envs, 3 evals, 655,360 env steps (2
   epochs x 2 training steps). Checks finite training/* and eval/* metrics
   at every epoch (metrics.jsonl), the normalizer's count and env_steps, the
   kernel launches of the train env and of the eval env against the count
   the code gives, that the last (normalizer, params) checkpoint acts
   bit-identically, the optimizer and GAE kernels' launches (one each per
   minibatch step), the swish kernels' launches per replay of each captured
   program (3 per policy or value forward at the recipe's widths, 3 per
   backward: 60 per rollout, 1,920 per SGD step, 3 per eval step), that the exported ONNX (numpy interpreter) matches the
   policy on the card within 1e-5, and that the last full-state checkpoint
   loads back tensor for tensor; then holds the kernel against its twin on
   this path's inputs (trainer_vs_twin): the train env at 8192 envs with
   train()'s DR draw (reset, and a whole control step from the trained
   state of that checkpoint) and the eval env at 1024 envs, DR off (reset,
   and a control step after 20 steps of the trained policy), within
   duck_standin.TRAINER_PARITY_LIMITS; every rollout, SGD
   step and eval step of the run is one replay of train()'s
   RolloutProgram, SGDStepProgram and EvalStepProgram; the first
   EVAL_CHECK_STEPS steps of one eval of the trained policy by run_eval,
   eager against captured (eval_graph_vs_eager), have every metric equal;
   then exact resume through
   the graphs (resume_vs_run): the runner from the same argv with
   --auto_resume in a fresh directory holding only the run's
   full_00000.npz recaptures every graph and trains epoch 1, and its
   metrics line, params, Adam state and normalizer (and the whole full
   state) equal the run's bit for bit. Prints training/sps per
   epoch, the profile_breakdown line (rollout_s, sgd_s, training_step_s,
   eval_s, each graph's capture seconds and pool bytes).
5. the env-sharded trainer: the same runner and recipe under
   `python -m torch.distributed.run`, 8192 DR envs split over the ranks:
   world 2 sharing the one card over gloo, as train() runs it (every
   rollout and eval step one graph replay, every SGD step a chain of
   graph segments with the collectives between them) and once more with
   the eager bodies asked for by name (eager_bodies: the parent's path,
   for its numbers in the same call; one epoch of 2 training steps,
   SHARDED_ARGS), and, where the machine has two
   cards or more, world min(cards, 4) over NCCL. Each rank (this script
   with --rank-worker) checks and reports: (a) its train env's and eval
   env's kernel launches against the count the code gives, with each
   replay's fused launches (launches_per_replay: 20 per rollout, 1 per
   eval step), the launches the host makes itself, each on its own
   8192/world (1024/world) rows on its own device, the graph replays, the
   collectives per SGD step, with the launch geometry; (b) the params
   identical on every rank (train() checks params, Adam state,
   normalizer and generators after every epoch); (c) one training step
   from the same init and global draws at world 1 (eager rollout, captured
   SGD step) and at this world size through the eager bodies and through
   the graphs: the graphs against the eager bodies bit for bit
   (transitions, env state, params, Adam state, normalizer, loss terms,
   generators), and against world 1 the normalizer count and env_steps
   exactly, the first rollout's transitions and the params after the step
   within SHARDED_LIMITS; (d) on rank 0, the kernel against its twin on
   its rows of the trained state (step variant, DR on;
   TRAINER_PARITY_LIMITS, 0); (e) the full state rank 0 wrote holds all
   8192 rows, and each rank's rows of a gathered full state equal its live
   state; (f) training/sps per epoch, profile_breakdown per rank (rollout_s,
   sgd_s, eval_s, collectives per SGD step and their time), each SGD
   segment's capture seconds and the shared pool's bytes, one more
   training step traced on each rank (host calls, graph replays and
   collectives per SGD step, device ms, the fused kernel's ms inside the
   rollout replay, the card's idle share as this rank's trace sees it),
   and each rank's kernel time at its rows, ranks timed in turn. The eager
   run reports (a), (b) and the traced step.

8. the general pipeline (ops/forward.py): TrainEnv(Joystick(task,
   physics="pipeline")) at the main paths' shapes (flat 4096, rough 8192,
   DR on): a reset, then PIPELINE_STEPS timed steps of random actions,
   printing ms per control step, the kernel's launches on that env (must be
   0) and the peak of torch.cuda.max_memory_allocated, beside the same run
   of the kernel's env (physics="kernel"); the pipeline run again from the
   same reset and generator states as replays of an EnvStepProgram (one
   CUDA graph per control step): final states and env generator bit for
   bit, 0 kernel launches, and both ways ms per control step, env-steps/s,
   host calls, kernels and device ms per step (one traced step each way),
   the card's idle share, the capture's seconds and pool bytes, peak
   memory; then the pipeline against the kernel from settled states with
   one DR draw: forward.init against the init variant on the kinematic
   outputs, forward.step_n(..., 10) against the step variant on every
   output, within duck_standin.PIPELINE_PARITY_LIMITS; then (b) the
   trainer on the pipeline: ppo.train(Joystick(TRAINER_TASK,
   physics="pipeline")) at phase 4's recipe widths (8192 DR envs, unroll
   20, batch 256 x 32, 4 updates, (512, 256, 128) networks, 1024 eval
   envs) with profile_breakdown=True, cut to one training step and 2 evals
   of 20-step episodes (PIPELINE_TRAINER): one rollout of its captured
   rollout (one graph per env step) against the eager one bit for bit,
   finite metrics, every
   rollout, SGD step and eval step a replay, no graph spanning more than
   one control step, 0 kernel launches.

9. profile and deploy tools (utils/profiling.py on torch.profiler, traces
   under build/profile/): (a) the flat main path's env, PROFILE_WARMUP
   steps, then PROFILE_STEPS steps traced, each annotated env_step: per
   step host and device ms, kernel launches, the fused kernel's share of
   the device time, the device's idle share of the window and its top 10
   operations; exactly one fused launch, no host wait and no pageable copy
   in each annotated step; the same for PROFILE_STEPS replays of a
   EnvStepProgram in the same trace (host calls, graph launches, device
   ms, idle share beside the eager step's; one graph launch and one fused
   kernel per replay, the launch count equal to the profiler's); (b) one
   training step at phase 4's configuration through the captured rollout
   and the captured SGD step, each call annotated from outside: the same
   numbers per region, with the host calls and graph launches behind each
   (one replay each, unroll_length fused kernels in the rollout, at most 4
   host launches per minibatch step);
   (c) SimInfer on the card with a scripted teleop and a recording video
   on phase 4's ONNX: launches 1 + ticks, frames bit-identical to the
   ticks' qpos, the obs carry the teleop's command from its tick; (d) the
   gait playback (deploy/ref_motion_viewer.py) on the card within
   PLAYBACK_ATOL_M of the CPU.

The kernels line gives, per kernel, its launches on its main path, its
largest |kernel - twin| there (step variant, DR on, all outputs; for the
flat kernel also its launches and largest |kernel - twin| on the trainer's
path, both variants, DR on and off, its launches in phase 9's traced
windows, launches_profiled, and the fused launches in one replay of each
captured program; for the sharded dispatch, phase 5's
launches summed over the ranks and per rank, and (d)), its time
and the twin's for one control step, and its bound: the larger of the
twin's arithmetic (counted per env and substep on the CPU under a torch
dispatch mode, both sides of every `where` included) over the H100's 67
TFLOP/s of float32 and the bytes it must move (state, DR fields, table and
outputs, each once) over 3.35 TB/s. Its last entry, duck_adam, is the
optimizer's kernel: its launches in phases 4 and 6, the largest |kernel -
plain functions| of phase 4a, its time per launch, the plain and the
library step's, and its bound by bytes; duck_gae, the GAE kernel, the
same from phase 4a's GAE half, bound by its dependent chain; duck_swish,
the swish's forward and backward kernels, the same from phase 4a's swish
part, each bound by bytes, with its ptxas report.

Assets: $OPEN_DUCK_ASSETS if set, else the generated stand-in duck
(tests/duck_standin.py), written into build/standin_assets/.

Exits non-zero, printing no result, if CUDA is unavailable or any phase
fails; a failing run ends by naming every failed check on stdout and on
stderr. The last line of stdout is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import time
from typing import Optional

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
# the step variant's substeps where the twin is not timed: phase 2's cases
# (phase 3 holds a whole control step at the main paths' shapes) and
# phase 6's trained DR state (phase 4 holds a whole control step on its
# own; the twin takes 1-2.5 s per substep at any width: it launches each
# of its operations from the host)
SIDE_SUBSTEPS = 2
N_STEPS = 100
# phase 3: captured and eager steps traced for their host calls
GRAPH_TRACE_STEPS = 5
# phase 8: timed steps of each env (the pipeline takes ~1 s per step); the
# pipeline trainer's cuts of phase 4's recipe: one training step and 2 evals
# of 20-step episodes (a 1000-step eval on the pipeline would take minutes)
PIPELINE_STEPS = 5
PIPELINE_TRAINER = {"episode_length": 20, "num_evals": 2, "num_timesteps": 8192 * 20}
# phase 4: the recipe's widths (BASELINE.md:14), cut to 2 epochs of 2 training steps
TRAINER_TASK = "flat_terrain_backlash"
TRAINER_ARGS = ("--env", "joystick", "--task", TRAINER_TASK, "--num_envs", "8192",
                "--num_eval_envs", "1024", "--num_evals", "3", "--num_timesteps", "655360",
                "--device", "cuda")
# phase 6: the standing task at phase 4's cut
STANDING_ARGS = ("--env", "standing", *TRAINER_ARGS[2:])
# phase 5: the runner's command line of each run, by its bodies: the
# graphs at phase 4's cut; the eager rerun (the parent's numbers) one
# training step, its evals cut to EAGER_EVAL_STEPS steps (episode_length:
# the training never reaches it)
SHARDED_ARGS = {"graph": TRAINER_ARGS,
                "eager": (*TRAINER_ARGS[:-6], "--num_evals", "2", "--num_timesteps", "163840",
                          "--device", "cuda")}
EAGER_EVAL_STEPS = 100
OBS_SIZES = {"joystick": {"state": 101, "privileged_state": 212},
             "standing": {"state": 85, "privileged_state": 153}}
# phase 5: what a world-size-W training step may differ by from world size
# 1. The physics is per-env bit-exact, and on an NVIDIA H100 80GB HBM3 (700
# W) cuBLAS gives the policy the same products on 4096 rows as on 8192: the
# 20 steps of transitions read bit-identical. The gradients' all-reduce sums
# in another order, and after the step's 128 Adam steps the params read
# |d| q99 2.1e-5, max 7.5e-4: limits ~4x the q99, the max at the CPU test's
# 2 lr per Adam step; the update direction (params - init) must agree.
SHARDED_TIMEOUT_S = 600
SHARDED_LIMITS = {"transitions": 0.0, "params_q99": 8e-5, "params_max": 2 * 3e-4 * 128,
                  "update_cos": 0.999, "normalizer": 1e-5}
# phase 9: steps before the traced window and in it; the deploy hooks'
# rollout; the gait playback's cuda-vs-cpu limit on the feet (float32 both)
PROFILE_WARMUP, PROFILE_STEPS = 10, 20
# phase 4: SGD steps of the captured step held against the eager body,
# consecutive rollouts of the captured rollout held against the eager one
# (phase 8's pipeline trainer: one rollout of PIPELINE_ROLLOUT_STEPS replays
# of its one-step graph), and the steps of the eval held against the eager
# one
SGD_GRAPH_STEPS = 2
# phase 4a: the optimizer's kernel against the plain functions, (max grad
# norm, gradients as views into one flat buffer from a one-float offset: no
# tensor 16-byte aligned, so every element takes the kernel's scalar path;
# the env-sharded step hands over such views of its summed buffer), each 3
# steps with gradient norms ADAM_NORMS; then calls recorded per timed graph
ADAM_CASES = ((1.0, False), (None, False), (1.0, True))
ADAM_NORMS = (25.0, 0.5, 3.0)
ADAM_TIMED_LAUNCHES, ADAM_TIMED_STEPS = 200, 50
# phase 4a: the GAE kernel against compute_gae at these (T, b), each with
# these reward scalings; then calls recorded per timed graph at the first
GAE_SHAPES = ((20, 256), (5, 17))
GAE_SCALINGS = (1.0, 0.37)
GAE_TIMED_LAUNCHES, GAE_TIMED_STEPS = 200, 50
# phase 4a: the swish's kernels at the SGD step's largest activation (the
# policy's and value's first hidden layer over 20 x 256 rows); timed
# graphs of SWISH_TIMED_LAUNCHES calls rotate over SWISH_TIMED_INPUTS
# input sets (8 x 10.5 MB forward: past the 50 MB L2)
SWISH_SHAPE = (5120, 512)
SWISH_TIMED_LAUNCHES, SWISH_TIMED_INPUTS = 96, 8
# the H100 SXM's boost clock (GHz) and the latency in cycles of a dependent
# float32 multiply or add: the GAE kernel's bound by its chain
SM_GHZ, FLOP_LATENCY_CYCLES = 1.98, 4
ROLLOUT_GRAPH_ROLLOUTS = 2
PIPELINE_ROLLOUT_STEPS = 10
EVAL_CHECK_STEPS = 200
DEPLOY_HOOK_S = 2.0
PLAYBACK_ATOL_M = 1e-5
FUSED_KERNEL = "physics_step_kernel"  # the __global__ of ops/csrc/physics_step.cu
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")  # device work in a Chrome trace
PEAK_F32_FLOPS, PEAK_BYTES_PER_S = 67e12, 3.35e12  # H100 SXM, non-tensor float32; HBM3
# the arithmetic aten ops the bound counts (each output element one operation)
ARITH_OPS = frozenset((
    "add", "sub", "rsub", "mul", "div", "neg", "abs", "sqrt", "reciprocal", "sin", "cos",
    "exp2", "floor", "sign", "maximum", "minimum", "clamp", "clamp_min", "clamp_max", "where",
    "lt", "le", "gt", "ge", "eq", "ne", "bitwise_and", "bitwise_or", "bitwise_not"))


def log(*a):
    print(*a, flush=True)


FAILED = []  # "<where>: <check>" of every check that failed in this run


def passed(where: str, **checks) -> bool:
    """Whether every named check holds; each that does not is logged and
    kept in FAILED, which a failing run prints at its end."""
    for name, ok in checks.items():
        if not ok:
            FAILED.append(f"{where}: {name}")
            log(f"[check] FAILED {where}: {name}")
    return all(checks.values())


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cpu_line() -> str:
    """The host CPU as /proc/cpuinfo gives its first processor (vendor,
    family, model number, model name, clock) and the core count (this
    process may use fewer)."""
    info = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            if not line.strip():
                break
            key, _, value = line.partition(":")
            info[key.strip()] = value.strip()
    return (f"{info.get('vendor_id', '?')} family {info.get('cpu family', '?')} model "
            f"{info.get('model', '?')} ({info.get('model name', '?')}), "
            f"{info.get('cpu MHz', '?')} MHz; {os.cpu_count()} logical cores, "
            f"{len(os.sched_getaffinity(0))} usable by this process")


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


def fused_launches(unroll_length: int, rollouts: int, evals: int, episode_length: int,
                   sized: bool = False) -> dict:
    """The fused kernel's launches the code gives for one call of
    ppo.train: on the train env the batch's reset, the rollout capture's
    warm-up (unroll_length real steps) and unroll_length per rollout
    replay, plus the one-env reset that sizes the observations when the
    runner is built (`sized`: counted from the runner's construction); on
    the eval env the eval capture's warm-up step, then a reset and
    episode_length steps per eval."""
    return {"train_env": int(sized) + 1 + unroll_length * (1 + rollouts),
            "eval_env": 1 + evals * (1 + episode_length)}


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


def bitwise_equal(a, b) -> bool:
    """Every tensor of two trees equal bit for bit (NaN for NaN)."""
    from open_duck_playground_tpu_torch.utils.graphs import tree_leaves

    ta, tb = tree_leaves(a), tree_leaves(b)
    bits = lambda x: x.reshape(-1).contiguous().view(torch.uint8)  # noqa: E731
    return ta.keys() == tb.keys() and all(
        x.dtype == tb[k].dtype and x.shape == tb[k].shape and torch.equal(bits(x), bits(tb[k]))
        for k, x in ta.items())


def trace_env_steps(out_dir: str, te, cap, actions, n: int):
    """n replays of the EnvStepProgram `cap` (each in annotate("graph_step"),
    from the state it holds) and then n eager TrainEnv.step calls from
    there (each in annotate("eager_step")) under the profiler; returns the
    read_trace of build/.../trace.json."""
    from open_duck_playground_tpu_torch.utils import profiling

    shutil.rmtree(out_dir, ignore_errors=True)
    state = cap.static["state"]
    torch.cuda.synchronize()
    with profiling.trace(out_dir, device=actions.device):
        for i in range(n):
            with profiling.annotate("graph_step"):
                state = cap(state, actions[i])
        for i in range(n):
            with profiling.annotate("eager_step"):
                state = te.step(state, actions[i])
        torch.cuda.synchronize()
    return read_trace(os.path.join(out_dir, "trace.json"))


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
            if any(w in line for w in ("entry function", "registers", "stack", "spill")):
                log(f"[build] ptxas: {line.strip()}")
    log(f"[build] limits {cuda_step.kernel_limits()}")
    for task, B in (FLAT_MAIN, ROUGH_MAIN):
        fp = cuda_step.FusedPhysics(compile_mjcf(constants.task_to_xml(task), timestep=0.002))
        geo = fp.geometry(B, torch.device("cuda"))
        log(f"[build] geometry {task} B={B}: {fp.packed()['layout']['env_bytes']} shared bytes "
            f"per env, {geo['envs_per_block']} envs per block, {geo['blocks_per_sm']} blocks "
            f"({geo['warps_per_sm']} warps) resident per SM of {geo['sms']}, {geo['blocks']} "
            f"blocks in {geo['waves']} waves")


def phase_kernel_vs_twin(cases, report, side_substeps: int = 10) -> bool:
    """Kernel vs twin in each case: the step variant (`side_substeps`
    substeps) and the init variant from settled states, and the init
    variant from tilted states. At the main paths' shapes with DR on the
    step variant is left to phase_main_path, which holds a whole control
    step there on the main path's own states. Fills `report` with the
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
        variants = (("step", side_substeps, "settled"), ("init", 1, "settled"),
                    ("tilted", 1, "tilted"))
        if with_dr and (task, B) in (FLAT_MAIN, ROUGH_MAIN):
            variants = variants[1:]
        for variant, n, start in variants:
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
                log(f"[time] {tag}: kernel {ms:.3f} ms, twin {plain_ms:.1f} ms per call of "
                    f"{n} substeps")
            ok &= parity_table(tag, out_k, out_p, accel, variant, with_dr, rough, report)
    return ok


def parity_table(tag, out_k, out_p, accel, variant, with_dr, rough, report,
                 limits=None, ref="twin") -> bool:
    """Print |kernel - `ref`| per output against its limits (`limits`, else
    those of the variant, DR setting and scene), file the readings under
    report[tag], and return whether all are within them."""
    sd = standin()
    log(f"[parity] {tag}")
    log(f"| field | q50 | q95 | worst col q95 (col) | max | |{ref}| q95 | |")
    log("|---|---|---|---|---|---|---|")
    np_k, np_p = (sd.parity_outputs({k: v.cpu() for k, v in o.items()}, accel)
                  for o in (out_k, out_p))
    ok = True
    for f in limits or sd.parity_limits(variant, with_dr, rough):
        r = sd.parity(np_k[f], np_p[f], variant, with_dr, f, rough, limits)
        ok &= passed(f"parity {tag}", **{f: r["ok"]})
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


def phase_main_path(task: str, B: int, report: dict) -> dict:
    """TrainEnv(Joystick(task), B envs, DR on): reset, then N_STEPS steps of
    random actions, eagerly (TrainEnv.step) and then, from the same reset
    and the same generator states, through an EnvStepProgram (one CUDA
    graph replay per step, captured beforehand from another reset, which
    the capture leaves as it found it), each run with the kernel's launch
    count set to 0 just before and read just after; the two final states
    and the env generator's states must be equal bit for bit. Then
    GRAPH_TRACE_STEPS replays and as many eager steps under the profiler
    (host calls per env step), and one control step at this shape from the
    main path's last state, timed, kernel vs twin (the step variant's
    outputs within phase 2's limits, filed in `report`), and its bound."""
    from open_duck_playground_tpu_torch.envs import randomize
    from open_duck_playground_tpu_torch.envs.joystick import Joystick
    from open_duck_playground_tpu_torch.envs.wrapper import EnvStepProgram, TrainEnv
    from open_duck_playground_tpu_torch.ops.cuda_step import flatten_dr_fields

    dev = torch.device("cuda")
    env = Joystick(task, device=dev, seed=0)
    te = TrainEnv(env, num_envs=B, episode_length=1000,
                  randomization_fn=randomize.domain_randomize,
                  randomization_generator=torch.Generator(device=dev).manual_seed(0))
    g = torch.Generator(device=dev).manual_seed(2)
    actions = torch.rand((N_STEPS, B, env.action_size), generator=g, device=dev) * 2 - 1
    g_env = env.generator.get_state()

    def reset():
        return te.reset(torch.Generator(device=dev).manual_seed(1))

    env.physics.launches = 0
    t0 = time.perf_counter()
    state = reset()
    torch.cuda.synchronize()
    t_reset = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(N_STEPS):
        state = te.step(state, actions[i])
    torch.cuda.synchronize()
    t_eager = time.perf_counter() - t0
    launches_eager = env.physics.launches
    eager, g_eager = state, env.generator.get_state()

    cap = EnvStepProgram(te, log=log)
    cap.capture(reset(), actions[0])
    env.generator.set_state(g_env)
    env.physics.launches = 0
    state = reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(N_STEPS):
        state = cap(state, actions[i])
    torch.cuda.synchronize()
    t_graph = time.perf_counter() - t0
    launches = env.physics.launches
    same = bitwise_equal(eager, state)
    gens_same = bool(torch.equal(env.generator.get_state(), g_eager))

    finite = all(bool(torch.isfinite(v).all()) for v in (
        *state.obs.values(), state.reward, state.data.qpos))
    shapes = {k: tuple(v.shape) for k, v in state.obs.items()}
    rate, rate_eager = B * N_STEPS / t_graph, B * N_STEPS / t_eager
    log(f"[main] {task} B={B}: reset {t_reset:.3f} s; {N_STEPS} steps eager {t_eager:.3f} s, "
        f"captured {t_graph:.3f} s; env-steps/s eager {rate_eager:.1f}, captured {rate:.1f} "
        f"({rate / rate_eager:.2f}x); launches eager {launches_eager}, captured {launches}; "
        f"final state and env generator bit for bit {same} and {gens_same}; capture "
        f"{json.dumps(cap.graph.info)}; obs {shapes}; done {float(state.done.mean()):.3f}; "
        f"finite {finite}")
    split = trace_split(trace_env_steps(
        os.path.join(ROOT, "build", "main_trace", f"{task}_{B}"), te, cap, actions,
        GRAPH_TRACE_STEPS), ("eager_step", "graph_step"))
    host_calls = {k: split[f"{k}_step"]["host_calls"] for k in ("eager", "graph")}
    log(f"[main] {task} B={B}: host launches per env step (runtime calls that put work on the "
        f"card, {GRAPH_TRACE_STEPS} steps traced) eager {host_calls['eager']:.1f}, captured "
        f"{host_calls['graph']:.1f}; graph launches per captured step "
        f"{split['graph_step']['graph_launches']:.1f}; gpu {gpu_line()}")
    ok = passed(f"main path {task} B={B}", launches=launches == launches_eager == 1 + N_STEPS,
                shapes=shapes == {"state": (B, 101), "privileged_state": (B, 212)},
                finite=finite, graph_equals_eager=same, generators_equal=gens_same,
                one_graph_launch_per_step=split["graph_step"]["graph_launches"] == 1)

    # one control step at the main path's shape: kernel vs twin, same inputs
    # (the main path's last state), timed; the step variant's outputs held
    # to phase 2's limits (the kernels line's max_abs_err)
    data = state.data
    dr = flatten_dr_fields(te.model)
    args = (data.qpos.contiguous(), data.qvel.contiguous(),
            data.qacc_warmstart.contiguous(), data.ctrl.contiguous(), env.n_substeps, dr)
    per_env_substep = flops_per_env_substep(env.physics, dr)
    timed = {}
    accel = int(env.physics.model.sensor_adr[env.physics.model.sensor("accelerometer")])
    for variant, n in (("step", env.n_substeps), ("init", 1)):
        out_k = env.physics(*args[:4], n, dr)
        ms = cuda_ms(lambda: env.physics(*args[:4], n, dr), reps=20)
        t0 = time.perf_counter()
        out_p = env.physics.plain(*args[:4], n, dr)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        if variant == "step":
            ok &= parity_table(f"{task} B={B} dr=1 step", out_k, out_p, accel, variant, True,
                               "rough" in task, report)
        del out_k, out_p
        bound = step_bound(env.physics, B, n, dr, per_env_substep)
        log(f"[main] {task}: {variant} variant ({n} substeps) at {B} envs (DR on): kernel "
            f"{ms:.3f} ms, twin {plain_ms:.1f} ms; bound {bound['bound_ms']:.4f} ms by "
            f"{bound['bound_by']} ({per_env_substep:.0f} flops per env and substep, "
            f"{bound['flops']:.4g} flops, {bound['bytes']} bytes)")
        timed[variant] = dict(ms=ms, plain_ms=plain_ms, **bound)
    return dict(ok=ok, launches=launches, launches_eager=launches_eager, rate=rate,
                rate_eager=rate_eager, host_calls_per_step=host_calls,
                launches_per_replay=cap.graph.info["fused_launches_per_replay"], **timed["step"])


def run_env(task: str, B: int, physics: str) -> dict:
    """TrainEnv(Joystick(task, physics=physics), B envs, DR on): a reset,
    then PIPELINE_STEPS steps of random actions, each timed window between
    torch.cuda.synchronize() calls, the kernel's launches set to 0 just
    before and read just after, and the peak of max_memory_allocated; on
    the pipeline, then the same run replayed (pipeline_graph_vs_eager)."""
    from open_duck_playground_tpu_torch.envs import randomize
    from open_duck_playground_tpu_torch.envs.joystick import Joystick
    from open_duck_playground_tpu_torch.envs.wrapper import TrainEnv

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    env = Joystick(task, device=dev, seed=0, physics=physics)
    te = TrainEnv(env, num_envs=B, episode_length=1000,
                  randomization_fn=randomize.domain_randomize,
                  randomization_generator=torch.Generator(device=dev).manual_seed(0))
    g = torch.Generator(device=dev).manual_seed(2)
    actions = torch.rand((PIPELINE_STEPS, B, env.action_size), generator=g, device=dev) * 2 - 1
    g_env = env.generator.get_state()

    env.physics.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = te.reset(torch.Generator(device=dev).manual_seed(1))
    torch.cuda.synchronize()
    reset_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for i in range(PIPELINE_STEPS):
        state = te.step(state, actions[i])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / PIPELINE_STEPS
    launches = env.physics.launches
    peak = torch.cuda.max_memory_allocated()
    finite = all(bool(torch.isfinite(v).all()) for v in (
        *state.obs.values(), state.reward, state.data.qpos))
    shapes = {k: tuple(v.shape) for k, v in state.obs.items()}
    log(f"[pipeline] {task} B={B} physics={physics}: reset {reset_ms:.1f} ms; "
        f"{step_ms:.2f} ms per control step over {PIPELINE_STEPS} steps "
        f"({B / step_ms * 1e3:.1f} env-steps/s); kernel launches {launches}; peak memory "
        f"{peak / 2**20:.1f} MiB ({(peak - base) / 2**20:.1f} MiB above the "
        f"{base / 2**20:.1f} MiB held before); done {float(state.done.mean()):.3f}; "
        f"finite {finite}")
    want = 0 if physics == "pipeline" else 1 + PIPELINE_STEPS
    ok = passed(f"pipeline {task} B={B} physics={physics}", launches=launches == want,
                finite=finite, shapes=shapes == {"state": (B, 101), "privileged_state": (B, 212)})
    out = dict(ok=ok, step_ms=step_ms, peak_bytes=peak)
    if physics == "pipeline":
        out["graph"] = pipeline_graph_vs_eager(task, te, actions, state, g_env, step_ms, peak)
        out["ok"] = ok and out["graph"]["ok"]
    return out


def pipeline_graph_vs_eager(task: str, te, actions, eager, g_env, eager_ms: float,
                            eager_peak: int) -> dict:
    """run_env's pipeline run again from the same reset and the same env
    generator state, each step one replay of an EnvStepProgram (captured
    beforehand from another reset, which the capture leaves as it found it):
    the final state and the env generator's state must equal the eager
    run's (`eager`, and the generator's state now) bit for bit, with 0
    kernel launches. Then one eager step and one replay traced, each in a
    window ending in a synchronize: kernels, device ms and host calls per
    step, and the card's idle share of each window."""
    from open_duck_playground_tpu_torch.envs.wrapper import EnvStepProgram
    from open_duck_playground_tpu_torch.utils import profiling

    env, B, dev = te.env, te.num_envs, actions.device
    g_eager = env.generator.get_state()

    def reset():
        return te.reset(torch.Generator(device=dev).manual_seed(1))

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cap = EnvStepProgram(te, log=log)
    cap.capture(reset(), actions[0])
    env.generator.set_state(g_env)
    env.physics.launches = 0
    state = reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(PIPELINE_STEPS):
        state = cap(state, actions[i])
    torch.cuda.synchronize()
    graph_ms = (time.perf_counter() - t0) * 1e3 / PIPELINE_STEPS
    peak = torch.cuda.max_memory_allocated()
    launches = env.physics.launches
    same = bitwise_equal(eager, state)
    gens_same = bool(torch.equal(env.generator.get_state(), g_eager))
    finite = all(bool(torch.isfinite(v).all()) for v in (*state.obs.values(), state.reward))

    out_dir = os.path.join(ROOT, "build", "pipeline_trace", f"{task}_{B}")
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.synchronize()
    with profiling.trace(out_dir, device=dev):
        for name, step in (("graph", cap), ("eager", te.step)):
            with profiling.annotate(f"{name}_window"):
                with profiling.annotate(f"{name}_step"):
                    state = step(state, actions[0])
                torch.cuda.synchronize()
    split = trace_split(read_trace(os.path.join(out_dir, "trace.json")),
                        ("graph_window", "graph_step", "eager_window", "eager_step"))
    ways = {}
    for name, ms, pk in (("eager", eager_ms, eager_peak), ("graph", graph_ms, peak)):
        st = split[f"{name}_step"]
        ways[name] = {"ms_per_step": ms, "env_steps_per_s": B / ms * 1e3,
                      "host_calls": st["host_calls"], "graph_launches": st["graph_launches"],
                      "kernels": st["launches"], "device_ms": st["device_ms"],
                      "traced_host_ms": split[f"{name}_window"]["host_ms"],
                      "idle_share": split[f"{name}_window"]["idle_share"],
                      "peak_bytes": pk}
    ways["graph"]["peak_bytes_above_start"] = peak - base
    log(f"[pipeline] {task} B={B}: {PIPELINE_STEPS} steps eager against replays of one CUDA "
        f"graph per control step: {json.dumps(ways)}; capture {json.dumps(cap.graph.info)}; "
        f"kernel launches {launches}; final state and env generator bit for bit {same} and "
        f"{gens_same}; finite {finite}; gpu {gpu_line()}")
    for name in ("eager", "graph"):
        log_split(f"pipeline {task} {name}", {k: v for k, v in split.items()
                                             if k.startswith(name)}, top_of=(f"{name}_step",))
    ok = passed(f"pipeline {task} B={B} graph", graph_equals_eager=same,
                generators_equal=gens_same, launches=launches == 0, finite=finite,
                one_graph_launch_per_step=split["graph_step"]["graph_launches"] == 1,
                no_fused_launch_recorded=cap.graph.info["fused_launches_per_replay"] == 0)
    res = dict(ok=ok, ways=ways, capture=cap.graph.info, equal=same, generators_equal=gens_same)
    del cap, state
    torch.cuda.empty_cache()
    return res


def pipeline_vs_kernel(task: str, B: int, report: dict) -> bool:
    """The pipeline against the kernel on the card from settled states with
    one DR draw: forward.init against the init variant (kinematic outputs),
    forward.step_n(..., 10) against the step variant (every output)."""
    from open_duck_playground_tpu_torch.envs import randomize
    from open_duck_playground_tpu_torch.mjcf import compile_mjcf
    from open_duck_playground_tpu_torch.models.open_duck_mini_v2 import constants
    from open_duck_playground_tpu_torch.ops import forward as fwd
    from open_duck_playground_tpu_torch.ops.cuda_step import FusedPhysics, flatten_dr_fields

    sd = standin()
    dev = torch.device("cuda")
    rough = "rough" in task
    m = compile_mjcf(constants.task_to_xml(task), timestep=0.002)
    fp = FusedPhysics(m)
    accel = int(m.sensor_adr[m.sensor("accelerometer")])
    model_v = randomize.domain_randomize(
        m.to(dev), B, torch.Generator(device=dev).manual_seed(7))
    dr = flatten_dr_fields(model_v)
    qpos, qvel, ctrl = (torch.from_numpy(x).to(dev) for x in sd.settled_states(
        m.keyframe("home"), m.nq, m.nv, m.nu, B, seed=B + 1))
    warm = torch.zeros_like(qvel)
    ok = True
    for variant, n in (("init", 1), ("step", 10)):
        out_k = fp(qpos, qvel, warm, ctrl, n, dr)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if variant == "init":
            d = fwd.init(model_v, qpos, qvel, ctrl)
        else:
            d = fwd.step_n(model_v, fwd.make_data(model_v, B).replace(
                qpos=qpos, qvel=qvel, qacc_warmstart=warm), ctrl, n)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        log(f"[pipeline] {task} B={B} {variant} ({n} substeps, DR on): pipeline {ms:.1f} ms")
        # "pipeline init": quantiles only, no INIT_MAX (see PIPELINE_PARITY_LIMITS)
        ok &= parity_table(f"pipeline {task} B={B} dr=1 {variant}", out_k,
                           sd.pipeline_outputs(d), accel, f"pipeline {variant}", True, rough, report,
                           limits=sd.PIPELINE_PARITY_LIMITS[(variant, rough)], ref="pipeline")
    return ok


def pipeline_trainer() -> dict:
    """Phase 8 (b): ppo.train on Joystick(TRAINER_TASK, physics="pipeline")
    (train and eval env) at phase 4's recipe widths (the runner's: 8192 DR
    envs, unroll 20, batch 256 x 32, 4 updates per batch, (512, 256, 128)
    networks, 1024 eval envs), cut by PIPELINE_TRAINER to one training step
    and 2 evals of 20-step episodes (a 1000-step eval on the pipeline would
    take minutes), with profile_breakdown=True, the runner's callbacks and
    checkpoints left out. First the captured rollout against the eager one
    (rollout_graph_vs_eager: one rollout of PIPELINE_ROLLOUT_STEPS replays
    of the one-step graph). Checks finite
    metrics; every rollout, SGD step and eval step a replay of train()'s
    captured programs (unroll_length replays of a one-step graph per
    rollout, one per SGD step, one per eval step; the counts the code
    gives); no graph spanning more than one control step; 0 kernel
    launches on both envs."""
    from types import SimpleNamespace

    from open_duck_playground_tpu_torch.envs.joystick import Joystick
    from open_duck_playground_tpu_torch.train import ppo
    from open_duck_playground_tpu_torch.train import runner as rn

    out_dir = os.path.join(ROOT, "build", "pipeline_trainer_run")
    shutil.rmtree(out_dir, ignore_errors=True)
    runner = rn.OpenDuckMiniV2Runner(rn.build_parser().parse_args(
        ["--output_dir", out_dir, *TRAINER_ARGS]))
    dev = runner.device
    kw = {**runner.train_kwargs(), **PIPELINE_TRAINER, "progress_fn": None,
          "policy_params_fn": None, "save_full_state_dir": None}
    nf = kw["network_factory"]
    recipe_ok = ((kw["num_envs"], kw["batch_size"], kw["num_minibatches"], kw["unroll_length"],
                  kw["num_updates_per_batch"], kw["num_eval_envs"]) == (8192, 256, 32, 20, 4, 1024)
                 and nf["policy_hidden_layer_sizes"] == nf["value_hidden_layer_sizes"] == (512, 256, 128)
                 and kw["randomization_fn"] is not None)
    env = Joystick(TRAINER_TASK, device=dev, physics="pipeline")
    eval_env = Joystick(TRAINER_TASK, device=dev, physics="pipeline")
    del runner
    roll = rollout_graph_vs_eager(SimpleNamespace(env=env, device=dev),
                                  {**kw, "unroll_length": PIPELINE_ROLLOUT_STEPS},
                                  "pipeline trainer", rollouts=1)

    T = kw["unroll_length"]
    epochs = kw["num_evals"] - 1
    steps = epochs * math.ceil(kw["num_timesteps"] / (epochs * kw["num_envs"] * T))
    # the breakdown's rollout and training step (each run twice), then the loop's
    rollouts = 2 + 2 + steps
    n_evals = 1 + epochs + 2  # at 0, after each epoch, two in the breakdown
    want = {"rollout": [rollouts * T], "SGD step": [rollouts],
            "eval step": [n_evals * kw["episode_length"]]}
    env.physics.launches = eval_env.physics.launches = 0
    t0 = time.perf_counter()
    with captured_programs() as made:
        _, _, metrics = ppo.train(environment=env, eval_env=eval_env, **kw,
                                  profile_breakdown=True)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    bd = ppo.LAST_PROFILE_BREAKDOWN
    replays = {name: [c.replays for c in made.get(name, [])] for name in want}
    spans = {"rollout": [c.graph.info.get("env_steps_per_replay") for c in made["rollout"]]}
    launches = {"train_env": env.physics.launches, "eval_env": eval_env.physics.launches}
    finite = (all(math.isfinite(v) for v in metrics.values())
              and "training/sps" in metrics and "eval/episode_reward" in metrics)
    log(f"[pipeline trainer] ppo.train {t_train:.1f} s at {kw['num_envs']} DR envs, "
        f"{kw['num_eval_envs']} eval envs, episode_length {kw['episode_length']}, {steps} "
        f"training step(s), {kw['num_evals']} evals; graph replays {json.dumps(replays)} (want "
        f"{json.dumps(want)}); env steps per rollout graph {spans['rollout']}; kernel launches "
        f"{launches}; training/sps {metrics.get('training/sps')}; metrics finite {finite}")
    log(f"[pipeline trainer] profile_breakdown {json.dumps(bd)}")
    log(f"[pipeline trainer] metrics {json.dumps(metrics)}; gpu {gpu_line()}")
    ok = passed("pipeline trainer", recipe=recipe_ok, metrics_finite=finite,
                rollout_graph_vs_eager=roll["ok"], graph_replays=replays == want,
                one_control_step_per_graph=spans["rollout"] == [1],
                launches=launches == {"train_env": 0, "eval_env": 0})
    log(f"[pipeline trainer] {'OK' if ok else 'FAIL'}")
    del env, eval_env, made
    torch.cuda.empty_cache()
    return dict(ok=ok, seconds=t_train, breakdown=bd, replays=replays, rollout_graph=roll,
                sps=metrics.get("training/sps"))


def phase_pipeline(report: dict) -> dict:
    """Phase 8: each main path's env on the pipeline (eager, then replayed)
    and on the kernel, then the pipeline against the kernel at that shape;
    then the trainer on the pipeline (pipeline_trainer)."""
    runs, ok = {}, True
    for task, B in (FLAT_MAIN, ROUGH_MAIN):
        runs[task] = {physics: run_env(task, B, physics) for physics in ("pipeline", "kernel")}
        pipe, kernel_ms = runs[task]["pipeline"], runs[task]["kernel"]["step_ms"]
        log(f"[pipeline] {task} B={B}: pipeline / kernel ms per control step "
            f"{pipe['step_ms'] / kernel_ms:.1f}x eagerly, "
            f"{pipe['graph']['ways']['graph']['ms_per_step'] / kernel_ms:.1f}x replayed")
        ok &= all(r["ok"] for r in runs[task].values())
        ok &= pipeline_vs_kernel(task, B, report)
    trainer = pipeline_trainer()
    ok &= trainer["ok"]
    log(f"[pipeline] gpu {gpu_line()}")
    log(f"[pipeline] {'OK' if ok else 'FAILED'}")
    return dict(ok=ok, runs=runs, trainer=trainer)


def graph_ms(fn, reps: int) -> float:
    """Device ms per call of `fn`: `reps` calls recorded in one CUDA graph
    (after one warm-up call on the capture's stream), its replay timed by
    CUDA events."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(reps):
            fn()
    ms = cuda_ms(graph.replay, reps=3) / reps
    del graph
    return ms


def phase_optimizer() -> dict:
    """Phase 4a: the optimizer's kernel (ops/csrc/adam.cu, through
    optim.clip_and_adam) against the plain functions (clip_by_global_norm
    then adam, the CPU's path) on the card, at the recipe's 16 parameter
    tensors (both (512, 256, 128) MLPs of the joystick task: 493,469
    floats). For each of ADAM_CASES, two copies of one state take 3 steps
    on the same gradients (global norms ADAM_NORMS: the clip taken, not
    taken, taken): params, count, mu and nu must be equal bit for bit, on
    the same tensor objects, with one launch per step
    (cuda_step.ADAM.launches). Then, on copies, device ms per call from
    calls recorded in one CUDA graph (as the SGD graph runs them): the
    kernel alone (ms, ADAM_TIMED_LAUNCHES launches), the whole fused step
    with its norm and bias corrections (ms_step), the plain functions' step
    (plain_ms) and torch.optim.Adam's fused step (library_ms: capturable,
    no clip; ADAM_TIMED_STEPS steps each); the bound is the kernel's bytes,
    p, g, m, v read and p, m, v written (28 B a float), at 3.35 TB/s."""
    from open_duck_playground_tpu_torch.ops import cuda_step
    from open_duck_playground_tpu_torch.train import networks as nets
    from open_duck_playground_tpu_torch.train import optim

    dev = torch.device("cuda")
    lr = 3e-4
    net = nets.PPONetworks(OBS_SIZES["joystick"], 14, generator=torch.Generator().manual_seed(0))
    init = [p.detach().to(dev) for p in net.parameters()]
    numel = sum(p.numel() for p in init)
    gen = torch.Generator(device=dev).manual_seed(1)

    def gradients(norm: float, views: bool):
        g = [torch.randn(p.shape, generator=gen, device=dev) for p in init]
        g = [x * (norm / float(optim.global_norm(g))) for x in g]
        if not views:
            return g
        flat = torch.cat([g[0].new_zeros(1)] + [x.reshape(-1) for x in g])
        out, at = [], 1
        for x in g:
            out.append(flat[at:at + x.numel()].view_as(x))
            at += x.numel()
        return out

    def plain_step(params, grads, state, max_grad_norm):
        if max_grad_norm is not None:
            grads = optim.clip_by_global_norm(grads, max_grad_norm)
        optim.adam(params, grads, state, lr)

    ok, worst, cases = True, 0.0, []
    for max_grad_norm, views in ADAM_CASES:
        params = [p.clone() for p in init]
        state = optim.adam_init(params)
        ref_params, ref = [p.clone() for p in init], optim.adam_init(init)
        tensors = [*params, state.count, *state.mu, *state.nu]
        launches = cuda_step.ADAM.launches
        for norm in ADAM_NORMS:
            g = gradients(norm, views)
            optim.clip_and_adam(params, g, state, lr, max_grad_norm)
            plain_step(ref_params, g, ref, max_grad_norm)
        torch.cuda.synchronize()
        launches = cuda_step.ADAM.launches - launches
        after = [*params, state.count, *state.mu, *state.nu]
        want = [*ref_params, ref.count, *ref.mu, *ref.nu]
        same_objects = all(a is b for a, b in zip(after, tensors))
        equal = all(bitwise_equal(a, b) for a, b in zip(after, want))
        err = max(float((a.double() - b.double()).abs().max()) for a, b in zip(after, want))
        worst = max(worst, err)
        tag = f"clip {max_grad_norm}, {'unaligned views' if views else 'aligned'}"
        ok &= passed(f"optimizer kernel vs plain functions ({tag})", equal=equal,
                     same_tensors=same_objects, one_launch_per_step=launches == len(ADAM_NORMS))
        cases.append({"case": tag, "equal": equal, "max_abs_err": err, "launches": launches})
        log(f"[optimizer] {tag}: {len(ADAM_NORMS)} steps, bit for bit {equal}, max |d| {err}, "
            f"launches {launches}")

    # timings on copies; the launches recorded here are no step of the trainer
    launches = cuda_step.ADAM.launches
    params = [p.clone() for p in init]
    state = optim.adam_init(params)
    g = gradients(ADAM_NORMS[0], False)
    norm = optim.global_norm(g)
    bc1, bc2 = torch.full((), 0.1, device=dev), torch.full((), 0.001, device=dev)
    timed = {
        "ms": graph_ms(lambda: cuda_step.adam_step(params, g, state.mu, state.nu, norm, bc1, bc2,
                                                   1.0, 0.9, 0.999, 1e-8, lr),
                       ADAM_TIMED_LAUNCHES),
        "ms_step": graph_ms(lambda: optim.clip_and_adam(params, g, state, lr, 1.0),
                            ADAM_TIMED_STEPS),
        "plain_ms": graph_ms(lambda: plain_step(params, g, state, 1.0), ADAM_TIMED_STEPS)}
    cuda_step.ADAM.launches = launches
    try:
        lib_params = [torch.nn.Parameter(p.clone()) for p in init]
        for p, x in zip(lib_params, g):
            p.grad = x.clone()
        opt = torch.optim.Adam(lib_params, lr=lr, eps=1e-8, fused=True, capturable=True)
        for _ in range(3):
            opt.step()
        torch.cuda.synchronize()
        timed["library_ms"] = graph_ms(opt.step, ADAM_TIMED_STEPS)
        library_error = None
    except Exception as e:  # a reading, not a check: the PyTorch build may not capture it
        timed["library_ms"], library_error = None, f"{type(e).__name__}: {e}"
    bound_ms = 28 * numel / PEAK_BYTES_PER_S * 1e3
    log(f"[optimizer] {len(init)} tensors, {numel} floats: kernel {timed['ms'] * 1e3:.3f} us a "
        f"launch ({bound_ms * 1e3:.3f} us bound by bytes, {100 * bound_ms / timed['ms']:.1f}% of "
        f"it); one step fused {timed['ms_step']:.4f} ms, plain {timed['plain_ms']:.4f} ms, "
        f"torch.optim.Adam fused {timed['library_ms']} ms"
        f"{'' if library_error is None else f' ({library_error})'}; gpu {gpu_line()}")
    ok &= passed("optimizer kernel", tensors=len(init) == 16, floats=numel == 493469)
    log(f"[optimizer] {'OK' if ok else 'FAIL'}")
    del params, state, g, net
    torch.cuda.empty_cache()
    return dict(ok=ok, cases=cases, max_abs_err=worst, numel=numel, bound_ms=bound_ms,
                library_error=library_error, **timed)


def gae_inputs(T: int, b: int, gen: torch.Generator) -> dict:
    """ppo.gae's arguments for one minibatch as the rollout makes it, drawn
    on the card: [T, b] reward, discount (1 - done) and truncation (done
    envs only) in data, the [T, b] baseline, the [b] bootstrap value; ~20%
    of the steps end an episode, half of those by truncation; a NaN reward
    at (T // 2, b // 3)."""
    from open_duck_playground_tpu_torch.train import ppo

    dev = torch.device("cuda")
    draw = lambda *shape: torch.randn(shape, generator=gen, device=dev)  # noqa: E731
    reward = draw(T, b) * 3
    done = (torch.rand((T, b), generator=gen, device=dev) < 0.2).float()
    truncation = (torch.rand((T, b), generator=gen, device=dev) < 0.5).float() * done
    reward[T // 2, b // 3] = float("nan")
    data = ppo.Transition(observation=None, action=None, reward=reward, discount=1 - done,
                          next_observation=None, truncation=truncation, raw_action=None,
                          log_prob=None)
    return {"data": data, "baseline": draw(T, b) * 5, "bootstrap_value": draw(b) * 5}


def plain_gae(data, baseline, bootstrap_value, hp):
    """The CPU's path of ppo.gae: loss_points' inputs, then compute_gae."""
    from open_duck_playground_tpu_torch.train import ppo

    termination = (1 - data.discount) * (1 - data.truncation)
    return ppo.compute_gae(data.truncation, termination, data.reward * hp.reward_scaling,
                           baseline, bootstrap_value, lambda_=hp.gae_lambda,
                           discount=hp.discounting)


def phase_gae() -> dict:
    """Phase 4a, second half: the GAE kernel (ops/csrc/gae.cu, through
    ppo.gae) against the plain compute_gae on the same card tensors
    (gae_inputs: both kinds of episode end, a NaN reward) at each of
    GAE_SHAPES and GAE_SCALINGS: vs and advantages equal bit for bit, the
    NaN in its column alone, one launch a call (cuda_step.GAE.launches);
    then the same with the call recorded in a graph (utils.graphs
    .GraphedBody, as the SGD step records it) and replayed on two new
    minibatches. Then, at the recipe's (20, 256), device ms per call from
    calls recorded in one CUDA graph: the kernel (ms, GAE_TIMED_LAUNCHES
    launches) and the plain path (plain_ms, GAE_TIMED_STEPS calls; the
    outputs of both graphs' last calls compared bit for bit too). Its
    bounds: bytes (4 [T, b] inputs, the bootstrap and 2 outputs, once, at
    3.35 TB/s) and the dependent chain (T steps of the recursion's multiply
    and add, FLOP_LATENCY_CYCLES each at SM_GHZ)."""
    import types

    from open_duck_playground_tpu_torch.ops import cuda_step
    from open_duck_playground_tpu_torch.train import ppo
    from open_duck_playground_tpu_torch.utils.graphs import GraphedBody, copy_into

    gen = torch.Generator(device="cuda").manual_seed(4)
    ok, worst, cases = True, 0.0, []

    def compare(got, want, b):
        equal = bitwise_equal(dict(zip(("vs", "adv"), got)), dict(zip(("vs", "adv"), want)))
        nan_cols = [torch.isnan(x).any(0).nonzero().flatten().tolist() for x in got]
        err = max(float((x.double() - y.double()).nan_to_num().abs().max())
                  for x, y in zip(got, want))
        return equal, nan_cols == [[b // 3]] * 2, err

    for T, b in GAE_SHAPES:
        for scaling in GAE_SCALINGS:
            hp = types.SimpleNamespace(reward_scaling=scaling, discounting=0.97, gae_lambda=0.95)
            inputs = gae_inputs(T, b, gen)
            launches = cuda_step.GAE.launches
            got = ppo.gae(**inputs, hp=hp)
            launches = cuda_step.GAE.launches - launches
            equal, nan_ok, err = compare(got, plain_gae(**inputs, hp=hp), b)
            static, out = gae_inputs(T, b, gen), {}
            graphed = GraphedBody(lambda: out.update(gae=ppo.gae(**static, hp=hp)), [],
                                  device="cuda", kernels=[cuda_step.GAE])
            for _ in range(2):
                fresh = gae_inputs(T, b, gen)
                copy_into(static, fresh)
                graphed.replay()
                g_equal, g_nan_ok, g_err = compare(out["gae"], plain_gae(**fresh, hp=hp), b)
                equal, nan_ok, err = equal and g_equal, nan_ok and g_nan_ok, max(err, g_err)
            torch.cuda.synchronize()
            worst = max(worst, err)
            tag = f"T={T} b={b} reward_scaling={scaling}"
            ok &= passed(f"GAE kernel vs compute_gae ({tag})", equal=equal,
                         nan_in_its_column=nan_ok, one_launch=launches == 1,
                         one_node=graphed.info["kernel_nodes"] == 1
                         and graphed.info["fused_launches_per_replay"] == 1)
            cases.append({"case": tag, "equal": equal, "max_abs_err": err})
            log(f"[gae] {tag}: eager and 2 replays, bit for bit {equal}, NaN in its column "
                f"{nan_ok}, max |d| {err}; graph {graphed.info['kernel_nodes']} kernel node(s)")
            del graphed, static, out

    # timings; the launches recorded here are no step of the trainer
    launches = cuda_step.GAE.launches
    T, b = GAE_SHAPES[0]
    hp = types.SimpleNamespace(reward_scaling=1.0, discounting=0.97, gae_lambda=0.95)
    inputs, last = gae_inputs(T, b, gen), {}
    timed = {"ms": graph_ms(lambda: last.update(kernel=ppo.gae(**inputs, hp=hp)),
                            GAE_TIMED_LAUNCHES),
             "plain_ms": graph_ms(lambda: last.update(plain=plain_gae(**inputs, hp=hp)),
                                  GAE_TIMED_STEPS)}
    torch.cuda.synchronize()
    cuda_step.GAE.launches = launches
    timed_equal, _, timed_err = compare(last["kernel"], last["plain"], b)
    worst = max(worst, timed_err)
    bound_bytes = (6 * T * b + b) * 4
    bound_ms = {"bytes": bound_bytes / PEAK_BYTES_PER_S * 1e3,
                "chain": T * 2 * FLOP_LATENCY_CYCLES / (SM_GHZ * 1e9) * 1e3}
    bound_by = max(bound_ms, key=bound_ms.get)
    log(f"[gae] T={T} b={b}: kernel {timed['ms'] * 1e3:.3f} us a launch (bounds: bytes "
        f"{bound_ms['bytes'] * 1e3:.4f} us for {bound_bytes} B, chain "
        f"{bound_ms['chain'] * 1e3:.4f} us; {100 * bound_ms[bound_by] / timed['ms']:.2f}% of the larger, {bound_by}); plain "
        f"compute_gae {timed['plain_ms'] * 1e3:.3f} us a call; in graphs of {GAE_TIMED_STEPS}, "
        f"bit for bit {timed_equal}; gpu {gpu_line()}")
    ok &= passed("GAE kernel in timed graphs", equal=timed_equal)
    log(f"[gae] {'OK' if ok else 'FAIL'}")
    torch.cuda.empty_cache()
    return dict(ok=ok, cases=cases, max_abs_err=worst, bound_ms=bound_ms[bound_by],
                bound_by=bound_by, bound_bytes=bound_bytes, **timed)


def swish_values(shape, gen: torch.Generator):
    """x (normal, scaled by 6) and g (normal) of `shape` drawn on the card,
    with special values at the head of x (+-0, +-inf, NaN, subnormals,
    |x| past 88, FLT_MAX) and g large where g * x overflows."""
    dev = torch.device("cuda")
    x = torch.randn(shape, generator=gen, device=dev) * 6
    g = torch.randn(shape, generator=gen, device=dev)
    tiny, big = torch.finfo(torch.float32).tiny, torch.finfo(torch.float32).max
    special = torch.tensor([0.0, -0.0, math.inf, -math.inf, math.nan, tiny / 8, -tiny / 8, tiny,
                            88.5, -88.5, 89.0, -89.0, 104.0, -104.0, 1e30, -1e30, big, -big,
                            1e10, -1e10], device=dev)
    x.view(-1)[:len(special)] = special
    g.view(-1)[len(special) - 2:len(special)] = 1e30
    return x, g


def ptxas_report(log_text: str, needle: str) -> dict:
    """Registers, stack and spill bytes of the one kernel whose mangled name
    holds `needle`, from an nvcc -Xptxas -v log."""
    out, on = {}, False
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            on = needle in line
        elif on and "stack frame" in line:
            words = line.replace(",", "").split()
            out["stack_bytes"] = int(words[0])
            out["spill_bytes"] = int(words[4]) + int(words[8])
        elif on and "Used" in line and "registers" in line:
            out["registers"] = int(line.split("Used")[1].split()[0])
    return out


def phase_swish() -> dict:
    """Phase 4a, last part: the swish's kernels (ops/csrc/swish.cu, through
    networks.swish) against torch's x * sigmoid(x) and its autograd
    gradient on the card at SWISH_SHAPE with special values (swish_values):
    output and gradient bit for bit (NaN for NaN), one launch each way.
    Then device ms per call from calls recorded in one CUDA graph
    (SWISH_TIMED_LAUNCHES, rotating over SWISH_TIMED_INPUTS input sets so
    that each call reads from device memory, not the L2): each kernel (ms
    forward and backward) and the plain torch kernels it replaces (plain_ms:
    sigmoid and mul forward; g * s, g * x, sigmoid_backward and their add
    backward) and torch's one-kernel silu and silu_backward (library_ms:
    another rounding, a reading only). Bounds by bytes at 3.35 TB/s: forward x read and y written,
    backward g and x read and gx written. The ptxas report of each kernel
    from the library's build log."""
    from open_duck_playground_tpu_torch.ops import cuda_step
    from open_duck_playground_tpu_torch.train import networks as nets

    gen = torch.Generator(device="cuda").manual_seed(5)
    x, g = swish_values(SWISH_SHAPE, gen)
    launches = cuda_step.SWISH.launches
    xk = x.clone().requires_grad_()
    y = nets.swish(xk)
    y.backward(g)
    launches = cuda_step.SWISH.launches - launches
    xp = x.clone().requires_grad_()
    want = xp * torch.sigmoid(xp)
    want.backward(g)
    torch.cuda.synchronize()

    def same(a, b):
        nan = torch.isnan(a)
        return bool(torch.equal(nan, torch.isnan(b))
                    and torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32)))

    def err(a, b):
        return float((a.double() - b.double()).nan_to_num().abs().max())

    equal = {"forward": same(y.detach(), want.detach()), "backward": same(xk.grad, xp.grad)}
    worst = max(err(y.detach(), want.detach()), err(xk.grad, xp.grad))
    ok = passed(f"swish kernels vs torch {list(SWISH_SHAPE)}", forward_equal=equal["forward"],
                backward_equal=equal["backward"], two_launches=launches == 2)
    log(f"[swish] {list(SWISH_SHAPE)}: forward bit for bit {equal['forward']}, backward "
        f"{equal['backward']}, max |d| {worst}, launches {launches}")
    del xk, xp, y, want

    # timings; the launches recorded here are no step of the trainer
    launches = cuda_step.SWISH.launches
    sets = [swish_values(SWISH_SHAPE, gen) for _ in range(SWISH_TIMED_INPUTS)]
    saved = [torch.sigmoid(a) for a, _ in sets]  # what autograd saves for the plain backward
    turn = itertools.count()

    def rotate(fn):
        def call():
            k = next(turn) % SWISH_TIMED_INPUTS
            fn(*sets[k], saved[k])
        return call

    timed = {
        "ms_forward": graph_ms(rotate(lambda a, b, s: cuda_step.swish_forward(a)),
                               SWISH_TIMED_LAUNCHES),
        "ms_backward": graph_ms(rotate(lambda a, b, s: cuda_step.swish_backward(b, a)),
                                SWISH_TIMED_LAUNCHES),
        "plain_ms_forward": graph_ms(rotate(lambda a, b, s: a * torch.sigmoid(a)),
                                     SWISH_TIMED_LAUNCHES),
        "plain_ms_backward": graph_ms(
            rotate(lambda a, b, s: b * s + torch.ops.aten.sigmoid_backward(b * a, s)),
            SWISH_TIMED_LAUNCHES),
        "library_ms_forward": graph_ms(rotate(lambda a, b, s: torch.nn.functional.silu(a)),
                                       SWISH_TIMED_LAUNCHES),
        "library_ms_backward": graph_ms(rotate(lambda a, b, s: torch.ops.aten.silu_backward(b, a)),
                                        SWISH_TIMED_LAUNCHES)}
    torch.cuda.synchronize()
    cuda_step.SWISH.launches = launches
    n = x.numel()
    bound_ms = {"forward": 2 * 4 * n / PEAK_BYTES_PER_S * 1e3,
                "backward": 3 * 4 * n / PEAK_BYTES_PER_S * 1e3}
    with open(cuda_step.build_library() + ".log") as f:
        build_log = f.read()
    ptxas = {way: ptxas_report(build_log, f"duck_swish_{way}_kernel")
             for way in ("forward", "backward")}
    for way in ("forward", "backward"):
        log(f"[swish] {way}: kernel {timed[f'ms_{way}'] * 1e3:.3f} us a launch ({bound_ms[way] * 1e3:.3f} "
            f"us bound by bytes, {100 * bound_ms[way] / timed[f'ms_{way}']:.1f}% of it); plain "
            f"torch kernels {timed[f'plain_ms_{way}'] * 1e3:.3f} us, torch's silu "
            f"{timed[f'library_ms_{way}'] * 1e3:.3f} us; ptxas {ptxas[way]}")
    log(f"[swish] in graphs of {SWISH_TIMED_LAUNCHES} calls over {SWISH_TIMED_INPUTS} input "
        f"sets; gpu {gpu_line()}")
    ok &= passed("swish kernels' build", ptxas_read=all(len(p) == 3 for p in ptxas.values()))
    log(f"[swish] {'OK' if ok else 'FAIL'}")
    del sets, saved, x, g
    torch.cuda.empty_cache()
    return dict(ok=ok, equal=equal, max_abs_err=worst, bound_ms=bound_ms, ptxas=ptxas, **timed)


def phase_trainer(report: dict, args=TRAINER_ARGS, label: str = "trainer") -> dict:
    """ppo.train through the runner on the card at the recipe's widths, with
    every kernel launch counted from 0 just before the call; then the kernel
    against its twin at this path's shapes and on its states. `args`: the
    runner's command line (phase 4's joystick, or phase 6's standing);
    `label` tags the output, the build directory and the parity readings.
    Phase 6 (standing) holds the kernel on its DR-on states only."""
    from open_duck_playground_tpu_torch import interop
    from open_duck_playground_tpu_torch.envs.wrapper import TrainEnv
    from open_duck_playground_tpu_torch.export.onnx_infer import NumpyOnnxSession
    from open_duck_playground_tpu_torch.export.onnx_model import load_model
    from open_duck_playground_tpu_torch.ops import cuda_step
    from open_duck_playground_tpu_torch.train import checkpoint as ckpt
    from open_duck_playground_tpu_torch.train import networks as nets
    from open_duck_playground_tpu_torch.train import optim, ppo
    from open_duck_playground_tpu_torch.train import runner as rn

    out_dir = os.path.join(ROOT, "build", f"{label}_run")
    shutil.rmtree(out_dir, ignore_errors=True)
    cli = rn.build_parser().parse_args(["--output_dir", out_dir, *args])
    runner = rn.OpenDuckMiniV2Runner(cli)
    kw = runner.train_kwargs()
    dev = runner.device
    nf = kw["network_factory"]
    T, E, nmb, B = (kw["unroll_length"], kw["num_updates_per_batch"], kw["num_minibatches"],
                    kw["num_envs"])
    recipe_ok = ((B, kw["batch_size"], nmb, T, E, kw["episode_length"]) == (8192, 256, 32, 20, 4, 1000)
                 and nf["policy_hidden_layer_sizes"] == nf["value_hidden_layer_sizes"] == (512, 256, 128)
                 and kw["randomization_fn"] is not None)
    obs_sizes = {k: v[0] for k, v in runner.env.observation_size.items()}
    sizes_ok = obs_sizes == OBS_SIZES[cli.env] and runner.obs_size == OBS_SIZES[cli.env]["state"]
    log(f"[{label}] env {cli.env} task {cli.task}: {type(runner.env).__name__}, obs sizes "
        f"{obs_sizes} (want {OBS_SIZES[cli.env]}); recipe widths {recipe_ok}")
    env_steps_per_step = B * T
    epochs = kw["num_evals"] - 1
    steps_per_epoch = math.ceil(kw["num_timesteps"] / (epochs * env_steps_per_step))
    ep_len = kw["episode_length"] // kw["action_repeat"]
    # rollouts, SGD steps and eval steps the code gives, each one replay of
    # its graph: the breakdown's rollout, SGD step and training step (each
    # run twice: warm-up, then timed), every training step's; episode_length
    # eval steps per eval: one at 0, one after each epoch, two in the
    # breakdown
    n_evals = 1 + epochs + 2
    want_replays = {"rollout": 2 + 2 + epochs * steps_per_epoch,
                    "SGD step": 2 + 2 + epochs * steps_per_epoch, "eval step": n_evals * ep_len}
    want_launches = fused_launches(T, want_replays["rollout"], n_evals, ep_len)
    graph = sgd_graph_vs_eager(runner, kw, label) if label == "trainer" else {"ok": True}
    roll_graph = rollout_graph_vs_eager(runner, kw, label) if label == "trainer" else {"ok": True}

    runner.env.physics.launches = 0
    runner.eval_env.physics.launches = 0
    cuda_step.ADAM.launches = 0
    cuda_step.GAE.launches = 0
    t0 = time.perf_counter()
    with captured_programs() as made:
        make_policy, (normalizer, params), metrics = ppo.train(
            environment=runner.env, eval_env=runner.eval_env, **kw, profile_breakdown=True)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    launches = {"train_env": runner.env.physics.launches,
                "eval_env": runner.eval_env.physics.launches}
    # the optimizer's and the GAE kernel: one launch each per minibatch
    # step, in the SGD capture's warm-up and in every replay
    mb_steps = E * nmb
    opt_launches, want_opt = cuda_step.ADAM.launches, mb_steps * (1 + want_replays["SGD step"])
    gae_launches = cuda_step.GAE.launches
    sgd_per_replay = {name: (n - mb_steps) / want_replays["SGD step"]
                      for name, n in (("duck_adam", opt_launches), ("duck_gae", gae_launches))}
    bd = ppo.LAST_PROFILE_BREAKDOWN
    # the swish's launches recorded per replay: one per hidden layer of each
    # MLP forward and backward; per minibatch step the policy's and the
    # value's forward and backward and the bootstrap value's forward
    hidden = len(nf["policy_hidden_layer_sizes"])
    swish_per_replay = {name: bd.get(key, {}).get("launches_per_replay", {}).get("duck_swish")
                        for name, key in (("rollout", "rollout_graph"), ("SGD step", "sgd_graph"),
                                          ("eval step", "eval_graph"))}
    want_swish = {"rollout": hidden * T, "SGD step": 5 * hidden * mb_steps, "eval step": hidden}
    replays = {name: [c.replays for c in made.get(name, [])] for name in want_replays}
    graph_ok = replays == {name: [n] for name, n in want_replays.items()}
    log(f"[{label}] ppo.train {t_train:.1f} s; launches {launches} (want "
        f"{want_launches}); graph replays {json.dumps(replays)} (want "
        f"{json.dumps(want_replays)}: every rollout, SGD step and eval step a replay); captures "
        f"rollout {json.dumps(bd.get('rollout_graph'))}, SGD step "
        f"{json.dumps(bd.get('sgd_graph'))}, eval step {json.dumps(bd.get('eval_graph'))}")
    log(f"[{label}] profile_breakdown {json.dumps(bd)}")
    log(f"[{label}] optimizer and GAE kernel launches {opt_launches} and {gae_launches} (want "
        f"{want_opt} each: {mb_steps} per SGD replay and in the capture's warm-up); per SGD "
        f"replay {json.dumps(sgd_per_replay)}, both recorded per SGD replay "
        f"{bd.get('sgd_graph', {}).get('fused_launches_per_replay')}")
    log(f"[{label}] swish kernel launches per replay {json.dumps(swish_per_replay)} (want "
        f"{json.dumps(want_swish)})")
    log(f"[{label}] rollout_s {bd['rollout_s']}, training_step_s {bd['training_step_s']}, "
        f"eval_s {bd['eval_s']}, sgd_s {bd['sgd_s']}; gpu {gpu_line()}")

    with open(runner.metrics_path) as f:
        lines = [json.loads(line) for line in f]
    finite = len(lines) == epochs + 1
    for line in lines:
        vals = {k: v for k, v in line.items() if k.startswith(("training/", "eval/"))}
        finite &= all(math.isfinite(v) for v in vals.values())
        if line["step"] > 0:
            finite &= "training/sps" in vals and "eval/episode_reward" in vals
            log(f"[{label}] epoch at step {line['step']}: training/sps "
                f"{line['training/sps']:.1f}, eval/episode_reward {line['eval/episode_reward']:.4f}, "
                f"eval/avg_episode_length {line['eval/avg_episode_length']:.1f}")
    count = float(normalizer.count)
    env_steps = lines[-1]["step"]
    want_steps = epochs * steps_per_epoch * env_steps_per_step
    counts_ok = count == want_steps and env_steps == want_steps == kw["num_timesteps"]
    log(f"[{label}] normalizer count {count:.0f}, env_steps {env_steps} (want {want_steps}); "
        f"metrics finite at every epoch {finite}")

    # the last (normalizer, params) checkpoint acts bit-identically
    saved = sorted((f for f in os.listdir(out_dir) if f.endswith(".npz") and not f.startswith("full_")),
                   key=lambda f: int(f[:-4].rsplit("_", 1)[1]))
    g = torch.Generator(device=dev).manual_seed(3)
    obs = {k: torch.randn((1024, n), generator=g, device=dev)
           for k, n in params.obs_sizes.items()}
    restored = ckpt.load(os.path.join(out_dir, saved[-1]), (normalizer, params))
    a_live = make_policy((normalizer, params), deterministic=True)(obs)[0]
    a_restored = make_policy(restored, deterministic=True)(obs)[0]
    ckpt_ok = bool(torch.equal(a_live, a_restored))

    # the last ONNX export against the policy on the card
    onnx = sorted((f for f in os.listdir(out_dir) if f.endswith(".onnx")),
                  key=lambda f: int(f[:-5].rsplit("_", 1)[1]))
    onnx_path = os.path.join(out_dir, onnx[-1])
    parsed = load_model(onnx_path)
    onnx_inputs = int(parsed.initializers["obs_mean"].shape[-1])
    sizes_ok &= onnx_inputs == OBS_SIZES[cli.env]["state"]
    sess = NumpyOnnxSession(onnx_path, model=parsed)
    x = obs["state"][:16].cpu().numpy()
    a_onnx = np.concatenate([sess.run(None, {"obs": x[i:i + 1]})[0] for i in range(16)])
    onnx_err = float(np.abs(a_onnx - a_live[:16].cpu().numpy()).max())
    log(f"[{label}] checkpoint {saved[-1]} acts bit-identically {ckpt_ok}; ONNX {onnx[-1]} "
        f"({onnx_inputs} inputs) vs the policy on the card: max |d| {onnx_err:.3g} (limit 1e-5)")

    # the last full-state checkpoint loads back tensor for tensor
    epoch, path = ckpt.latest_full(out_dir)
    arrays = ckpt.load_full(path)
    flat_params = ckpt.flatten(interop.ppo_params_to_numpy(params), "training_state/params/")
    flat_norm = ckpt.flatten(interop.normalizer_to_numpy(normalizer), "training_state/normalizer/")
    live_ok = all(np.array_equal(arrays[k], v) for k, v in {**flat_params, **flat_norm}.items())
    live_ok &= int(arrays["training_state/env_steps"]) == want_steps
    te = TrainEnv(runner.env, num_envs=B, episode_length=kw["episode_length"])
    tmpl_env = te.reset(torch.Generator(device=dev).manual_seed(0))
    tmpl_net = nets.PPONetworks(params.obs_sizes, params.action_size, **nf, device=dev)
    tmpl = ppo.TrainingState(params=tmpl_net, normalizer=nets.rs_init(params.obs_sizes, dev),
                             opt_state=optim.adam_init(list(tmpl_net.parameters())),
                             env_steps=torch.zeros((), dtype=torch.int64, device=dev))
    gens = {k[len("generators/"):]: torch.Generator(device=dev)
            for k in arrays if k.startswith("generators/")}
    ts, es = ppo.restore_full_state(arrays, tmpl, tmpl_env, gens)
    back = ppo.full_state_to_numpy(ppo.full_state(ts, es, gens))
    same = (back.keys() == arrays.keys()
            and all(back[k].dtype == arrays[k].dtype and np.array_equal(back[k], arrays[k])
                    for k in arrays))
    log(f"[{label}] full state {os.path.basename(path)} (epoch {epoch}): {len(arrays)} arrays, "
        f"{sum(a.nbytes for a in arrays.values())} bytes; equals the final params and "
        f"normalizer {live_ok}; loads back tensor for tensor {same}")

    evals = (eval_graph_vs_eager(runner, kw, normalizer, params, label)
             if label == "trainer" else {"ok": True})
    with torch.no_grad():
        parity_ok = trainer_vs_twin(runner, kw, es, make_policy((normalizer, params),
                                                                deterministic=True), report,
                                    label, dr_off=cli.env == "joystick",
                                    dr_substeps=None if label == "trainer" else SIDE_SUBSTEPS)
    resumed = resume_vs_run(args, out_dir, lines[-1], label) if label == "trainer" else {"ok": True}
    log(f"[{label}] gpu {gpu_line()}")
    ok = passed(label, recipe=recipe_ok, sizes=sizes_ok, metrics_finite=finite, counts=counts_ok,
                checkpoint=ckpt_ok, onnx=onnx_err <= 1e-5, full_state_live=live_ok,
                full_state_loads=same, full_state_epoch=epoch == epochs - 1,
                kernel_vs_twin=parity_ok, sgd_graph_vs_eager=graph["ok"],
                rollout_graph_vs_eager=roll_graph["ok"], eval_graph_vs_eager=evals["ok"],
                graph_replays=graph_ok, resume=resumed["ok"],
                launches=launches == want_launches, optimizer_launches=opt_launches == want_opt,
                gae_launches=gae_launches == want_opt,
                swish_launches_per_replay=swish_per_replay == want_swish)
    log(f"[{label}] {'OK' if ok else 'FAIL'}")
    return dict(ok=ok, launches=launches, optimizer_launches=opt_launches,
                gae_launches=gae_launches, sgd_per_replay=sgd_per_replay,
                swish_per_replay=swish_per_replay, breakdown=bd,
                onnx=onnx_path, sgd_graph=graph,
                rollout_graph=roll_graph, eval_graph=evals,
                sps=[line["training/sps"] for line in lines if "training/sps" in line])


@contextlib.contextmanager
def captured_programs():
    """{name: [object]} of every RolloutProgram ("rollout"), SGDStepProgram
    ("SGD step") and EvalStepProgram ("eval step") made inside (their
    replays are the objects' own)."""
    from open_duck_playground_tpu_torch.train import ppo

    made = {}
    inits = {"rollout": ppo.RolloutProgram, "SGD step": ppo.SGDStepProgram,
             "eval step": ppo.EvalStepProgram}

    def recorder(name, init):
        def recorded(self, *a, **k):
            init(self, *a, **k)
            made.setdefault(name, []).append(self)
        return recorded

    saved_inits = {name: cls.__init__ for name, cls in inits.items()}
    for name, cls in inits.items():
        cls.__init__ = recorder(name, saved_inits[name])
    try:
        yield made
    finally:
        for name, cls in inits.items():
            cls.__init__ = saved_inits[name]


def _bits(a: np.ndarray) -> tuple:
    return a.dtype.str, a.shape, a.tobytes()


def resume_vs_run(args, out_dir: str, last_line: dict, label: str) -> dict:
    """Phase 4, after ppo.train: exact resume through the graphs on the
    card. The run's full_00000.npz (the state after epoch 0) is copied into
    a fresh directory and the runner is built there from the same argv with
    --auto_resume: train() restores that state into the learner's and the
    env's buffers, captures every graph anew and trains epoch 1, its kernel
    launches counted from 0. Checks against the uninterrupted run
    (`out_dir`, whose last metrics line is `last_line`), bit for bit: epoch
    1's metrics.jsonl line to every digit (all keys but the two read off
    the host's clock, training/sps and training/walltime), and the params,
    Adam state and normalizer of full_00001.npz; also that every rollout,
    SGD step and eval step of the resumed run was a graph replay, the
    launches the code gives, and the whole full_00001.npz (env state and
    generators too) equal array for array."""
    from open_duck_playground_tpu_torch.train import checkpoint as ckpt
    from open_duck_playground_tpu_torch.train import runner as rn

    res_dir = os.path.join(ROOT, "build", f"{label}_resume")
    shutil.rmtree(res_dir, ignore_errors=True)
    os.makedirs(res_dir)
    shutil.copy(ckpt.full_path(out_dir, 0), res_dir)
    runner = rn.OpenDuckMiniV2Runner(rn.build_parser().parse_args(
        ["--output_dir", res_dir, *args, "--auto_resume"]))
    kw = runner.train_kwargs()
    T, ep_len = kw["unroll_length"], kw["episode_length"] // kw["action_repeat"]
    steps = math.ceil(kw["num_timesteps"] / ((kw["num_evals"] - 1) * kw["num_envs"] * T))
    runner.env.physics.launches = runner.eval_env.physics.launches = 0
    t0 = time.perf_counter()
    with captured_programs() as made:
        runner.train()
    torch.cuda.synchronize()
    t_resume = time.perf_counter() - t0
    launches = {"train_env": runner.env.physics.launches,
                "eval_env": runner.eval_env.physics.launches}
    want_launches = fused_launches(T, steps, 1, ep_len)  # one epoch, one eval
    replays = {name: [c.replays for c in made.get(name, [])]
               for name in ("rollout", "SGD step", "eval step")}
    want_replays = {"rollout": [steps], "SGD step": [steps], "eval step": [ep_len]}

    clock = ("training/sps", "training/walltime")
    with open(runner.metrics_path) as f:
        res_lines = [json.loads(line) for line in f]
    same_line = (len(res_lines) == 1 and res_lines[0]["step"] == last_line["step"]
                 and json.dumps({k: v for k, v in res_lines[0].items() if k not in clock},
                                sort_keys=True)
                 == json.dumps({k: v for k, v in last_line.items() if k not in clock},
                               sort_keys=True))
    a = ckpt.load_full(ckpt.full_path(out_dir, 1))
    b = ckpt.load_full(ckpt.full_path(res_dir, 1))
    learner = [k for k in a if k.startswith(("training_state/params/",
                                             "training_state/opt_state/",
                                             "training_state/normalizer/"))]
    learner_same = (bool(learner) and all(k in b and _bits(a[k]) == _bits(b[k])
                                          for k in learner))
    differing = sorted(k for k in a.keys() | b.keys()
                       if k not in a or k not in b or _bits(a[k]) != _bits(b[k]))
    log(f"[{label}] resumed from full_00000.npz in {res_dir}: train() {t_resume:.1f} s; epoch 1's "
        f"line {json.dumps(res_lines[-1] if res_lines else None)}; equal to the run's (all but "
        f"{', '.join(clock)}) {same_line}; params, Adam state and normalizer ({len(learner)} "
        f"arrays) bit for bit {learner_same}; arrays of the whole full state "
        f"differing {len(differing)} of {len(a)} {differing[:8]}; graph replays "
        f"{json.dumps(replays)} (want {json.dumps(want_replays)}); launches {launches} (want "
        f"{want_launches})")
    log(f"[check] {label} resume: epoch 1's metrics line bit for bit {same_line}")
    log(f"[check] {label} resume: final params, Adam state and normalizer bit for bit "
        f"{learner_same}")
    ok = passed(f"{label} resume", metrics_line=same_line, learner=learner_same,
                full_state=not differing, graph_replays=replays == want_replays,
                launches=launches == want_launches)
    del runner, made
    torch.cuda.empty_cache()
    return dict(ok=ok, seconds=t_resume, differing=differing)


def sgd_graph_vs_eager(runner, kw, label: str) -> dict:
    """Phase 4, before ppo.train: the captured SGD step against its eager
    body at the recipe's widths. Two states from train()'s init (the same
    seed), one run by ppo.sgd_step, the other by an SGDStepProgram, take
    SGD_GRAPH_STEPS SGD steps on the same data and draws (each a rollout of
    the eager state's policy on the train env, 8192 DR envs); after each,
    the params, Adam count and moments, normalizer and loss terms must be
    equal bit for bit (limit 0: the same kernels on the same inputs). The
    last step of each is traced (build/sgd_graph/trace.json): host launches
    (runtime calls that put work on the card: kernels, copies, sets, graph
    launches) per minibatch step, graph replays, device ms and idle share.
    Prints each step's host seconds, eager against captured (the first
    captured call includes the capture), and the capture's warm-up, capture
    and instantiation seconds and graph pool bytes."""
    from open_duck_playground_tpu_torch.envs.wrapper import TrainEnv
    from open_duck_playground_tpu_torch.train import ppo
    from open_duck_playground_tpu_torch.utils import profiling

    dev = runner.device
    hp = _trainer_hyper(kw)
    mb_steps = hp.num_updates_per_batch * hp.num_minibatches
    gens = ppo.seeded_generators(kw["seed"], dev)
    env = runner.env
    te = TrainEnv(env, num_envs=hp.num_envs, episode_length=kw["episode_length"],
                  randomization_fn=kw["randomization_fn"],
                  randomization_generator=gens["randomization"])
    obs_sizes = {k: v[0] for k, v in env.observation_size.items()}

    def init():
        g = ppo.seeded_generators(kw["seed"], dev)["net"]
        return ppo.init_training_state(obs_sizes, env.action_size, kw["network_factory"], g, dev)

    eager, graphed = init(), init()
    cap = ppo.SGDStepProgram(graphed, hp)
    state = te.reset(gens["reset"])
    out_dir = os.path.join(ROOT, "build", "sgd_graph")
    shutil.rmtree(out_dir, ignore_errors=True)
    steps, ok = [], True
    for i in range(SGD_GRAPH_STEPS):
        noise, perms, ent = ppo.draw_training_step(gens["epoch"], hp, env.action_size, dev)
        state, data = ppo.rollout(te, state, eager.normalizer, eager.params, noise)
        torch.cuda.synchronize()
        traced = i == SGD_GRAPH_STEPS - 1
        with (profiling.trace(out_dir, device=dev) if traced else contextlib.nullcontext()):
            times = {}
            for name, fn, ts in (("eager", ppo.sgd_step, eager), ("graph", cap, graphed)):
                t0 = time.perf_counter()
                with profiling.annotate(f"{name}_sgd"):
                    _, losses = fn(ts, data, perms, ent, hp)
                    torch.cuda.synchronize()
                times[name] = (time.perf_counter() - t0, losses)
        la, lb = times["eager"][1], times["graph"][1]
        ta, tb = ppo.learner_tensors(eager), ppo.learner_tensors(graphed)
        differ = [j for j, (a, b) in enumerate(zip(ta, tb)) if not torch.equal(a, b)]
        worst = max((float((ta[j].double() - tb[j].double()).abs().max()) for j in differ),
                    default=0.0)
        loss_same = la.keys() == lb.keys() and all(torch.equal(la[k], lb[k]) for k in la)
        ok &= passed(f"{label} SGD step {i + 1} captured vs eager", learner_equal=not differ,
                     losses_equal=loss_same)
        steps.append({"eager_s": round(times["eager"][0], 4), "graph_s": round(times["graph"][0], 4),
                      "tensors_differing": len(differ), "max_abs_diff": worst,
                      "losses_equal": loss_same, "traced": traced})
        log(f"[{label}] SGD step {i + 1} at {hp.num_envs} envs, eager vs captured: "
            f"{json.dumps(steps[-1])}")
    split = trace_split(read_trace(os.path.join(out_dir, "trace.json")), ("eager_sgd", "graph_sgd"))
    per_mb = {k: split[f"{k}_sgd"]["host_calls"] / mb_steps for k in ("eager", "graph")}
    event_ms = cuda_ms(cap.graph.graph.replay, reps=1)
    out = {"steps": steps, "capture": cap.info, "replays": cap.replays,
           "host_launches_per_minibatch_step": per_mb,
           "graph_replays_in_traced_call": split["graph_sgd"]["graph_launches"],
           "replay_event_ms": event_ms,
           "split": {k: {f: split[f"{k}_sgd"][f] for f in (
               "host_ms", "device_ms", "launches", "host_calls", "graph_launches", "copies",
               "waits", "idle_share")} for k in ("eager", "graph")}}
    ok &= passed(f"{label} captured SGD step", replays=cap.replays == SGD_GRAPH_STEPS,
                 host_launches_per_minibatch_step=per_mb["graph"] <= 4,
                 one_replay_traced=out["graph_replays_in_traced_call"] == 1)
    log(f"[{label}] captured SGD step: capture {json.dumps(cap.info)}; replays {cap.replays} "
        f"(one per SGD step); host launches per minibatch step {per_mb['graph']:.3f} captured "
        f"against {per_mb['eager']:.1f} eager (limit 4); one replay {event_ms:.3f} ms by CUDA "
        f"events")
    log_split("sgd graph", split)
    log(f"[{label}] captured SGD step vs eager body: {'OK' if ok else 'FAIL'}")
    del eager, graphed, cap, te, state, data
    torch.cuda.empty_cache()
    return dict(ok=ok, **out)


def _trainer_hyper(kw):
    import dataclasses
    import inspect

    from open_duck_playground_tpu_torch.train import ppo

    defaults = inspect.signature(ppo.train).parameters
    return ppo.Hyper(**{f.name: kw.get(f.name, defaults[f.name].default)
                        for f in dataclasses.fields(ppo.Hyper)})


def rollout_graph_vs_eager(runner, kw, label: str, rollouts: int = ROLLOUT_GRAPH_ROLLOUTS) -> dict:
    """Phase 4, before ppo.train (and phase 8's pipeline trainer): the
    captured rollout against the eager one at the recipe's widths (8192 DR
    envs on the train env, unroll 20, the policy of train()'s init; on the
    pipeline one replay per env step, RolloutProgram.span). From one
    reset and one state of the env's generator, `rollouts` consecutive
    rollouts run by
    ppo.rollout, then as many by a RolloutProgram (the first call
    captures), on the same policy noise: every rollout's final env state and
    Transition, and the env generator's state after the last, equal bit for
    bit (limit 0: the same kernels on the same inputs, the same draws).
    Prints each rollout's seconds, eager against captured (the first
    captured call includes the capture), and the capture's warm-up, capture
    and instantiation seconds and graph pool bytes."""
    from open_duck_playground_tpu_torch.envs.wrapper import TrainEnv
    from open_duck_playground_tpu_torch.train import ppo
    from open_duck_playground_tpu_torch.utils.graphs import tree_map

    dev = runner.device
    hp = _trainer_hyper(kw)
    gens = ppo.seeded_generators(kw["seed"], dev)
    env = runner.env
    te = TrainEnv(env, num_envs=hp.num_envs, episode_length=kw["episode_length"],
                  randomization_fn=kw["randomization_fn"],
                  randomization_generator=gens["randomization"])
    obs_sizes = {k: v[0] for k, v in env.observation_size.items()}
    ts = ppo.init_training_state(obs_sizes, env.action_size, kw["network_factory"], gens["net"],
                                 dev)
    start = te.reset(gens["reset"])
    noises = [ppo.draw_training_step(gens["epoch"], hp, env.action_size, dev)[0]
              for _ in range(rollouts)]
    g0 = env.generator.get_state()
    cap = ppo.RolloutProgram(te, ts.normalizer, ts.params, hp)
    out, ok = {}, True
    for name, fn in (("eager", ppo.rollout), ("graph", cap)):
        env.generator.set_state(g0)
        state, runs = start, []
        for noise in noises:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, data = fn(te, state, ts.normalizer, ts.params, noise)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0,
                         tree_map(torch.clone, {"state": state, "data": data})))
        out[name] = (runs, env.generator.get_state())
    (eager, g_eager), (graph, g_graph) = out["eager"], out["graph"]
    same = [bitwise_equal(a[1], b[1]) for a, b in zip(eager, graph)]
    gens_same = bool(torch.equal(g_eager, g_graph))
    per_rollout = hp.unroll_length // cap.span
    ok = passed(f"{label} rollout captured vs eager", states_and_transitions_equal=all(same),
                generators_equal=gens_same,
                replays=cap.replays == rollouts * per_rollout)
    res = {"eager_s": [round(r[0], 4) for r in eager], "graph_s": [round(r[0], 4) for r in graph],
           "equal": same, "generators_equal": gens_same, "capture": cap.graph.info,
           "replays": cap.replays}
    log(f"[{label}] rollout at {hp.num_envs} envs x {hp.unroll_length} steps, eager vs captured: "
        f"{json.dumps(res)}; {'OK' if ok else 'FAIL'}")
    del cap, te, start, out, eager, graph
    torch.cuda.empty_cache()
    return dict(ok=ok, **res)


def eval_graph_vs_eager(runner, kw, normalizer, params, label: str) -> dict:
    """Phase 4, after ppo.train: one eval of the trained policy (the eval
    env, num_eval_envs envs, the first EVAL_CHECK_STEPS steps of an episode, train()'s
    stochastic or deterministic policy) by ppo.run_eval with the eager
    eval_step and twice with an EvalStepProgram (the first captures), each
    from the same generator states: every eval metric equal to every digit.
    Prints each run's seconds."""
    from open_duck_playground_tpu_torch.envs.wrapper import TrainEnv
    from open_duck_playground_tpu_torch.train import ppo

    dev = runner.device
    te = TrainEnv(runner.eval_env, num_envs=kw["num_eval_envs"],
                  episode_length=kw["episode_length"])
    steps = EVAL_CHECK_STEPS
    det = kw.get("deterministic_eval", False)
    g = torch.Generator(device=dev)
    cap = ppo.EvalStepProgram(te, normalizer, params, g, det)
    outs, secs = [], []
    for step in (ppo.eval_step, cap, cap):
        g.manual_seed(5)
        runner.eval_env.generator.manual_seed(6)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ppo.run_eval(te, normalizer, params, g, episode_length=steps,
                           deterministic=det, step=step)
        outs.append({k: float(v) for k, v in out.items()})
        secs.append(round(time.perf_counter() - t0, 4))
    same = outs[1] == outs[0] and outs[2] == outs[0]
    ok = passed(f"{label} eval captured vs eager", metrics_equal=same,
                replays=cap.replays == 2 * steps)
    log(f"[{label}] eval at {te.num_envs} envs x {steps} steps: seconds eager "
        f"{secs[0]}, captured {secs[1]} (with the capture) and {secs[2]}; eval/episode_reward "
        f"eager {outs[0]['eval/episode_reward']!r}, captured {outs[1]['eval/episode_reward']!r} "
        f"and {outs[2]['eval/episode_reward']!r}; every metric equal {same}; capture "
        f"{json.dumps(cap.graph.info)}; {'OK' if ok else 'FAIL'}")
    return dict(ok=ok, seconds=secs, metrics=outs[0], capture=cap.graph.info)


def trainer_vs_twin(runner, kw, trained, policy, report, label: str = "trainer",
                    dr_off: bool = True, dr_substeps: Optional[int] = None) -> bool:
    """The kernel against its twin on the trainer path's inputs: the train
    env (flat_terrain_backlash, 8192 envs, DR on with train()'s own draw,
    rebuilt from the seed) from a reset (init variant) and from the trained
    state of the last full-state checkpoint (step variant, `dr_substeps`
    substeps, a whole control step if None: with DR on the two agree bit
    for bit); with `dr_off`, the
    eval env (1024 envs, DR off) from a reset and after 20 steps of the
    trained deterministic policy (step variant, a whole control step). Limits: duck_standin.TRAINER_PARITY_LIMITS.
    Readings go into report under "<label> ..." tags; returns whether all
    are within their limits."""
    from open_duck_playground_tpu_torch.envs.wrapper import TrainEnv
    from open_duck_playground_tpu_torch.ops.cuda_step import flatten_dr_fields
    from open_duck_playground_tpu_torch.train import ppo

    dev = runner.device
    g = torch.Generator(device=dev).manual_seed(4)
    train_env = TrainEnv(runner.env, num_envs=kw["num_envs"], episode_length=kw["episode_length"],
                         randomization_fn=kw["randomization_fn"],
                         randomization_generator=ppo.seeded_generators(kw["seed"], dev)["randomization"])
    eval_env = TrainEnv(runner.eval_env, num_envs=kw["num_eval_envs"],
                        episode_length=kw["episode_length"])
    cases = [("train_env", train_env, True, train_env.reset(g).data, trained.data)]
    if dr_off:
        eval_state = eval_env.reset(g)
        eval_reset = eval_state.data
        for _ in range(20):
            eval_state = eval_env.step(eval_state, policy(eval_state.obs)[0])
        cases.append(("eval_env", eval_env, False, eval_reset, eval_state.data))
    ok = True
    for name, te, with_dr, reset, stepped in cases:
        fp = te.env.physics
        dr = flatten_dr_fields(te.model) if with_dr else None
        accel = int(fp.model.sensor_adr[fp.model.sensor("accelerometer")])
        n_step = dr_substeps if with_dr and dr_substeps is not None else te.env.n_substeps
        for variant, n, data in (("step", n_step, stepped), ("init", 1, reset)):
            warm = data.qacc_warmstart if variant == "step" else torch.zeros_like(data.qvel)
            args = (data.qpos.contiguous(), data.qvel.contiguous(), warm.contiguous(),
                    data.ctrl.contiguous(), n, dr)
            tag = f"{label} {name} {TRAINER_TASK} B={te.num_envs} dr={int(with_dr)} {variant}"
            ok &= parity_table(tag, fp(*args), fp.plain(*args), accel, variant, with_dr,
                               False, report, standin().TRAINER_PARITY_LIMITS[(variant, with_dr)])
    return ok


def phase_sharded() -> list:
    """Phase 5: the env-sharded trainer under torch.distributed.run, world 2
    sharing the one card over gloo, first as train() runs it (the graphs),
    then with the eager bodies asked for by name (the parent's path, timed
    in the same call) and, where there are two cards or more, world
    min(cards, 4) over NCCL. Returns one result per run."""
    cards = torch.cuda.device_count()
    runs = [("gloo", 2, "graph"), ("gloo", 2, "eager")]
    runs += [("nccl", min(cards, 4), "graph")] if cards >= 2 else []
    return [run_sharded(backend, world, bodies) for backend, world, bodies in runs]


def run_sharded(backend: str, world: int, bodies: str = "graph") -> dict:
    """One sharded run: each rank runs rank_worker and leaves its report in
    build/sharded_<backend>_<world>_<bodies>/rank<r>.json; the checks across
    ranks are made here."""
    out = os.path.join(ROOT, "build", f"sharded_{backend}_{world}_{bodies}")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={world}", os.path.join(ROOT, "chip_smoke.py"),
           "--rank-worker", out, backend, bodies]
    tag = f"{backend} world {world} {bodies}"
    log(f"[sharded] {tag}: {' '.join(cmd[1:])}")
    t0 = time.perf_counter()
    # a session of its own, so that a timeout stops torchrun and its ranks
    proc = subprocess.Popen(cmd, start_new_session=True)
    try:
        rc = proc.wait(timeout=SHARDED_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.wait()
        rc = "timeout"
    wall = time.perf_counter() - t0
    reps = []
    for r in range(world):
        path = os.path.join(out, f"rank{r}.json")
        if os.path.exists(path):
            with open(path) as f:
                reps.append(json.load(f))
    ok = passed(f"sharded {tag}", exit=rc == 0, reports=len(reps) == world)
    log(f"[sharded] {tag}: exit {rc} after {wall:.1f} s; {len(reps)} of {world} rank reports")
    if ok:
        ok = check_sharded(tag, backend, world, torch.cuda.device_count(), reps, out,
                           SHARDED_ARGS[bodies])
    return dict(ok=ok, backend=backend, world=world, bodies=bodies, reps=reps, wall_s=wall)


def check_sharded(tag: str, backend: str, world: int, cards: int, reps: list, out: str,
                  args=TRAINER_ARGS) -> bool:
    """Print each rank's report and check what spans the ranks: every rank's
    own checks, the same params everywhere, each rank on its card (ranks
    share cards only over gloo), finite metrics and the global counts of
    the runner's command line `args`."""
    from open_duck_playground_tpu_torch.train import runner as rn

    cli = rn.build_parser().parse_args(list(args))
    ok = True
    for rep in reps:
        r = rep["rank"]
        ok &= passed(f"sharded {tag} rank {r}", **rep["checks"])
        log(f"[sharded] {tag} rank {r} on {rep['device']}: {rep['rows']} train rows; geometry "
            f"{rep['geometry']}; launches {rep['launches']} (want {rep['want']}), launches seen "
            f"by the host {rep['launch_rows']} (want {rep['want_seen']}); graph replays "
            f"{json.dumps(rep['replays'])} (want {json.dumps(rep['want_replays'])}); kernel "
            f"{rep['kernel_ms']} ms per control step at {rep['rows']} rows; train "
            f"{rep['t_train']:.1f} s")
        log(f"[sharded] {tag} rank {r} profile_breakdown {json.dumps(rep['breakdown'])}")
        if rep.get("sgd_segments"):
            seg = rep["sgd_segments"]
            log(f"[sharded] {tag} rank {r} SGD segments: {seg['segments']} graphs, capture s "
                f"min {min(seg['capture_s']):.6f} median {seg['capture_s_median']:.6f} max "
                f"{max(seg['capture_s']):.6f} sum {sum(seg['capture_s']):.4f} (each in "
                f"{out}/rank{r}.json), pool {seg['pool_bytes']} bytes")
        if "invariance" in rep:
            log(f"[sharded] {tag} rank {r} world {world} vs world 1, one training step: "
                f"{json.dumps(rep['invariance'])}")
            log(f"[sharded] {tag} rank {r} world {world} replays vs eager bodies, one training "
                f"step: {json.dumps(rep['graph_vs_eager'])}")
        log(f"[sharded] {tag} rank {r} traced training step: {json.dumps(rep['traced'])}")
        log(f"[sharded] {tag} rank {r} checks {json.dumps(rep['checks'])}")
    devices = [rep["device"] for rep in reps]
    own_cards = [f"cuda:{r % cards}" for r in range(world)]
    same_params = len({rep["params_digest"] for rep in reps}) == 1
    ok &= passed(f"sharded {tag}", same_params=same_params,
                 devices=devices == own_cards and (backend == "gloo" or len(set(devices)) == world))
    with open(os.path.join(out, "run", "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    finite = len(lines) == cli.num_evals and all(
        math.isfinite(v) for line in lines for k, v in line.items()
        if k.startswith(("training/", "eval/")))
    for line in lines[1:]:
        log(f"[sharded] {tag} epoch at step {line['step']}: training/sps "
            f"{line['training/sps']:.1f}, eval/episode_reward {line['eval/episode_reward']:.4f}")
    ok &= passed(f"sharded {tag}", metrics_finite=finite,
                 env_steps=lines[-1]["step"] == cli.num_timesteps)
    log(f"[sharded] {tag}: devices {devices}; params identical on every rank {same_params}; "
        f"metrics finite {finite}; gpu {gpu_line()}; {'OK' if ok else 'FAIL'}")
    return ok


def rank_worker(out: str, backend: str, bodies: str = "graph") -> int:
    """One rank of phase 5 (run by torch.distributed.run): joins the group
    as the runner does, trains, checks, and writes rank<r>.json into `out`.
    `bodies` "eager" asks for the eager bodies (sharded_rank)."""
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    asset_root()
    from open_duck_playground_tpu_torch.parallel import dist as pdist
    from open_duck_playground_tpu_torch.train import runner as rn

    args = rn.build_parser().parse_args(
        ["--output_dir", os.path.join(out, "run"), *SHARDED_ARGS[bodies], "--dist_backend",
         backend])
    shard = rn.init_distributed(args)
    try:
        rep = sharded_rank(rn.OpenDuckMiniV2Runner(args, shard), shard, out,
                           eager={"graph": False, "eager": True}[bodies])
    finally:
        pdist.destroy()
    with open(os.path.join(out, f"rank{shard.rank}.json"), "w") as f:
        json.dump(rep, f)
    return 0


def _spy_launches(fp, seen: dict):
    """Record the rows and device of each launch of `fp`'s kernel the host
    makes (eagerly, at a warm-up or while a graph captures; a replay
    launches from the graph, not through here; the launch itself, and its
    count, are fp's own)."""
    launch = fp._launch

    def counted(qpos, *args):
        key = f"{qpos.shape[0]} rows on {qpos.device}"
        seen[key] = seen.get(key, 0) + 1
        return launch(qpos, *args)

    fp._launch = counted


@contextlib.contextmanager
def eager_bodies():
    """ppo.train's rollout, eval step and SGD step programs running their
    bodies eagerly on the card too (utils.graphs.GraphedBody told the card
    captures nothing): what the trainer ran at world > 1 before its graphs,
    asked for by phase 5's eager run to time it beside the graphs in one
    call. A choice of this check: the trainer itself never falls back."""
    from open_duck_playground_tpu_torch.utils.graphs import GraphedBody

    saved = GraphedBody.__dict__["captures"]
    GraphedBody.captures = staticmethod(lambda device: False)
    try:
        yield {}
    finally:
        GraphedBody.captures = saved


def sharded_rank(runner, shard, out: str, eager: bool = False) -> dict:
    """Phase 5's work on one rank: the main path (ppo.train through the
    runner's recipe) with its launches counted from 0, then checks (a)-(f)
    of the module docstring. Every rank makes the same collectives. With
    `eager`, train() runs the eager bodies (eager_bodies), and only (a),
    (b) and the traced step of (f) run: the parent's numbers."""
    import hashlib

    from open_duck_playground_tpu_torch import interop
    from open_duck_playground_tpu_torch.envs.joystick import Joystick
    from open_duck_playground_tpu_torch.envs.wrapper import TrainEnv
    from open_duck_playground_tpu_torch.ops.cuda_step import flatten_dr_fields
    from open_duck_playground_tpu_torch.train import checkpoint as ckpt
    from open_duck_playground_tpu_torch.train import ppo
    from open_duck_playground_tpu_torch.utils import profiling
    from open_duck_playground_tpu_torch.utils.graphs import tree_leaves, tree_map

    dev = shard.device
    kw = runner.train_kwargs()
    if eager:
        kw["episode_length"] = EAGER_EVAL_STEPS
    nf = kw["network_factory"]
    T, B = kw["unroll_length"], kw["num_envs"]
    rows, eval_rows = shard.local(B), shard.local(kw["num_eval_envs"])
    epochs = kw["num_evals"] - 1
    steps_per_epoch = math.ceil(kw["num_timesteps"] / (epochs * B * T))
    ep_len = kw["episode_length"] // kw["action_repeat"]
    hp = _trainer_hyper(kw)
    # rollouts, SGD steps and eval steps the code gives (as phase 4):
    # profile_breakdown's rollout and training step twice each, every
    # training step's; episode_length eval steps per eval (one at 0, one
    # after each epoch, two in the breakdown). Captured, each is one replay
    # (the SGD step one chain), and the rollout's and the eval's captures
    # each add one real warm-up (T env steps, one eval step); the host
    # itself calls the kernel at the resets, the warm-ups and the captures;
    # at world > 1 profile_breakdown runs the SGD step once more,
    # its collectives timed
    n_evals = 1 + epochs + 2
    rollouts = 2 + 2 + epochs * steps_per_epoch
    want_replays = ({} if eager else
                    {"rollout": [rollouts], "SGD step": [rollouts + 1],
                     "eval step": [n_evals * ep_len]})
    warm = 0 if eager else 1
    want = {"train_env": 1 + T * (warm + rollouts),
            "eval_env": n_evals * (1 + ep_len) + warm}
    want_seen = want if eager else {"train_env": 1 + 2 * T, "eval_env": n_evals + 2}
    envs = {"train_env": runner.env, "eval_env": runner.eval_env}
    seen = {name: {} for name in envs}

    # (a) the main path, every launch counted from 0 just before it
    for name, env in envs.items():
        _spy_launches(env.physics, seen[name])
        env.physics.launches = 0
    t0 = time.perf_counter()
    with (eager_bodies() if eager else captured_programs()) as made:
        _, (normalizer, params), _ = ppo.train(environment=runner.env, eval_env=runner.eval_env,
                                               **kw, profile_breakdown=True)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    launches = {name: env.physics.launches for name, env in envs.items()}
    for env in envs.values():
        del env.physics._launch
    bd = ppo.LAST_PROFILE_BREAKDOWN
    fp = runner.env.physics
    replays = {name: [c.replays for c in objs] for name, objs in made.items()}
    n_collectives = ppo.sgd_collectives(hp, len(normalizer.mean))
    per_replay = {name: bd.get(key, {}).get("launches_per_replay", {}).get("fused_physics_step")
                  for name, key in (("rollout", "rollout_graph"), ("eval_step", "eval_graph"))}
    checks = {"launches": launches == want,
              "launch_rows": seen == {name: {f"{n} rows on {dev}": want_seen[name]}
                                      for name, n in (("train_env", rows),
                                                      ("eval_env", eval_rows))},
              "replays": replays == want_replays,
              "count": float(normalizer.count) == kw["num_timesteps"],
              "sgd_collectives": bd["sgd_collectives"] == n_collectives}
    if not eager:
        checks["launches_per_replay"] = per_replay == {"rollout": T, "eval_step": 1}
        checks["sgd_segments"] = bd["sgd_graph"].get("segments") == n_collectives + 1
    sgd_graph = made.get("SGD step", [None])[0]
    segments = None if sgd_graph is None else {
        "segments": len(sgd_graph.graph.segment_capture_s),
        "capture_s": sgd_graph.graph.segment_capture_s,
        "capture_s_median": float(np.median(sgd_graph.graph.segment_capture_s)),
        "pool_bytes": sgd_graph.info["pool_bytes"]}

    # (b) the params every rank ends with (train() checked the replicated
    # state after every epoch)
    h = hashlib.sha256()
    for a in (interop.ppo_params_to_numpy(params), interop.normalizer_to_numpy(normalizer)):
        for _, v in sorted(ckpt.flatten(a).items()):
            h.update(np.ascontiguousarray(v).tobytes())

    # (c) one training step from train()'s init and the same global draws:
    # at world 1 (eager rollout, captured SGD step, as before), and at this
    # world size through the eager bodies and through the graphs
    def one_step(env_shard, graphs: bool):
        gens = ppo.seeded_generators(kw["seed"], dev)
        env = Joystick(TRAINER_TASK, device=dev)
        env.shard = env_shard
        env.generator.set_state(gens["env"].get_state())
        te = TrainEnv(env, num_envs=B if env_shard is None else rows,
                      episode_length=kw["episode_length"], randomization_fn=kw["randomization_fn"],
                      randomization_generator=gens["randomization"])
        obs_sizes = {k: v[0] for k, v in env.observation_size.items()}
        ts = ppo.init_training_state(obs_sizes, env.action_size, nf, gens["net"], dev)
        state = te.reset(gens["reset"])
        noise, perms, ent = ppo.draw_training_step(gens["epoch"], hp, env.action_size, dev)
        if env_shard is not None:
            noise = env_shard.take(noise, dim=1)
        roll = ppo.make_rollout(te, ts, hp) if graphs and env_shard is not None else ppo.rollout
        sgd = ppo.make_sgd_step(ts, hp, env_shard) if graphs else ppo.sgd_step
        state, data = roll(te, state, ts.normalizer, ts.params, noise)
        data, state = tree_map(torch.clone, data), tree_map(torch.clone, state)
        ts, losses = sgd(ts, data, perms, ent, hp, env_shard)
        ts = ts.replace(env_steps=ts.env_steps + hp.env_steps_per_training_step)
        kinds = [type(f).__name__ if isinstance(f, (ppo.RolloutProgram, ppo.SGDStepProgram))
                 else f.__name__ for f in (roll, sgd)]
        return dict(ts=ts, state=state, data=data, te=te, losses=losses, kinds=kinds, roll=roll,
                    sgd=sgd, gens={"epoch": gens["epoch"], "env": env.generator})

    def traced_step(step, label: str) -> dict:
        """One more training step of `step`'s programs, traced on this rank
        (its own device work: the other ranks' kernels on a shared card are
        not in this process's trace)."""
        trace_dir = os.path.join(out, f"trace_{label}_rank{shard.rank}")

        def annotated(name, fn):
            def call(*a, **k):
                with profiling.annotate(name):
                    return fn(*a, **k)
            return call

        draws = ppo.draw_training_step(step["gens"]["epoch"], hp, runner.env.action_size, dev)
        torch.cuda.synchronize()
        n0 = shard.collectives
        with profiling.trace(trace_dir, device=dev):
            with profiling.annotate("training_step"):
                ts, state, _ = ppo.training_step(
                    step["ts"], step["te"], step["state"], draws, hp, shard,
                    sgd=annotated("sgd_step", step["sgd"]), roll=annotated("rollout", step["roll"]))
                torch.cuda.synchronize()
        collectives = shard.collectives - n0
        split = trace_split(read_trace(os.path.join(trace_dir, "trace.json")),
                            ("training_step", "rollout", "sgd_step"))
        shutil.rmtree(trace_dir, ignore_errors=True)
        step.update(ts=ts, state=state)
        roll_s, sgd_s = split["rollout"], split["sgd_step"]
        fused = roll_s["fused_per_instance"][0]
        return {"host_calls_per_sgd_step": sgd_s["host_calls"],
                "graph_replays_per_sgd_step": sgd_s["graph_launches"],
                "collectives_per_sgd_step": collectives,
                "host_waits_per_sgd_step": sgd_s["waits"],
                "sgd_device_ms": sgd_s["device_ms"], "sgd_host_ms": sgd_s["host_ms"],
                "sgd_kernels": sgd_s["launches"], "sgd_idle_share": sgd_s["idle_share"],
                "rollout_host_calls": roll_s["host_calls"],
                "rollout_graph_replays": roll_s["graph_launches"],
                "rollout_device_ms": roll_s["device_ms"], "rollout_fused_launches": fused,
                "fused_ms_per_launch_in_rollout": (roll_s["fused_share"] * roll_s["device_ms"]
                                                   / fused if fused else None),
                "training_step_host_ms": split["training_step"]["host_ms"],
                "training_step_device_ms": split["training_step"]["device_ms"],
                "idle_share": split["training_step"]["idle_share"]}

    rep = {"rank": shard.rank, "world": shard.world, "device": str(dev), "rows": rows,
           "bodies": "eager" if eager else "graph", "geometry": fp.geometry(rows, dev),
           "launches": launches, "want": want, "launch_rows": seen, "want_seen": want_seen,
           "replays": replays, "want_replays": want_replays, "launches_per_replay": per_replay,
           "t_train": t_train, "breakdown": bd, "params_digest": h.hexdigest(),
           "sgd_segments": segments, "kernel_ms": None}
    if eager:
        step = one_step(shard, graphs=False)
        rep["traced"] = traced_step(step, "eager")
        checks["traced_collectives"] = rep["traced"]["collectives_per_sgd_step"] == n_collectives
        del step
        torch.cuda.empty_cache()
        rep["checks"] = checks
        rep["ok"] = all(checks.values())
        return rep

    p0 = torch.cat([p.detach().reshape(-1) for p in ppo.init_training_state(
        params.obs_sizes, params.action_size, nf,
        ppo.seeded_generators(kw["seed"], dev)["net"], dev).params.parameters()]).double()
    one = one_step(None, graphs=True)
    ts1, data1 = one["ts"], one["data"]
    eager_w = one_step(shard, graphs=False)
    graph_w = one_step(shard, graphs=True)

    # replays against the eager bodies at this world size: bit for bit
    same = {"transitions": bitwise_equal(eager_w["data"], graph_w["data"]),
            "env_state": bitwise_equal(eager_w["state"], graph_w["state"]),
            "learner": all(torch.equal(a, b) for a, b in zip(
                ppo.learner_tensors(eager_w["ts"]), ppo.learner_tensors(graph_w["ts"]))),
            "losses": bitwise_equal(eager_w["losses"], graph_w["losses"]),
            "generators": all(torch.equal(eager_w["gens"][k].get_state(),
                                          graph_w["gens"][k].get_state())
                              for k in ("epoch", "env"))}
    rep["graph_vs_eager"] = {**same, "kinds": [eager_w["kinds"], graph_w["kinds"]],
                             "sgd_capture": graph_w["sgd"].info,
                             "rollout_capture": graph_w["roll"].graph.info}
    checks["graph_vs_eager"] = (all(same.values()) and graph_w["kinds"] ==
                                ["RolloutProgram", "SGDStepProgram"])
    del eager_w
    ts2, state2, data2, te2, gens2 = (graph_w[k] for k in ("ts", "state", "data", "te", "gens"))

    # this world size (the graphs) against world size 1
    mine = shard.rows(B)
    flat1, flat2 = {}, {}
    tree_leaves(data1, "data", flat1)
    tree_leaves(data2, "data", flat2)
    trans = {k: float((v[:, mine] - flat2[k]).abs().max()) for k, v in flat1.items()}
    per_t = [max(float((v[t, mine] - flat2[k][t]).abs().max()) for k, v in flat1.items())
             for t in range(T)]
    envs_differ = int(sum(((v[:, mine] != flat2[k]).reshape(T, rows, -1).any(-1).any(0))
                          for k, v in flat1.items()).count_nonzero())
    p1 = torch.cat([p.detach().reshape(-1) for p in ts1.params.parameters()])
    p2 = torch.cat([p.detach().reshape(-1) for p in ts2.params.parameters()])
    d = (p1 - p2).abs().double()
    u1, u2 = p1.double() - p0, p2.double() - p0
    cos = float(u1 @ u2 / (u1.norm() * u2.norm()))
    norm_d = max(float((ts1.normalizer.mean[k] - ts2.normalizer.mean[k]).abs().max())
                 for k in ts1.normalizer.mean)
    inv = {"transitions_max": max(trans.values()), "transitions_worst": max(trans, key=trans.get),
           "transitions_max_per_step": per_t, "transitions": trans,
           "envs_differing": envs_differ, "params_q99": float(torch.quantile(d, 0.99)),
           "params_max": float(d.max()), "update_cos": cos, "normalizer_mean_max": norm_d,
           "count": [float(ts1.normalizer.count), float(ts2.normalizer.count)],
           "env_steps": [int(ts1.env_steps), int(ts2.env_steps)],
           "steps": [one["kinds"], graph_w["kinds"]]}
    checks["invariance"] = (one["kinds"] == ["rollout", "SGDStepProgram"]
                            and graph_w["kinds"] == ["RolloutProgram", "SGDStepProgram"]
                            and inv["transitions_max"] <= SHARDED_LIMITS["transitions"]
                            and inv["params_q99"] <= SHARDED_LIMITS["params_q99"]
                            and inv["params_max"] <= SHARDED_LIMITS["params_max"]
                            and cos >= SHARDED_LIMITS["update_cos"]
                            and norm_d <= SHARDED_LIMITS["normalizer"]
                            and inv["count"][0] == inv["count"][1]
                            and inv["env_steps"][0] == inv["env_steps"][1])
    rep["invariance"] = inv
    del one, ts1, data1, flat1, flat2

    # (e) a gathered full state of that step, written by rank 0, holds the
    # global rows, and each rank's rows of it are its live state; the
    # trainer's last full state holds the global rows and the final params
    arrays = ppo.full_state_to_numpy(ppo.full_state(ts2, state2, gens2, shard))
    if shard.is_main:
        ckpt.save_full(os.path.join(out, "full_step"), 0, arrays)
    shard.barrier()
    saved = ckpt.load_full(ckpt.full_path(os.path.join(out, "full_step"), 0))
    obs_sizes = params.obs_sizes
    tmpl = ppo.init_training_state(obs_sizes, params.action_size, nf,
                                   torch.Generator(device=dev).manual_seed(0), dev)
    gens_t = {k: torch.Generator(device=dev) for k in gens2}
    ts_b, es_b = ppo.restore_full_state(saved, tmpl, state2, gens_t, shard)
    live, back = {}, {}
    tree_leaves(state2, "env_state", live)
    tree_leaves(es_b, "env_state", back)
    checks["full_state_rows"] = (
        all(v.shape[0] == B for k, v in saved.items() if k.startswith("env_state/"))
        and all(torch.equal(live[k], back[k]) for k in live)
        and all(torch.equal(a, b) for a, b in zip(ts_b.params.parameters(),
                                                  ts2.params.parameters())))
    last_epoch, last_path = ckpt.latest_full(os.path.join(out, "run"))
    trained = ckpt.load_full(last_path)
    flat_params = ckpt.flatten(interop.ppo_params_to_numpy(params), "training_state/params/")
    checks["trainer_full_state"] = (
        last_epoch == epochs - 1
        and all(v.shape[0] == B for k, v in trained.items() if k.startswith("env_state/"))
        and all(np.array_equal(trained[k], v) for k, v in flat_params.items()))
    del ts_b, es_b, live, back, saved, arrays

    # (f) one more training step of the graphs, traced: host calls, replays
    # and collectives per SGD step, the card's idle share
    rep["traced"] = traced_step(graph_w, "graph")
    checks["traced"] = (rep["traced"]["collectives_per_sgd_step"] == n_collectives
                        and rep["traced"]["graph_replays_per_sgd_step"] == n_collectives + 1
                        and rep["traced"]["rollout_graph_replays"] == 1
                        and rep["traced"]["rollout_fused_launches"] == T)
    del graph_w, ts2, state2, data2, gens2
    torch.cuda.empty_cache()

    # (d) the kernel against its twin on this rank's rows of the trained
    # state (step variant, DR on: train()'s DR rows), on rank 0; and (f)
    # the kernel's time at this rank's rows, the ranks timed in turn
    tmpl = ppo.init_training_state(obs_sizes, params.action_size, nf,
                                   torch.Generator(device=dev).manual_seed(0), dev)
    gens_t = {k[len("generators/"):]: torch.Generator(device=dev)
              for k in trained if k.startswith("generators/")}
    _, es = ppo.restore_full_state(trained, tmpl, te2.reset(torch.Generator(device=dev)),
                                   gens_t, shard)
    dr = flatten_dr_fields(te2.model)
    n = runner.env.n_substeps
    args = (es.data.qpos.contiguous(), es.data.qvel.contiguous(),
            es.data.qacc_warmstart.contiguous(), es.data.ctrl.contiguous(), n, dr)
    for r in range(shard.world):
        if r == shard.rank:
            rep["kernel_ms"] = cuda_ms(lambda: fp(*args), reps=20)
        shard.barrier()
    if shard.is_main:
        accel = int(fp.model.sensor_adr[fp.model.sensor("accelerometer")])
        out_k = fp(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_p = fp.plain(*args)
        torch.cuda.synchronize()
        rep["plain_ms"] = (time.perf_counter() - t0) * 1e3
        readings = {}
        tag = f"sharded rank 0 {TRAINER_TASK} B={rows} of {B} dr=1 step"
        checks["kernel_vs_twin"] = parity_table(
            tag, out_k, out_p, accel, "step", True, False, readings,
            standin().TRAINER_PARITY_LIMITS[("step", True)])
        worst = max(readings[tag], key=lambda f: readings[tag][f]["max"])
        rep["max_abs_err"] = readings[tag][worst]["max"]
        rep["max_abs_err_of"] = f"{tag}: all outputs; largest in {worst}"
        bound = step_bound(fp, rows, n, dr, flops_per_env_substep(fp, dr))
        rep.update(bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
                   flops_per_env_substep=bound["flops_per_env_substep"], bytes=bound["bytes"])
    rep["checks"] = checks
    rep["ok"] = all(checks.values())
    return rep


def phase_deploy(joystick_onnx: str, standing_onnx: str, report: dict) -> dict:
    """Phase 7: sim-to-sim on the port's engine, on the card. The gate
    (deploy.sim2sim_check, engine "own": SimInfer on the fused kernel at one
    env, DR off) rolls phase 4's joystick ONNX (10 s at vx 0.12) and phase
    6's standing ONNX (10 s plain, then the 8-direction push battery); where
    `mujoco` imports, the same rollouts run on MuJoCo C beside them.

    Checks: (a) every own-engine rollout launched the kernel 1 + ticks
    times (its init, then one per tick; each engine's count starts at 0 when
    it is made), each at one row, on the card, with DR off; (b) the kernel
    against its twin at B=1, DR off, step and init variants, from three
    states of the standing rollout (home, mid-run, last), one tick from the
    same state, within duck_standin.DEPLOY_PARITY_LIMITS; (c) the obs have
    101 / 85 entries and are finite, the motor targets finite.

    The gate's bars (no fall, track_frac >= 0.7; standing up_z >= 0.9,
    drift <= 0.15 m, >= 75% of the pushes survived) are for a trained
    policy: a 2-epoch policy is expected to fail them. Their PASS/FAIL is
    printed as a reading and does not decide this phase. Prints ms per tick,
    split into the kernel (CUDA events around each launch) and the host
    (obs, the host copy, ONNX inference, the clamp)."""
    import importlib.util

    from open_duck_playground_tpu_torch.deploy import sim2sim_check as gate
    from open_duck_playground_tpu_torch.ops.cuda_step import FusedPhysics

    sd = standin()
    have_mujoco = importlib.util.find_spec("mujoco") is not None
    if not have_mujoco:
        log("[deploy] MuJoCo C not run: the mujoco package is not installed on this host")

    # every launch of every FusedPhysics while the gate runs: its rows,
    # device, DR and CUDA events (the launch and its count are the object's)
    launches = {}
    launch = FusedPhysics._launch

    def counted(fp, qpos, *args):
        rec = launches.setdefault(id(fp), {"rows": {}, "events": []})
        key = f"{qpos.shape[0]} rows on {qpos.device}" + (" with DR" if args[-1] is not None else "")
        rec["rows"][key] = rec["rows"].get(key, 0) + 1
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = launch(fp, qpos, *args)
        b.record()
        rec["events"].append((a, b))
        return out

    rollouts = []  # {task, engine, ticks: [(t, qpos, qvel, warm, targets)]}
    make = gate.make_engine

    def spied(kind, *a, **k):
        inf = make(kind, *a, **k)
        if kind == "own":
            ro = {"task": "standing" if inf.standing else "joystick", "engine": inf, "ticks": []}
            step = inf.step_control

            def recorded(targets, inf=inf, ro=ro, step=step):
                d = inf.data
                ro["ticks"].append((time.perf_counter(), d.qpos.clone(), d.qvel.clone(),
                                    d.qacc_warmstart.clone(), np.array(targets, np.float64)))
                return step(targets)

            inf.step_control = recorded
            rollouts.append(ro)
        return inf

    readings = {}
    FusedPhysics._launch = counted
    gate.make_engine = spied
    try:
        for task, onnx, extra in (("joystick", joystick_onnx, ["--vx", "0.12"]),
                                  ("standing", standing_onnx, ["--standing"])):
            argv = ["-o", onnx, "--task", TRAINER_TASK, "--seconds", "10", "--device", "cuda",
                    *extra, *([] if have_mujoco else ["--own_only"])]
            t0 = time.perf_counter()
            rc = gate.main(argv)
            readings[task] = "PASS" if rc == 0 else "FAIL"
            log(f"[deploy] {task}: gate {readings[task]} (a reading: the bars are for a trained "
                f"policy) in {time.perf_counter() - t0:.1f} s")
    finally:
        FusedPhysics._launch = launch
        gate.make_engine = make
    torch.cuda.synchronize()

    # (a) launches and (c) sizes, per rollout; ms per tick
    ok = True
    total = 0
    per_task = {}
    obs_len = {"joystick": OBS_SIZES["joystick"]["state"], "standing": OBS_SIZES["standing"]["state"]}
    for i, ro in enumerate(rollouts):
        inf, ticks = ro["engine"], ro["ticks"]
        rec = launches.get(id(inf.physics), {"rows": {}, "events": []})
        n = len(ticks)
        want = {"1 rows on cuda:0": 1 + n}
        a_ok = inf.physics.launches == 1 + n and rec["rows"] == want and len(inf.saved_obs) == n
        c_ok = (all(o.shape == (obs_len[ro["task"]],) and np.isfinite(o).all() for o in inf.saved_obs)
                and all(np.isfinite(t[4]).all() for t in ticks))
        ok &= passed(f"deploy {ro['task']} rollout {i}", launches=a_ok, finite=c_ok)
        total += inf.physics.launches
        kern = [a.elapsed_time(b) for a, b in rec["events"][1:]]  # the ticks' launches
        wall = np.diff([t[0] for t in ticks]) * 1e3
        s = per_task.setdefault(ro["task"], {"rollouts": 0, "launches": 0, "ticks": 0,
                                             "kernel_ms": [], "tick_ms": []})
        s["rollouts"] += 1
        s["launches"] += inf.physics.launches
        s["ticks"] += n
        s["kernel_ms"] += kern
        s["tick_ms"] += list(wall)
        log(f"[deploy] {ro['task']} rollout: {n} ticks, launches {inf.physics.launches} (want "
            f"{1 + n}) as {rec['rows']}; obs {len(inf.saved_obs[0]) if n else None} finite, "
            f"targets finite {c_ok}; {'OK' if a_ok and c_ok else 'FAIL'}")
    for task, s in per_task.items():
        k, w = float(np.mean(s["kernel_ms"])), float(np.mean(s["tick_ms"]))
        s.update(kernel_ms=k, tick_ms=w, host_ms=w - k)
        log(f"[deploy] {task}: {s['rollouts']} rollouts, {s['ticks']} ticks, {s['launches']} "
            f"launches; ms per tick {w:.3f}: kernel {k:.3f} (CUDA events), host {w - k:.3f} (obs, "
            f"host copy, ONNX, clamp, the gate's reads)")
    ok &= passed("deploy", tasks=set(per_task) == {"joystick", "standing"},
                 standing_rollouts=per_task.get("standing", {}).get("rollouts") == 9)

    # (b) kernel vs twin at B=1, DR off, from the standing plain rollout's
    # home, mid-run and last states; the kernel's and the twin's time from
    # the home state, and the bound
    ro = next(r for r in rollouts if r["task"] == "standing")
    fp = FusedPhysics(ro["engine"].physics.model)
    accel = int(fp.model.sensor_adr[fp.model.sensor("accelerometer")])
    ticks = ro["ticks"]
    per_env_substep = flops_per_env_substep(fp, None)
    timed = {}
    for where, i in (("home", 0), ("mid", len(ticks) // 2), ("last", len(ticks) - 1)):
        _, qpos, qvel, warm, targets = ticks[i]
        ctrl = torch.tensor(targets, dtype=torch.float32, device=qpos.device)[None]
        for variant, n, w in (("step", 10, warm), ("init", 1, torch.zeros_like(warm))):
            args = (qpos, qvel, w, ctrl, n, None)
            out_k = fp(*args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out_p = fp.plain(*args)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            tag = f"deploy {TRAINER_TASK} B=1 dr=0 {where} (tick {i}) {variant}"
            ok &= parity_table(tag, out_k, out_p, accel, variant, False, False, report,
                               sd.DEPLOY_PARITY_LIMITS[variant])
            if where == "home":
                ms = cuda_ms(lambda: fp(*args), reps=50)
                bound = step_bound(fp, 1, n, None, per_env_substep)
                timed[variant] = dict(ms=ms, plain_ms=plain_ms, **bound)
                log(f"[deploy] {variant} variant ({n} substeps) at 1 env (DR off): kernel "
                    f"{ms:.4f} ms, twin {plain_ms:.1f} ms; bound {bound['bound_ms']:.6f} ms by "
                    f"{bound['bound_by']} ({per_env_substep:.0f} flops per env and substep, "
                    f"{bound['bytes']} bytes)")
    tags = [t for t in report if t.startswith("deploy ")]
    worst = max(((t, f) for t in tags for f in report[t]), key=lambda tf: report[tf[0]][tf[1]]["max"])
    log(f"[deploy] gpu {gpu_line()}")
    log(f"[deploy] {'OK' if ok else 'FAIL'}")
    return dict(ok=ok, launches=total, per_task={k: {kk: v[kk] for kk in (
                    "rollouts", "launches", "ticks", "kernel_ms", "host_ms", "tick_ms")}
                    for k, v in per_task.items()},
                gate=readings, timed=timed, max_abs_err=report[worst[0]][worst[1]]["max"],
                max_abs_err_of=f"{', '.join(t[len('deploy '):] for t in tags)}: all outputs; "
                               f"largest in {worst[0]} {worst[1]}")


def read_trace(path: str):
    """A torch.profiler Chrome trace as (annotations, device work, host
    waits): the record_function spans {name: [(start, end)]}; per kernel,
    copy or set on the card, (category, name, start, end, ts of the runtime
    call that launched it or nan, that call's correlation id, its name); the
    ts of each runtime call that waits for the card (cuda*Synchronize); all
    in microseconds on one clock. The kernels of a CUDA graph replay share
    the correlation of its one cudaGraphLaunch."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    runtime = [e for e in events if e.get("cat", "").startswith("cuda_")]  # runtime, driver API
    launched = {e["args"]["correlation"]: (e["ts"], e["name"]) for e in runtime
                if "correlation" in e.get("args", {})}
    waits = np.array(sorted(e["ts"] for e in runtime if "Synchronize" in e["name"]))
    spans, work = {}, []
    for e in events:
        cat = e.get("cat")
        if cat == "user_annotation":
            spans.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
        elif cat in DEVICE_CATS:
            corr = e.get("args", {}).get("correlation")
            t, call = launched.get(corr, (float("nan"), ""))
            work.append((cat, e["name"], e["ts"], e["ts"] + e["dur"], t, corr, call))
    return spans, work, waits


def _busy(merged: np.ndarray, a: float, b: float) -> float:
    """Length of [a, b] covered by the sorted disjoint intervals `merged`."""
    return float(np.clip(np.minimum(merged[:, 1], b) - np.maximum(merged[:, 0], a), 0, None).sum())


def region_stats(spans, work, merged: np.ndarray, waits: np.ndarray) -> dict:
    """One annotated region (its instances `spans`): per instance, the host
    ms (span length) and the device ms, kernels run, and copies and sets by
    kind, of the work launched inside it, the host calls that launched it
    (a graph replay is one call for all its kernels) and the graph launches
    among them, and the host's waits for the card; the fused kernel's
    launches per instance and its share of that
    device time; the device's idle share while the region runs (1 - the
    union of all device intervals inside its spans / their length); its top
    10 device operations by total time, with counts."""
    spans = sorted(spans)
    starts = np.array([s for s, _ in spans])
    ends = np.array([e for _, e in spans])
    t = np.array([w[4] for w in work])
    k = np.searchsorted(starts, t, side="right") - 1
    own = [(w, int(i)) for w, i in zip(work, k) if i >= 0 and w[4] <= ends[i]]
    n = len(spans)
    kernels = [w for w, _ in own if w[0] == "kernel"]
    fused_per = [0] * n
    for w, i in own:
        fused_per[i] += w[0] == "kernel" and FUSED_KERNEL in w[1]
    dev_us = sum(w[3] - w[2] for w, _ in own)
    fused_us = sum(w[3] - w[2] for w in kernels if FUSED_KERNEL in w[1])
    host_us = float((ends - starts).sum())
    busy_us = sum(_busy(merged, a, b) for a, b in spans)
    top, kinds = {}, {}
    for w, _ in own:
        c = top.setdefault(w[1], [0.0, 0])
        c[0] += (w[3] - w[2]) / 1e3
        c[1] += 1
        if w[0] != "kernel":
            kinds[w[1]] = kinds.get(w[1], 0) + 1 / n
    k = np.searchsorted(starts, waits, side="right") - 1
    n_waits = int(sum(1 for t, i in zip(waits, k) if i >= 0 and t <= ends[i]))
    calls = {(w[5], w[6]) for w, _ in own}
    return dict(instances=n, host_ms=host_us / n / 1e3, device_ms=dev_us / n / 1e3,
                launches=len(kernels) / n, host_calls=len(calls) / n,
                graph_launches=sum("GraphLaunch" in c for _, c in calls) / n,
                copies=kinds, waits=n_waits / n,
                fused_per_instance=fused_per, fused_share=fused_us / dev_us if dev_us else 0.0,
                idle_share=1 - busy_us / host_us if host_us else float("nan"),
                top=sorted(([name, ms, c] for name, (ms, c) in top.items()),
                           key=lambda x: -x[1])[:10])


def trace_split(trace, names) -> dict:
    """region_stats of each annotated region in `names` (a name absent from
    the trace is an error), from a read_trace result; a region may also be
    given as (name, spans)."""
    spans, work, waits = trace
    iv = np.array(sorted((w[2], w[3]) for w in work), dtype=np.float64).reshape(-1, 2)
    merged = []
    for a, b in iv:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    merged = np.array(merged, dtype=np.float64).reshape(-1, 2)
    out = {}
    for item in names:
        name, sp = item if isinstance(item, tuple) else (item, spans[item])
        out[name] = region_stats(sp, work, merged, waits)
    out["_unattributed"] = sum(1 for w in work if math.isnan(w[4]))
    out["_device_events"] = len(work)
    return out


def log_split(tag: str, split: dict, top_of=()) -> None:
    """Print each region's numbers, and its top 10 device ops for the
    regions in `top_of`."""
    for name, s in split.items():
        if name.startswith("_"):
            continue
        log(f"[profile] {tag} {name}: x{s['instances']}; per instance host {s['host_ms']:.3f} ms, "
            f"device {s['device_ms']:.3f} ms, {s['launches']:.1f} kernels run, copies and "
            f"sets {json.dumps(s['copies'])}, launched by {s['host_calls']:.1f} host calls "
            f"({s['graph_launches']:.1f} graph launches), {s['waits']:.1f} host waits for the "
            f"card; fused kernel "
            f"{sum(s['fused_per_instance'])} launches, {100 * s['fused_share']:.1f}% of the device "
            f"time; device idle {100 * s['idle_share']:.1f}% of the region's wall time")
        if name in top_of:
            for op, ms, c in s["top"]:
                log(f"[profile] {tag} {name} top: {ms:9.3f} ms x{c:<5d} {op[:100]}")


def _annotated(stack, obj, attr: str, label: str) -> None:
    """Wrap obj.attr (of a module, a class or an instance) in
    profiling.annotate(label) until `stack` closes."""
    from open_duck_playground_tpu_torch.utils import profiling

    fn = getattr(obj, attr)

    def wrapped(*a, **k):
        with profiling.annotate(label):
            return fn(*a, **k)

    if attr in vars(obj):
        stack.callback(setattr, obj, attr, fn)
    else:  # a method looked up through the class: drop the instance's wrapper
        stack.callback(delattr, obj, attr)
    setattr(obj, attr, wrapped)


def profile_env_step(out_dir: str) -> dict:
    """Phase 9 (a): the flat main path's env (FLAT_MAIN, DR on), PROFILE_WARMUP
    steps, then PROFILE_STEPS eager steps traced, each in
    annotate("env_step"), the window in annotate("env_window") ending in a
    synchronize; inside a step, the env's step_with_model is annotated
    env_logic and its physics_step physics (so env_step - env_logic is the
    wrapper and its autoreset, env_logic - physics the task's own logic).
    Before them, in the same trace, PROFILE_STEPS replays of a
    EnvStepProgram (captured before the trace), each in
    annotate("graph_step"), in annotate("graph_window"). The same number of steps of each timed
    untraced just before, for the profiler's cost. Checks one fused launch,
    no host wait and no pageable copy in each eager step; one graph launch
    and one fused kernel per replay, and the kernel's launch count over the
    replays equal to the fused kernels the profiler saw in them."""
    from open_duck_playground_tpu_torch.envs import randomize
    from open_duck_playground_tpu_torch.envs.joystick import Joystick
    from open_duck_playground_tpu_torch.envs.wrapper import EnvStepProgram, TrainEnv
    from open_duck_playground_tpu_torch.utils import profiling

    task, B = FLAT_MAIN
    dev = torch.device("cuda")
    env = Joystick(task, device=dev, seed=0)
    te = TrainEnv(env, num_envs=B, episode_length=1000,
                  randomization_fn=randomize.domain_randomize,
                  randomization_generator=torch.Generator(device=dev).manual_seed(0))
    g = torch.Generator(device=dev).manual_seed(2)
    n = PROFILE_WARMUP + 4 * PROFILE_STEPS
    actions = torch.rand((n, B, env.action_size), generator=g, device=dev) * 2 - 1
    state = te.reset(torch.Generator(device=dev).manual_seed(1))
    for i in range(PROFILE_WARMUP):
        state = te.step(state, actions[i])
    cap = EnvStepProgram(te)
    cap.capture(state, actions[0])
    windows = {}
    for name, step, at in (("eager", te.step, PROFILE_WARMUP),
                           ("graph", cap, PROFILE_WARMUP + PROFILE_STEPS)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(at, at + PROFILE_STEPS):
            state = step(state, actions[i])
        torch.cuda.synchronize()
        windows[name] = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS

    launches = {}
    with contextlib.ExitStack() as stack:
        _annotated(stack, env, "step_with_model", "env_logic")
        _annotated(stack, env, "physics_step", "physics")
        stack.enter_context(profiling.trace(out_dir, device=dev))
        at = PROFILE_WARMUP + 2 * PROFILE_STEPS
        for name, step in (("graph", cap), ("env", te.step)):  # replays from the buffers
            env.physics.launches = 0
            with profiling.annotate(f"{name}_window"):
                for i in range(at, at + PROFILE_STEPS):
                    with profiling.annotate(f"{name}_step"):
                        state = step(state, actions[i])
                torch.cuda.synchronize()
            launches[name] = env.physics.launches
            at += PROFILE_STEPS
    split = trace_split(read_trace(os.path.join(out_dir, "trace.json")),
                        ("env_window", "env_step", "env_logic", "physics", "graph_window",
                         "graph_step"))
    finite = all(bool(torch.isfinite(v).all()) for v in state.obs.values())
    log(f"[profile] env step {task} B={B} DR on: {windows['eager']:.3f} ms per eager step "
        f"untraced, {split['env_step']['host_ms']:.3f} ms traced (host); {windows['graph']:.3f} ms "
        f"per captured step untraced, {split['graph_step']['host_ms']:.3f} ms traced; "
        f"{split['_device_events']} device events in the trace, {split['_unattributed']} without "
        f"their launch; kernel launches counted {launches}")
    log_split("env", split, top_of=("env_window", "graph_window"))
    fused = split["env_step"]["fused_per_instance"]
    fused_graph = split["graph_step"]["fused_per_instance"]
    waits = split["env_step"]["waits"]
    pageable = sum(n for kind, n in split["env_step"]["copies"].items() if "Pageable" in kind)
    ok = passed("profile env step", finite=finite, launches=launches["env"] == PROFILE_STEPS,
                one_fused_launch_per_step=fused == [1] * PROFILE_STEPS,
                steps=split["env_step"]["instances"] == PROFILE_STEPS, no_host_wait=waits == 0,
                no_pageable_copy=pageable == 0,
                one_fused_kernel_per_replay=fused_graph == [1] * PROFILE_STEPS,
                one_graph_launch_per_replay=split["graph_step"]["graph_launches"] == 1,
                replay_count_equals_profiler=launches["graph"] == sum(fused_graph))
    summary = {k: {f: split[f"{k}_step"][f] for f in ("host_ms", "device_ms", "host_calls",
                                                      "graph_launches", "launches")}
               for k in ("env", "graph")}
    for k in ("env", "graph"):
        summary[k]["idle_share"] = split[f"{k}_window"]["idle_share"]
        summary[k]["untraced_ms"] = windows["eager" if k == "env" else "graph"]
    log(f"[profile] env step, eager against captured: {json.dumps(summary)}; fused kernel "
        f"launches per eager step {fused}, per replay {fused_graph} (counted {launches['graph']}); "
        f"host waits per eager step {waits} and pageable copies per step {pageable} (want 0 and "
        f"0); {'OK' if ok else 'FAIL'}")
    return dict(ok=ok, untraced_ms=windows, split=split, summary=summary,
                fused_launches=sum(fused) + sum(fused_graph))


def profile_training_step(out_dir: str) -> dict:
    """Phase 9 (b): one training_step at phase 4's configuration (the
    runner's recipe: flat_terrain_backlash, 8192 DR envs, unroll 20, 256 x 32
    minibatches, 4 updates, (512, 256, 128) networks) with the rollout and
    the SGD step the trainer runs on the card, a RolloutProgram and an
    SGDStepProgram, after a warm-up step (which captures both) and one
    timed untraced. Each call of the two is wrapped from outside in an
    annotation (rollout, sgd_step): their bodies run in Python only at the
    capture, so each reads as its host calls (the input copies, the
    generators' seeds, one graph launch, the loss terms' copies) and the
    device work they launch."""
    from open_duck_playground_tpu_torch.envs.wrapper import TrainEnv
    from open_duck_playground_tpu_torch.train import ppo
    from open_duck_playground_tpu_torch.train import runner as rn
    from open_duck_playground_tpu_torch.utils import profiling

    cli = rn.build_parser().parse_args(
        ["--output_dir", os.path.join(ROOT, "build", "profile_run"), *TRAINER_ARGS])
    runner = rn.OpenDuckMiniV2Runner(cli)
    kw = runner.train_kwargs()
    dev = runner.device
    hp = _trainer_hyper(kw)
    gens = ppo.seeded_generators(kw["seed"], dev)
    env = runner.env
    te = TrainEnv(env, num_envs=hp.num_envs, episode_length=kw["episode_length"],
                  randomization_fn=kw["randomization_fn"],
                  randomization_generator=gens["randomization"])
    obs_sizes = {k: v[0] for k, v in env.observation_size.items()}
    ts = ppo.init_training_state(obs_sizes, env.action_size, kw["network_factory"], gens["net"], dev)
    cap = ppo.SGDStepProgram(ts, hp)
    roll = ppo.RolloutProgram(te, ts.normalizer, ts.params, hp)
    state = te.reset(gens["reset"])
    mb_steps = hp.num_updates_per_batch * hp.num_minibatches

    for _ in range(2):  # a warm-up step (the captures), then one timed untraced
        t0 = time.perf_counter()
        draws = ppo.draw_training_step(gens["epoch"], hp, env.action_size, dev)
        ts, state, _ = ppo.training_step(ts, te, state, draws, hp, sgd=cap, roll=roll)
        torch.cuda.synchronize()
        untraced_s = time.perf_counter() - t0

    def annotated(label, fn):
        def call(*a, **k):
            with profiling.annotate(label):
                return fn(*a, **k)
        return call

    draws = ppo.draw_training_step(gens["epoch"], hp, env.action_size, dev)
    torch.cuda.synchronize()
    env.physics.launches = 0
    with profiling.trace(out_dir, device=dev):
        with profiling.annotate("training_step"):
            ts, state, losses = ppo.training_step(ts, te, state, draws, hp,
                                                  sgd=annotated("sgd_step", cap),
                                                  roll=annotated("rollout", roll))
            torch.cuda.synchronize()
    launches = env.physics.launches
    regions = ("training_step", "rollout", "sgd_step")
    split = trace_split(read_trace(os.path.join(out_dir, "trace.json")), regions)
    finite = all(math.isfinite(float(v)) for v in losses.values())
    sgd_split, roll_split = split["sgd_step"], split["rollout"]
    per_mb = sgd_split["host_calls"] / mb_steps
    log(f"[profile] training step flat_terrain_backlash B={hp.num_envs} DR on, one captured "
        f"rollout of {hp.unroll_length} env steps and {mb_steps} minibatch steps in one "
        f"captured SGD step: {untraced_s:.3f} s untraced, "
        f"{split['training_step']['host_ms'] / 1e3:.3f} s traced; {split['_device_events']} device "
        f"events, {split['_unattributed']} without their launch; kernel launches counted {launches}")
    log_split("sgd", split, top_of=("training_step", "rollout", "sgd_step"))
    fused_rollout = roll_split["fused_per_instance"]
    ok = passed("profile training step", finite=finite, launches=launches == hp.unroll_length,
                fused_in_rollout=fused_rollout == [hp.unroll_length],
                one_rollout_graph_launch=roll_split["graph_launches"] == 1,
                no_fused_in_sgd=sum(sgd_split["fused_per_instance"]) == 0,
                one_sgd_step=sgd_split["instances"] == 1,
                one_graph_launch=sgd_split["graph_launches"] == 1,
                host_launches_per_minibatch_step=per_mb <= 4)
    log(f"[profile] training step: rollout {roll_split['graph_launches']:.0f} graph replay, "
        f"{roll_split['host_calls']:.0f} host calls ({roll_split['host_calls'] / hp.unroll_length:.2f} "
        f"per env step), fused kernel launches {sum(fused_rollout)} (counted {launches}), device "
        f"idle {100 * roll_split['idle_share']:.1f}%; SGD step: {sgd_split['graph_launches']:.0f} "
        f"graph replay, {per_mb:.3f} host launches per minibatch step (limit 4), fused kernel "
        f"{sum(sgd_split['fused_per_instance'])}, device idle {100 * sgd_split['idle_share']:.1f}%; "
        f"{'OK' if ok else 'FAIL'}")
    return dict(ok=ok, untraced_s=untraced_s, split=split, fused_launches=sum(fused_rollout))


class ScriptedTeleop:
    """A teleop that sets commands[0] = vx at tick `at`, replacing the
    host's commands list as deploy/teleop.StdinTeleop does."""

    def __init__(self, at: int, vx: float):
        self.at, self.vx, self.polls = at, vx, 0

    def poll(self, host) -> None:
        if self.polls == self.at:
            c = list(host.commands)
            c[0] = self.vx
            host.commands = c
        self.polls += 1


class RecordingVideo:
    """A video with MjVideoRenderer's add_qpos_frame that keeps a copy of
    each frame's qpos (no MuJoCo)."""

    def __init__(self):
        self.frames = []

    def add_qpos_frame(self, qpos) -> None:
        self.frames.append(np.array(qpos, copy=True))


def deploy_hooks(onnx: str) -> dict:
    """Phase 9 (c): SimInfer on the card rolls `onnx` for DEPLOY_HOOK_S with a
    scripted teleop (commands[0] = 0.1 at tick 10) and a recording video.
    Checks launches 1 + ticks (counted from the engine's making), one frame
    every second tick, bit-identical to the qpos that tick left on the card,
    and the obs's command 0 before tick 10 and 0.1 from it on."""
    from open_duck_playground_tpu_torch.deploy.sim_infer import SimInfer
    from open_duck_playground_tpu_torch.models.open_duck_mini_v2 import constants

    inf = SimInfer(constants.task_to_xml(TRAINER_TASK), constants.reference_motion_path(), onnx,
                   device="cuda")
    after = []
    step = inf.step_control

    def recorded(targets):
        step(targets)
        after.append(inf.data.qpos.clone())

    inf.step_control = recorded
    tele, video = ScriptedTeleop(at=10, vx=0.1), RecordingVideo()
    t0 = time.perf_counter()
    inf.run(seconds=DEPLOY_HOOK_S, save_path=None, teleop=tele, video=video)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ticks = len(inf.saved_obs)
    frames_ok = (len(video.frames) == math.ceil(ticks / 2) and all(
        f.dtype == np.float32 and np.array_equal(f, after[2 * k][0].cpu().numpy())
        for k, f in enumerate(video.frames)))
    cmd = [float(o[6]) for o in inf.saved_obs]
    cmd_ok = ticks > 10 and cmd == [0.0] * 10 + [0.1] * (ticks - 10)
    ok = passed("profile deploy hooks", launches=inf.physics.launches == 1 + ticks,
                polls=tele.polls == ticks, frames=frames_ok, command=cmd_ok)
    log(f"[profile] deploy hooks: {ticks} ticks in {wall:.3f} s, launches {inf.physics.launches} "
        f"(want {1 + ticks}); {len(video.frames)} frames, bit-identical to the ticks' qpos "
        f"{frames_ok}; obs command from tick 10 {cmd_ok}; {'OK' if ok else 'FAIL'}")
    return dict(ok=ok, ticks=ticks, launches=inf.physics.launches, frames=len(video.frames))


def gait_playback() -> dict:
    """Phase 9 (d): ref_motion_viewer.playback on the card against the CPU,
    2 periods, no plot: the feet within PLAYBACK_ATOL_M."""
    from open_duck_playground_tpu_torch.deploy import ref_motion_viewer

    feet = {d: ref_motion_viewer.playback(periods=2, out=None, device=d) for d in ("cuda", "cpu")}
    err = float(np.abs(feet["cuda"] - feet["cpu"]).max())
    ok = passed("profile gait playback", shape=feet["cuda"].shape == feet["cpu"].shape,
                finite=bool(np.isfinite(feet["cuda"]).all()), feet=err <= PLAYBACK_ATOL_M)
    log(f"[profile] gait playback: {feet['cuda'].shape[0]} ticks; feet max |cuda - cpu| {err:.3g} m "
        f"(limit {PLAYBACK_ATOL_M}); {'OK' if ok else 'FAIL'}")
    return dict(ok=ok, max_abs_err=err)


def phase_profile(onnx: str) -> dict:
    """Phase 9: the traced split of the env step (a) and of a training step
    (b), the deploy loop's teleop and video hooks on the card (c), and the
    gait playback on the card against the CPU (d). Traces go under
    build/profile/, with every printed number in build/profile/split.json."""
    out = os.path.join(ROOT, "build", "profile")
    shutil.rmtree(out, ignore_errors=True)
    env = profile_env_step(os.path.join(out, "env_step"))
    train = profile_training_step(os.path.join(out, "training_step"))
    hooks = deploy_hooks(onnx)
    gait = gait_playback()
    with open(os.path.join(out, "split.json"), "w") as f:
        json.dump({"gpu": gpu_line(), "env_step": env, "training_step": train, "deploy": hooks,
                   "gait": gait}, f)
    log(f"[profile] gpu {gpu_line()}")
    ok = env["ok"] and train["ok"] and hooks["ok"] and gait["ok"]
    log(f"[profile] {'OK' if ok else 'FAIL'}")
    return dict(ok=ok, launches_profiled=env["fused_launches"] + train["fused_launches"])


def kernel_entry(name: str, replaces: str, main: dict, report: dict, case: str) -> dict:
    """One entry of the kernels line: launches (the main path's captured
    run; launches_eager: its eager run; the fused launches one replay of
    the captured env step records), times and bound from the main path;
    max_abs_err from phase 3's control step at the main path's
    shape, on its own last state, over all outputs (contact_dist over slots valid on both
    sides: a slot valid on one side only reads 1e10 on the other)."""
    rs = report[case]
    worst = max(rs, key=lambda f: rs[f]["max"])
    return {
        "name": name,
        "route": "cuda",
        "source": "open_duck_playground_tpu_torch/ops/csrc/physics_step.cu",
        "replaces": replaces,
        "launches": main["launches"],
        "launches_eager": main["launches_eager"],
        "launches_per_replay_env_step": main["launches_per_replay"],
        "max_abs_err": rs[worst]["max"],
        "max_abs_err_of": f"{case}: step variant on the main path's last state, all outputs; "
                          f"largest in {worst}",
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,  # no PyTorch call computes a physics step
    }


def sharded_entry(run: dict, eager: dict) -> dict:
    """The kernels line's entry of the sharded dispatch (kernel d): the same
    kernel launched by every rank on its rows, from phase 5's gloo run on
    the one card, as train() runs it (the graphs). launches: both envs'
    launches summed over the ranks (launches_eager: the same of the eager
    run); the fused launches in one replay of each rank's rollout and eval
    step graph; ms, plain_ms and bound at rank 0's rows (row a's bound at
    8192/world); ms_in_rollout_graph: one launch's device time inside rank
    0's traced rollout replay, beside the other rank's work on the card."""
    r0 = run["reps"][0]
    return {
        "name": "fused_physics_step_sharded",
        "route": "cuda",
        "source": "open_duck_playground_tpu_torch/ops/csrc/physics_step.cu",
        "replaces": "open_duck_playground_tpu/ops/pallas_step.py:238 (call_sharded)",
        "launches": sum(sum(rep["launches"].values()) for rep in run["reps"]),
        "launches_per_rank": [rep["launches"] for rep in run["reps"]],
        "launches_eager": sum(sum(rep["launches"].values()) for rep in eager["reps"]),
        "launches_per_replay_rollout": r0["launches_per_replay"]["rollout"],
        "launches_per_replay_eval_step": r0["launches_per_replay"]["eval_step"],
        "rows_per_rank": r0["rows"],
        "world": run["world"],
        "backend": run["backend"],
        "max_abs_err": r0["max_abs_err"],
        "max_abs_err_of": r0["max_abs_err_of"],
        "ms": r0["kernel_ms"],
        "ms_per_rank": [rep["kernel_ms"] for rep in run["reps"]],
        "ms_in_rollout_graph": r0["traced"]["fused_ms_per_launch_in_rollout"],
        "plain_ms": r0["plain_ms"],
        "bound_ms": r0["bound_ms"],
        "bound_by": r0["bound_by"],
        "library_ms": None,  # no PyTorch call computes a physics step
    }


def optimizer_entry(opt: dict, trainer: dict, standing: dict) -> dict:
    """The kernels line's entry of the optimizer's kernel: launches on the
    trainer's path (phase 4; launches_standing: phase 6) and per SGD
    replay; max_abs_err against the plain functions and the times from
    phase 4a (ms: one launch; ms_step: one fused clip + Adam step, norm and
    bias corrections included; plain_ms: the plain functions' step;
    library_ms: torch.optim.Adam's fused step, no clip)."""
    return {
        "name": "duck_adam",
        "route": "cuda",
        "source": "open_duck_playground_tpu_torch/ops/csrc/adam.cu",
        "replaces": "none: the counterpart of XLA's fusion of optax's clip_by_global_norm + adam "
                    "in open_duck_playground_tpu/train/ppo.py:263 (sgd_step)",
        "launches": trainer["optimizer_launches"],
        "launches_standing": standing["optimizer_launches"],
        "launches_per_replay_sgd_step": trainer["sgd_per_replay"]["duck_adam"],
        "max_abs_err": opt["max_abs_err"],
        "max_abs_err_of": f"phase 4a: params, count, mu, nu after {len(ADAM_NORMS)} steps; "
                          f"{'; '.join(c['case'] for c in opt['cases'])}",
        "ms": opt["ms"],
        "ms_step": opt["ms_step"],
        "plain_ms": opt["plain_ms"],
        "bound_ms": opt["bound_ms"],
        "bound_by": "bytes",
        "library_ms": opt["library_ms"],
        "library_of": "torch.optim.Adam(fused=True, capturable=True).step(), no clip",
    }


def gae_entry(gae: dict, trainer: dict, standing: dict) -> dict:
    """The kernels line's entry of the GAE kernel: launches on the trainer's
    path (phase 4; launches_standing: phase 6) and per SGD replay;
    max_abs_err against compute_gae and the times from phase 4a (ms: one
    launch at the recipe's T=20, b=256; plain_ms: the plain path's call)."""
    return {
        "name": "duck_gae",
        "route": "cuda",
        "source": "open_duck_playground_tpu_torch/ops/csrc/gae.cu",
        "replaces": "none: the counterpart of XLA's fusion of the reverse lax.scan of "
                    "open_duck_playground_tpu/train/ppo.py compute_gae in its jitted sgd_step",
        "launches": trainer["gae_launches"],
        "launches_standing": standing["gae_launches"],
        "launches_per_replay_sgd_step": trainer["sgd_per_replay"]["duck_gae"],
        "max_abs_err": gae["max_abs_err"],
        "max_abs_err_of": f"phase 4a: vs and advantages, eager and replayed; "
                          f"{'; '.join(c['case'] for c in gae['cases'])}",
        "ms": gae["ms"],
        "plain_ms": gae["plain_ms"],
        "bound_ms": gae["bound_ms"],
        "bound_by": gae["bound_by"],
        "library_ms": None,  # no PyTorch call computes GAE
    }


def swish_entry(swish: dict, trainer: dict, standing: dict) -> dict:
    """The kernels line's entry of the swish's two kernels: launches per
    replay of each captured program (phase 4; phase 6 for the standing
    trainer); max_abs_err against torch and autograd, the times and the
    ptxas report from phase 4a (ms_*: one launch at SWISH_SHAPE; plain_ms_*:
    the torch kernels each replaces; library_ms_*: torch's silu and
    silu_backward, which round otherwise)."""
    return {
        "name": "duck_swish",
        "route": "cuda",
        "source": "open_duck_playground_tpu_torch/ops/csrc/swish.cu",
        "replaces": "none: the counterpart of XLA's fusion of the MLPs' swish and its gradient "
                    "in open_duck_playground_tpu/train/ppo.py's jitted sgd_step",
        "launches_per_replay": trainer["swish_per_replay"],
        "launches_per_replay_standing": standing["swish_per_replay"],
        "max_abs_err": swish["max_abs_err"],
        "max_abs_err_of": f"phase 4a: output and gradient at {list(SWISH_SHAPE)}, special values",
        **{k: swish[k] for k in ("ms_forward", "ms_backward", "plain_ms_forward",
                                 "plain_ms_backward", "library_ms_forward",
                                 "library_ms_backward", "ptxas")},
        "bound_ms": swish["bound_ms"],
        "bound_by": "bytes",
        "library_of": "torch.nn.functional.silu and aten.silu_backward (x / (1 + exp(-x)): "
                      "another rounding)",
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--rank-worker"]:
        return rank_worker(*sys.argv[2:5])
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"[env] gpu {gpu_line()}; {torch.cuda.device_count()} card(s)")
    log(f"[env] host cpu {cpu_line()}")
    log(f"[env] assets {asset_root()}")

    seconds = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        seconds[name] = round(time.perf_counter() - t0, 1)
        log(f"[chip_smoke] phase {name}: {seconds[name]} s")
        return out

    timed("1 build", phase_build)
    report = {}  # {case: {field: parity reading}}
    ok = timed("2 kernel vs twin", phase_kernel_vs_twin, CASES, report, SIDE_SUBSTEPS)
    flat = timed("3 flat main path", phase_main_path, *FLAT_MAIN, report)
    rough = timed("3b rough main path", phase_main_path, *ROUGH_MAIN, report)
    optimizer = timed("4a optimizer kernel", phase_optimizer)
    gae = timed("4a GAE kernel", phase_gae)
    swish = timed("4a swish kernels", phase_swish)
    trainer = timed("4 trainer", phase_trainer, report)
    torch.cuda.empty_cache()  # phase 5's ranks share the card with this process
    sharded = timed("5 sharded trainer", phase_sharded)
    standing = timed("6 standing trainer", phase_trainer, report, STANDING_ARGS, "standing")
    deploy = timed("7 deploy", phase_deploy, trainer["onnx"], standing["onnx"], report)
    pipeline = timed("8 pipeline", phase_pipeline, report)
    profiled = timed("9 profile and deploy tools", phase_profile, trainer["onnx"])
    log(f"[chip_smoke] seconds per phase {json.dumps(seconds)}")
    if not (ok and flat["ok"] and rough["ok"] and optimizer["ok"] and gae["ok"] and swish["ok"]
            and trainer["ok"]
            and all(run["ok"] for run in sharded) and standing["ok"] and deploy["ok"]
            and pipeline["ok"] and profiled["ok"]):
        phases = {"2 kernel vs twin": ok, "3 flat main path": flat["ok"],
                  "3b rough main path": rough["ok"], "4a optimizer kernel": optimizer["ok"],
                  "4a GAE kernel": gae["ok"], "4a swish kernels": swish["ok"],
                  "4 trainer": trainer["ok"],
                  "5 sharded trainer": all(run["ok"] for run in sharded),
                  "6 standing trainer": standing["ok"], "7 deploy": deploy["ok"],
                  "8 pipeline": pipeline["ok"], "9 profile and deploy tools": profiled["ok"]}
        summary = (f"[chip_smoke] FAILED phases {[k for k, v in phases.items() if not v]}; "
                   f"failed checks {json.dumps(FAILED)}; gpu {gpu_line()}")
        log(summary)
        print(summary, file=sys.stderr, flush=True)
        return 1
    step_kernel = kernel_entry("fused_physics_step", "open_duck_playground_tpu/ops/pallas_step.py:225",
                               flat, report, f"{FLAT_MAIN[0]} B={FLAT_MAIN[1]} dr=1 step")
    # the same kernel on the trainer's path (phase 4), step and init variants:
    # its launches there, and its largest |kernel - twin| on that path's inputs
    step_kernel["launches_trainer"] = trainer["launches"]
    tags = [t for t in report if t.startswith("trainer ")]
    worst = max(((t, f) for t in tags for f in report[t]), key=lambda tf: report[tf[0]][tf[1]]["max"])
    step_kernel["max_abs_err_trainer"] = report[worst[0]][worst[1]]["max"]
    step_kernel["max_abs_err_trainer_of"] = (f"{', '.join(t[len('trainer '):] for t in tags)}: "
                                             f"all outputs; largest in {worst[0]} {worst[1]}")
    # on the standing trainer's path (phase 6) and the deploy loop (phase 7):
    # launches, and the deploy loop's one-env times, bound and parity
    step_kernel["launches_standing"] = standing["launches"]
    step_kernel["launches_deploy"] = deploy["launches"]
    step_kernel["launches_deploy_per_task"] = {k: v["launches"] for k, v in deploy["per_task"].items()}
    step_kernel["max_abs_err_deploy_b1"] = deploy["max_abs_err"]
    step_kernel["max_abs_err_deploy_b1_of"] = deploy["max_abs_err_of"]
    for variant, t in deploy["timed"].items():
        for k in ("ms", "plain_ms", "bound_ms", "bound_by"):
            step_kernel[f"{k}_deploy_b1_{variant}"] = t[k]
    # phase 9: its launches in the traced windows, one per annotated env step
    step_kernel["launches_profiled"] = profiled["launches_profiled"]
    step_kernel["launches_profiled_of"] = (f"phase 9 traces: {PROFILE_STEPS} eager env steps and "
                                           f"{PROFILE_STEPS} replays at {FLAT_MAIN[0]} "
                                           f"{FLAT_MAIN[1]} and one training step's captured "
                                           f"rollout")
    # phase 4: the fused kernel's launches in each replay of the trainer's
    # captured rollout and eval step
    step_kernel["launches_per_replay_rollout"] = (
        trainer["rollout_graph"]["capture"]["launches_per_replay"]["fused_physics_step"])
    step_kernel["launches_per_replay_eval_step"] = (
        trainer["eval_graph"]["capture"]["launches_per_replay"]["fused_physics_step"])
    log(json.dumps({"kernels": [
        step_kernel,
        kernel_entry("fused_physics_step_hfield",
                     "open_duck_playground_tpu/ops/pallas_step.py:225 (has_hf=True)",
                     rough, report, f"{ROUGH_MAIN[0]} B={ROUGH_MAIN[1]} dr=1 step"),
        sharded_entry(sharded[0], sharded[1]),
        optimizer_entry(optimizer, trainer, standing),
        gae_entry(gae, trainer, standing),
        swish_entry(swish, trainer, standing),
    ]}))
    log(gpu_line())
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
