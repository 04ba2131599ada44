"""A/B of the fused physics kernel against an earlier version of it, on one GPU.

    git archive <commit> open_duck_playground_tpu_torch | tar -x -C build/parent
    python3 scripts/kernel_ab.py --parent build/parent

`--parent` is a directory holding the earlier `open_duck_playground_tpu_torch`
package (its `ops/cuda_step.py` and `ops/csrc/physics_step.cu` are used; the
rest of the port is this checkout's). For each shape of SHAPES (flat_terrain
at 4096 envs and rough_terrain_backlash at 8192, DR on; flat_terrain_backlash
at 8192 with DR on and at 1024 with DR off, as the benchmark's training and
eval cells run it) both kernels run on the same inputs (the stand-in's
settled states, randomized model fields from a seed): their outputs are
compared bit for bit, then each is timed with CUDA events in turns (parent,
new, new, parent) for the step variant (10 substeps) and the init variant (1
substep). Prints the card's name and power limit, ptxas' report of both
builds and both kernels' launch geometry; with `--stages`, each stage's
share of the new kernel's clock cycles (`--stages-parent`: the parent's
too). Exits non-zero if CUDA is unavailable or the outputs differ.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the repo root's smoke script: its helpers)

# (task, envs, domain randomization)
SHAPES = (("flat_terrain", 4096, True), ("rough_terrain_backlash", 8192, True),
          ("flat_terrain_backlash", 8192, True), ("flat_terrain_backlash", 1024, False))


def load_parent(parent_dir: str):
    path = os.path.join(parent_dir, "open_duck_playground_tpu_torch", "ops", "cuda_step.py")
    spec = importlib.util.spec_from_file_location("parent_cuda_step", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ptxas(so: str):
    with open(so + ".log") as f:
        return [ln.strip() for ln in f if "registers" in ln or "stack" in ln or "spill" in ln]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--stages", action="store_true",
                    help="also print each kernel stage's share of the clock cycles")
    ap.add_argument("--stages-parent", action="store_true",
                    help="with --stages, the parent's shares too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available", file=sys.stderr)
        return 2
    from open_duck_playground_tpu_torch.envs import randomize
    from open_duck_playground_tpu_torch.mjcf import compile_mjcf
    from open_duck_playground_tpu_torch.models.open_duck_mini_v2 import constants
    from open_duck_playground_tpu_torch.ops import cuda_step

    parent = load_parent(args.parent)
    print(f"[ab] gpu {chip_smoke.gpu_line()}", flush=True)
    chip_smoke.asset_root()
    for name, mod in (("parent", parent), ("new", cuda_step)):
        for line in ptxas(mod.build_library()):
            print(f"[ab] {name} ptxas: {line}", flush=True)
    dev = torch.device("cuda")
    sd = chip_smoke.standin()
    ok, results = True, []
    for task, B, with_dr in SHAPES:
        m = compile_mjcf(constants.task_to_xml(task), timestep=0.002)
        fps = {"parent": parent.FusedPhysics(m), "new": cuda_step.FusedPhysics(m)}
        qpos, qvel, ctrl = (torch.from_numpy(x).to(dev) for x in sd.settled_states(
            m.keyframe("home"), m.nq, m.nv, m.nu, B, seed=B + 1))
        warm = torch.zeros_like(qvel)
        dr = None
        if with_dr:
            dr = cuda_step.flatten_dr_fields(randomize.domain_randomize(
                m.to(dev), B, torch.Generator(device=dev).manual_seed(7)))
        for k, fp in fps.items():
            print(f"[ab] {k} {task} B={B} dr={int(with_dr)} nv={m.nv}: "
                  f"{fp.packed()['layout']['env_bytes']} shared bytes per env, "
                  f"geometry {fp.geometry(B, dev)}", flush=True)
        for n in (10, 1):
            outs = {k: fp(qpos, qvel, warm, ctrl, n, dr) for k, fp in fps.items()}
            torch.cuda.synchronize()
            same = {f: bool(torch.equal(outs["parent"][f], outs["new"][f])
                            or torch.equal(outs["parent"][f].nan_to_num(7.0),
                                           outs["new"][f].nan_to_num(7.0)))
                    for f in outs["new"]}
            ok &= all(same.values())
            ms = {"parent": [], "new": []}
            for k in ("parent", "new", "new", "parent"):
                fp = fps[k]
                ms[k].append(chip_smoke.cuda_ms(lambda: fp(qpos, qvel, warm, ctrl, n, dr),
                                                reps=args.reps))
            row = dict(task=task, B=B, dr=with_dr, n_substeps=n, parent_ms=ms["parent"], new_ms=ms["new"],
                       speedup=sum(ms["parent"]) / sum(ms["new"]),
                       bit_equal=all(same.values()),
                       differs=[f for f, v in same.items() if not v])
            results.append(row)
            print(f"[ab] {json.dumps(row)}", flush=True)
        # each stage's share of the warps' clock cycles, from the build that
        # counts them (-DDUCK_PROFILE), step variant
        profiled = (("new", cuda_step),) if args.stages else ()
        profiled += (("parent", parent),) if args.stages and args.stages_parent else ()
        for k, mod in profiled:
            fp = mod.FusedPhysics(m, profile=True)
            fp(qpos, qvel, warm, ctrl, 10, dr)
            torch.cuda.synchronize()
            fp.stage_cycles()
            ms = chip_smoke.cuda_ms(lambda: fp(qpos, qvel, warm, ctrl, 10, dr), reps=1)
            cyc = fp.stage_cycles()
            total = sum(cyc.values())
            share = {s: round(v / total, 4) for s, v in cyc.items()}
            print(f"[ab] stages {k} {task} B={B} dr={int(with_dr)}: "
                  f"{json.dumps(dict(profiled_ms=ms, share=share))}", flush=True)
    print(f"[ab] gpu {chip_smoke.gpu_line()}")
    print(json.dumps({"ab": results, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
