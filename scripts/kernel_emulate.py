"""The fused kernel's device code on the CPU, against an earlier version of it.

    git archive <commit> open_duck_playground_tpu_torch | tar -x -C build/parent
    python3 scripts/kernel_emulate.py --parent build/parent

Builds `ops/csrc/physics_step.cu` of this checkout and of the parent with g++
under a warp emulator (`scripts/kernel_emulator/`: one thread per lane), runs
both on the stand-in's settled and tilted states, DR on and off, step and
init variants (the tilted flat case with a NaN action on its last env), and
compares every output bit for bit, a NaN matching a NaN. The parent is a
warp-per-env kernel with this package's wrapper API (`FusedPhysics.packed`).
No GPU is needed; g++ with C++20 is. A difference that the card would also
show is found here at a few envs, before any card time. Exits non-zero on
any difference.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the repo root's smoke script: its helpers)
from kernel_ab import load_parent  # noqa: E402

EMU = os.path.join(ROOT, "scripts", "kernel_emulator")
OUTS = ("qpos", "qvel", "qacc_warmstart", "sensordata", "actuator_force", "contact_dist",
        "site_xpos", "site_xmat")


def build(src: str, single: bool = False, entry: str = "emulate.cpp",
          out_dir: str = os.path.join(ROOT, "build", "emulator")) -> ctypes.CDLL:
    """g++ build of `entry` (a file of the emulator) over the kernel source
    `src`, cached in `out_dir` by their contents; `single`: a source older
    than the kernel's per-ceiling instantiations (one kernel)."""
    with open(src, "rb") as f, open(os.path.join(EMU, entry), "rb") as g:
        key = hashlib.sha256(f.read() + g.read() + bytes([single])).hexdigest()[:16]
    out = os.path.join(out_dir, f"libduck_emu_{entry.split('.')[0]}_{key}.so")
    if not os.path.exists(out):
        os.makedirs(out_dir, exist_ok=True)
        subprocess.run(["g++", "-std=c++20", "-O2", "-ffp-contract=off", "-fPIC", "-shared",
                        "-pthread", "-w", f"-I{EMU}", f'-DKERNEL_SRC="{src}"',
                        *(["-DDUCK_SINGLE_KERNEL"] if single else []),
                        os.path.join(EMU, entry), "-o", out], check=True)
    return ctypes.CDLL(out)


class Emulated:
    """One kernel source on the CPU, with its own wrapper's model tables."""

    def __init__(self, cs, model):
        self.cs, self.fp = cs, cs.FusedPhysics(model)
        single = not hasattr(cs, "ldl_ceiling")
        self.ceiling = 0 if single else cs.ldl_ceiling(model.nv)
        self.lib = build(cs._SRC, single)
        self.lib.emu_physics_step.argtypes = (
            [ctypes.POINTER(cs._DuckModel), ctypes.POINTER(cs._DuckDR)] + [ctypes.c_int] * 3
            + [ctypes.c_void_p] * 12 + [ctypes.c_int] * 2)
        packed = self.fp.packed()
        self.keep = {k: np.ascontiguousarray(v) for k, v in packed["arrays"].items()}
        self.cm = cs._DuckModel()
        for k, _ in cs._DuckModel._fields_:
            if k in packed["sizes"]:
                setattr(self.cm, k, packed["sizes"][k])
        self.cm.env_floats = packed["layout"]["env_floats"]
        self.cm.lay[:] = packed["layout"]["offsets"]
        for k, v in packed["scalars"].items():
            setattr(self.cm, k, v)
        for k, a in self.keep.items():
            setattr(self.cm, k, a.ctypes.data)

    def __call__(self, qpos, qvel, warm, ctrl, n, dr, k=2):
        m, B = self.fp.model, qpos.shape[0]
        cdr, keep = self.cs._DuckDR(), []
        for f in (dr or {}):
            keep.append(np.ascontiguousarray(dr[f]))
            setattr(cdr, f, keep[-1].ctypes.data)
        outs = {f: np.full((B, w), np.nan, np.float32) for f, w in self.fp.out_widths().items()}
        ins = [np.ascontiguousarray(x, np.float32) for x in (qpos, qvel, warm, ctrl)]
        err = self.lib.emu_physics_step(
            ctypes.byref(self.cm), ctypes.byref(cdr), B, n, m.nsensordata,
            *[x.ctypes.data for x in ins], *[outs[f].ctypes.data for f in OUTS], k, self.ceiling)
        if err != 0:
            raise RuntimeError(f"emulated launch refused ({err})")
        return outs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--tasks", default="flat_terrain,rough_terrain_backlash")
    ap.add_argument("--envs", type=int, default=3)
    args = ap.parse_args()
    from open_duck_playground_tpu_torch.envs import randomize
    from open_duck_playground_tpu_torch.mjcf import compile_mjcf
    from open_duck_playground_tpu_torch.models.open_duck_mini_v2 import constants
    from open_duck_playground_tpu_torch.ops import cuda_step

    chip_smoke.asset_root()
    sd, parent, B, ok = chip_smoke.standin(), load_parent(args.parent), args.envs, True
    for task in args.tasks.split(","):
        m = compile_mjcf(constants.task_to_xml(task), timestep=0.002)
        kernels = {"parent": Emulated(parent, m), "new": Emulated(cuda_step, m)}
        for with_dr in (True, False):
            dr = None
            if with_dr:
                dr = {f: v.numpy() for f, v in cuda_step.flatten_dr_fields(
                    randomize.domain_randomize(m, B, torch.Generator().manual_seed(7))).items()}
            for start, make in (("settled", sd.settled_states), ("tilted", sd.tilted_states)):
                qpos, qvel, ctrl = make(m.keyframe("home"), m.nq, m.nv, m.nu, B, seed=B)
                if start == "tilted" and task == "flat_terrain":
                    ctrl = ctrl.copy()
                    ctrl[-1] = np.nan
                for n in (10, 1):
                    out = {k: fn(qpos, qvel, np.zeros_like(qvel), ctrl, n, dr)
                           for k, fn in kernels.items()}
                    bad = [f for f in OUTS
                           if not np.array_equal(out["parent"][f], out["new"][f], equal_nan=True)]
                    ok &= not bad
                    print(f"[emulate] {task} B={B} dr={int(with_dr)} {start} n={n}: "
                          f"{'bit-exact' if not bad else 'DIFFERS in ' + ', '.join(bad)}",
                          flush=True)
    print("[emulate] all bit-exact" if ok else "[emulate] DIFFERENCES")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
