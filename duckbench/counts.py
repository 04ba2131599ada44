"""Make the frozen operation and word counts of a configuration's physics.

    python3 -m duckbench.counts duckbench/configs/<config>.json

prints the ``counts`` block that the configuration's file holds (and that
``roofline.py`` reads): the fused step's arithmetic per env and substep, with
and without domain randomization, as the output elements of the arithmetic
aten ops of one substep of the plain reference's physics (``ref/ops/twin.py``)
at 4 envs on the CPU, both sides of every ``where`` included
(``chip_smoke.py``'s ``flops_per_env_substep``); the words each env moves
once (qpos, qvel, warm start and ctrl in, the outputs, and the DR fields);
the heightfield table's floats.
"""

from __future__ import annotations

import json
import os
import sys

import torch

from duckbench import run

# the arithmetic aten ops counted (each output element one operation)
ARITH_OPS = frozenset((
    "add", "sub", "rsub", "mul", "div", "neg", "abs", "sqrt", "reciprocal", "sin", "cos",
    "exp2", "floor", "sign", "maximum", "minimum", "clamp", "clamp_min", "clamp_max", "where",
    "lt", "le", "gt", "ge", "eq", "ne", "bitwise_and", "bitwise_or", "bitwise_not"))


def _flops(twin, qpos, qvel, ctrl, dr) -> float:
    from torch.utils._python_dispatch import TorchDispatchMode

    n = qpos.shape[0]

    class Count(TorchDispatchMode):
        flops = 0.0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket.__name__.rstrip("_") in ARITH_OPS:
                Count.flops += out.numel() / n
            return out

    with Count():
        twin(qpos, qvel, torch.zeros_like(qvel), ctrl, 1, dr)
    return Count.flops


def counts(cfg: dict) -> dict:
    from duckbench.ref.envs import randomize
    from duckbench.ref.mjcf import compile_mjcf
    from duckbench.ref.ops.twin import TwinPhysics, flatten_dr_fields

    run.prepare()
    xml = os.path.join(run.ASSETS, "xmls", f"scene_{cfg['task']}.xml")
    m = compile_mjcf(xml, timestep=cfg["env_config"]["sim_dt"])
    twin = TwinPhysics(m)
    n = 4
    kf = m.keyframe("home")
    qpos = torch.tensor(kf.qpos, dtype=torch.float32).expand(n, -1).clone()
    ctrl = torch.tensor(kf.ctrl, dtype=torch.float32).expand(n, -1).clone()
    qvel = torch.zeros(n, m.nv)
    dr = flatten_dr_fields(randomize.domain_randomize(m, n, torch.Generator().manual_seed(0)))
    base = m.nq + 2 * m.nv + m.nu + sum(twin.out_widths().values())
    return {
        "physics_flops_per_env_substep": {"dr": _flops(twin, qpos, qvel, ctrl, dr),
                                          "nominal": _flops(twin, qpos, qvel, ctrl, None)},
        "physics_words_per_env": {"dr": base + sum(v.shape[1] for v in dr.values()),
                                  "nominal": base},
        "hfield_floats": 0 if m.hfield_data is None else int(m.hfield_data.numel()),
        "made_by": "python3 -m duckbench.counts <this file>: output elements of the arithmetic "
                   "aten ops of one substep of ref/ops/twin.py at the home keyframe, 4 envs, CPU",
    }


if __name__ == "__main__":
    with open(sys.argv[1]) as f:
        print(json.dumps(counts(json.load(f)), indent=1))
