"""Wrapper of the fused physics-step kernel (``csrc/physics_step.cu``).

Counterpart of the JAX package's ``ops/pallas_step.py`` (``_build_kernel``,
``make_fused_step_n``, ``make_fused_init``). ``FusedPhysics(model)`` runs n
physics substeps with ctrl held fixed for a batch of envs and returns the
fields the env path reads: qpos, qvel, qacc_warmstart, and the derived
outputs (sensordata, actuator_force, contact_dist, site_xpos, site_xmat) of
the last substep, taken before its integration.

- Tensors on a CUDA device launch the hand-written kernel, built with
  ``nvcc`` for ``sm_90a`` from this package's sources at first use into
  ``build/kernels/`` of the checkout, and loaded with ``ctypes``. Anything the
  kernel does not take raises; nothing falls back.
- The kernel runs one warp per env with the env's arrays in shared memory:
  ``shared_layout`` places them from the model's sizes, ``launch_geometry``
  picks the envs per block from the occupancy the runtime reports.
- Tensors on the CPU run the kernel's plain PyTorch version
  (``lane_physics.LanePhysics``), the same program on ``(B,)`` tensors.
- ``launches`` counts the kernel launches of this object, and nothing else
  (the tracer's ``physics.launches``); each call is the tracer's span
  ``physics`` (utils/profiling.py).

The same library holds the optimizer's kernel (``csrc/adam.cu``, launched by
``adam_step`` for ``train/optim.py``'s ``clip_and_adam``), the trainer's GAE
(``csrc/gae.cu``, launched by ``gae_step`` for ``train/ppo.py``'s ``gae``),
the MLPs' swish forward and backward (``csrc/swish.cu``, launched by
``swish_forward`` and ``swish_backward`` for ``train/networks.py``'s
``swish``) and the tracer's stamp kernel (``csrc/stamp.cu``).

The model is data, not code: the structural arrays (and a rough scene's
heightfield table) are packed once per device into tensors whose pointers
the kernel reads at run time. Every scene of the duck runs through it:
plane-hull, hull-hull and heightfield-hull contact pairs. Domain
randomization comes as the flat ``(B, rows)`` fields of ``DR_FIELDS``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Optional

import numpy as np
import torch

from open_duck_playground_tpu_torch.ops.lane_physics import (
    DR_FIELDS,
    LanePhysics,
    _MINVAL,
    _kbi_const,
    _np_quat_mul,
    _np_quat_rot,
    _np_quat_to_mat,
)
from open_duck_playground_tpu_torch.ops.types import JointType, Model, PairType
from open_duck_playground_tpu_torch.utils import profiling

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "physics_step.cu")
# built into the same library: the tracer's device time stamps (utils/profiling.py),
# the trainer's clip + Adam step (train/optim.py clip_and_adam), its GAE
# (train/ppo.py gae) and the MLPs' swish (train/networks.py swish)
_STAMP_SRC = os.path.join(os.path.dirname(_SRC), "stamp.cu")
_ADAM_SRC = os.path.join(os.path.dirname(_SRC), "adam.cu")
_GAE_SRC = os.path.join(os.path.dirname(_SRC), "gae.cu")
_SWISH_SRC = os.path.join(os.path.dirname(_SRC), "swish.cu")
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no FMA contraction: keep the twin's rounding, operation for operation
    "-fmad=false",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

# flat per-env row shapes of the DR fields (pallas_step._DR_SHAPES)
_DR_SHAPES = {
    "geom_friction": ("ngeom", 3),
    "body_ipos": ("nbody", 3),
    "dof_frictionloss": ("nv",),
    "dof_armature": ("nv",),
    "body_mass": ("nbody",),
    "qpos0": ("nq",),
    "actuator_gainprm": ("nu", 3),
    "actuator_biasprm": ("nu", 3),
}
# dof masks are 32-bit words; one lane per hull vertex
_LIMIT_NAMES = ("nv", "hv")
# the LDL unroll ceilings the kernel is instantiated for (duck_step_kernel)
LDL_CEILINGS = (24, 32)
# shared memory one block may use on an H100 (sm_90): 227 KB
MAX_SHARED_BYTES = 232448
_ALIGN = 4  # floats: every array starts on a 16-byte boundary
_ENVS_PER_BLOCK = (1, 2, 4, 8, 16)


def _layout_groups(s: Dict[str, int]):
    """The arrays of one env's shared-memory slice, in the kernel's enum
    order (``L_*`` in csrc/physics_step.cu): groups of (name, floats, what
    of the twin's substep it holds). Group "substep" lives through a whole
    substep; "rigid_body" from kinematics to the bias forces; each other
    group is one stage's scratch. The stage groups up to the bias forces
    (phase "A") overlay each other after "rigid_body"; those from the
    smooth acceleration on (phase "B") overlay each other and "rigid_body"."""
    nq, nv, nu, nb, nj = s["nq"], s["nv"], s["nu"], s["nbody"], s["njnt"]
    hv, hf, npair, nefc, ns = s["hv"], s["hf"], s["npair"], s["nefc"], s["nsite"]
    tri = nv * (nv + 1) // 2
    return (
        ("substep", "", (
            ("QPOS", nq, "qpos"), ("QVEL", nv, "qvel"), ("WARM", nv, "warm (qacc_warmstart)"),
            ("CTRL", nu, "ctrl"),
            ("XPOS", 3 * nb, "kinematics: xpos"), ("XQUAT", 4 * nb, "kinematics: xquat"),
            ("SUBTREE_COM", 3 * nb, "com_pos: subtree_com"),
            ("CDOF", 6 * nv, "com_pos: cdof"), ("CDOFDOT", 6 * nv, "com_vel: cdofdot"),
            ("CVEL", 6 * nb, "com_vel: cvel"),
            ("M", tri, "crb: M, packed lower triangle on the tree pattern"),
            ("QACC_SMOOTH", nv, "qacc_smooth"), ("QACC", nv, "solve_constraints: qacc"),
            ("ACT_FORCE", nu, "actuation: actuator_force"),
            ("CAND", 16 * npair, "collide: 4 candidates per pair, [dist, pos]"),
            ("FRAME", 9 * npair, "collide: contact frame rows per pair"),
            ("EFC_J", s["efc_nnz"], "make_efc: each row's support coefficients"),
            ("EFC_D", nefc, "make_efc: D"), ("EFC_AREF", nefc, "make_efc: aref"),
            ("EFC_POS", nefc, "make_efc: pos"), ("EFC_FLOSS", nefc, "make_efc: floss"),
            ("EFC_JAREF", nefc, "solve_constraints: Jaref"),
            ("EFC_JD", nefc, "solve_constraints: Jd"),
            ("SCAL", 32, "scalars one lane hands to the others"),
        )),
        ("rigid_body", "", (
            ("XANCHOR", 3 * nj, "kinematics: xanchor"), ("XAXIS", 3 * nj, "kinematics: xaxis"),
            ("CINERT", 21 * nb, "com_pos: cinert (sym6 per body)"),
        )),
        ("com_pos", "A", (("XIPOS", 3 * nb, "xipos"),
                          ("SEG", 4 * nb, "subtree mass moments, mass"))),
        ("crb", "A", (("CRB", 21 * nb, "crb_inert"), ("FVEC", 6 * nv, "F = crb_inert cdof"))),
        ("collide", "A", (
            ("W1", 3 * hv, "hull 1 vertices (world)"), ("W2", 3 * hv, "hull 2 vertices (world)"),
        )),
        ("dynamics", "A", (
            ("VPRE", 6 * nv, "com_vel: body velocity before each dof"),
            ("CACC", 6 * nb, "rne: cacc"), ("CFRC", 6 * nb, "rne: cfrc"),
            ("BIAS", nv, "rne: qfrc_bias"), ("QFRC_ACT", nv, "actuation: qfrc_actuator"),
        )),
        ("smooth_acceleration", "B", (
            ("LDLM", tri, "LDL factor of M, packed lower triangle"),
        )),
        ("make_efc", "B", (
            ("CMETA", 16 * npair, "per candidate: imp, D, pos_neg, mu"),
            ("JNT", 12 * s["efc_pair_width"], "per candidate and support dof: Jn, Jt1, Jt2"),
        )),
        ("solve_constraints", "B", (
            ("H", tri, "Newton Hessian, then its LDL factor, packed lower triangle"),
            ("GRAD", nv, "grad"), ("MAERR", nv, "Ma_err"), ("DIR", nv, "search direction"),
            ("TMP", nv, "q - qacc_smooth, M dir"), ("TMP2", nv, "M (q - qacc_smooth)"),
            ("EFC_F", nefc, "row forces"), ("EFC_W", nefc, "row Hessian weights"),
            ("TERMS", 2 * nefc, "per-row terms of the costs and line-search sums"),
        )),
        ("write_derived", "B", (
            ("SPOS", 3 * ns, "site_xpos"), ("SMAT", 9 * ns, "site_xmat"),
            ("PCACC", 6 * nb, "rne_post_cacc: cacc"),
        )),
    )


LAYOUT_NAMES = tuple(name for _, _, arrays in _layout_groups(
    {k: 1 for k in ("nq", "nv", "nu", "nbody", "njnt", "hv", "hf", "npair", "nefc", "nsite",
                    "efc_nnz", "efc_pair_width")}) for name, _, _ in arrays)


def _up(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def shared_layout(sizes: Dict[str, int]) -> dict:
    """One env's shared-memory slice, from the model's packed ``sizes``:
    ``offsets`` (floats, in LAYOUT_NAMES order), ``spans`` {name: (offset,
    floats, group, phase)}, ``env_floats`` and ``env_bytes``. Raises if one
    env does not fit a block's shared memory."""
    spans = {}

    def place(group, phase, arrays, off):
        for name, n, _ in arrays:
            spans[name] = (off, n, group, phase)
            off = _up(off + n)
        return off

    groups = _layout_groups(sizes)
    base = place(*groups[0], 0)             # the substep's arrays
    a_base = place(*groups[1], base)        # phase A's long-lived arrays
    end = a_base
    for group, phase, arrays in groups[2:]:
        end = max(end, place(group, phase, arrays, a_base if phase == "A" else base))
    env_bytes = 4 * end
    if env_bytes > MAX_SHARED_BYTES:
        raise ValueError(f"one env needs {env_bytes} bytes of shared memory; a block has "
                         f"{MAX_SHARED_BYTES}: the model does not fit the fused kernel")
    return dict(offsets=[spans[n][0] for n in LAYOUT_NAMES], spans=spans, env_floats=end,
                env_bytes=env_bytes)


def launch_geometry(B: int, env_bytes: int, sms: int, blocks_per_sm) -> dict:
    """Envs (warps) per block and the grid for B envs: the k of
    _ENVS_PER_BLOCK whose blocks (32 k threads, k env slices of shared
    memory) keep the most warps resident per SM, the smallest k on a tie.
    ``blocks_per_sm(k)`` is the runtime's occupancy for such a block."""
    best = None
    for k in _ENVS_PER_BLOCK:
        if k * env_bytes > MAX_SHARED_BYTES:
            break
        n = blocks_per_sm(k)
        if n > 0 and (best is None or n * k > best[0] * best[1]):
            best = (n, k)
    if best is None:
        raise ValueError(f"no block of one env ({env_bytes} bytes of shared memory) fits an SM")
    n, k = best
    blocks = -(-B // k)
    return dict(envs_per_block=k, blocks=blocks, blocks_per_sm=n, warps_per_sm=n * k,
                waves=-(-blocks // (n * sms)), sms=sms)


def ldl_ceiling(nv: int) -> int:
    """The kernel instantiation for a model of `nv` dofs: the least of
    LDL_CEILINGS that holds nv (each lane keeps one row of the LDL factor in
    registers, unrolled to the ceiling)."""
    for c in LDL_CEILINGS:
        if nv <= c:
            return c
    raise ValueError(f"model does not fit the fused kernel: nv={nv} > {LDL_CEILINGS[-1]}")


def dr_rows(m: Model, field: str) -> int:
    n = 1
    for d in _DR_SHAPES[field]:
        n *= getattr(m, d) if isinstance(d, str) else d
    return n


def flatten_dr_fields(m_batched: Model) -> Dict[str, torch.Tensor]:
    """The DR-batched model fields as flat contiguous ``(B, rows)`` tensors."""
    return {f: getattr(m_batched, f).reshape(getattr(m_batched, f).shape[0], -1).contiguous()
            for f in DR_FIELDS}


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    for cand in (os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None,
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the fused physics kernel is built with the CUDA toolkit")


def build_library(profile: bool = False) -> str:
    """Compile the kernel, the tracer's stamp kernel (``csrc/stamp.cu``), the
    optimizer's kernel (``csrc/adam.cu``), the GAE kernel (``csrc/gae.cu``)
    and the swish's two (``csrc/swish.cu``) into one library, or reuse an
    earlier build of the same sources; returns the path of the shared library. Its ptxas report (registers, stack,
    spills) is written beside it as ``.log``. ``profile`` builds the variant that counts each stage's
    clock cycles (``-DDUCK_PROFILE``)."""
    src = b""
    sources = (_SRC, _STAMP_SRC, _ADAM_SRC, _GAE_SRC, _SWISH_SRC)
    for path in sources:
        with open(path, "rb") as f:
            src += f.read()
    flags = NVCC_FLAGS + (("-DDUCK_PROFILE",) if profile else ())
    key = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"libduck_physics_{key}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *flags, "-o", tmp, *sources],
                          capture_output=True, text=True)
    with open(so + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, so)
    return so


_INT_SIZES = ("nq", "nv", "nu", "nbody", "njnt", "ngeom", "nsite", "nsensor", "npair", "nfri",
              "nlim", "hv", "hf", "iterations", "ls_iterations", "hfield_nrow", "hfield_ncol",
              "nefc", "max_depth", "env_floats")


class _DuckModel(ctypes.Structure):
    _fields_ = (
        [(n, ctypes.c_int) for n in _INT_SIZES]
        + [(n, ctypes.c_float) for n in ("dt", "gx", "gy", "gz")]
        + [("lay", ctypes.c_int * len(LAYOUT_NAMES))]
        + [(n, ctypes.c_void_p) for n in (
            "body_parentid", "body_rootid", "body_jntadr", "body_jntnum", "body_dofadr",
            "body_dofnum", "body_pos", "body_quat", "body_ipos", "body_iquat", "body_mass",
            "body_inertia", "jnt_type", "jnt_qposadr", "jnt_dofadr", "jnt_pos", "jnt_axis",
            "dof_bodyid", "dof_armature", "dof_damping", "dof_frictionloss", "tree_mask",
            "ldl_mask", "ldlh_mask", "fri_dof", "fri_D", "fri_b", "lim_jnt", "lim_prm",
            "geom_bodyid", "geom_pos", "geom_quat", "geom_friction", "site_bodyid",
            "site_pos", "site_quat", "sensor_type", "sensor_objid", "sensor_adr", "act_adr",
            "act_prm", "gainprm", "biasprm", "qpos0", "pair_i", "pair_f", "hull_vert",
            "hull_face_n", "hfield_data", "hfield_prm", "efc_off", "efc_col", "efc_dof_rows",
            "body_depth")]
    )


class _DuckDR(ctypes.Structure):
    # the kernel's DuckDR holds its pointers in DR_FIELDS order
    _fields_ = [(n, ctypes.c_void_p) for n in DR_FIELDS]


# the stages duck_profile reports, in its order (PROF_* in the kernel)
PROFILE_STAGES = ("kinematics", "com_pos", "crb", "collide", "com_vel_rne_actuation",
                  "smooth_acceleration", "make_efc", "primal_costs", "grad_hessian",
                  "factor_solve_hessian", "line_search", "outputs_integrate")


@functools.lru_cache(maxsize=2)
def _library(profile: bool = False):
    lib = ctypes.CDLL(build_library(profile))
    lib.duck_profile.restype = ctypes.c_int
    lib.duck_profile.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    lib.duck_limits.restype = ctypes.c_int
    lib.duck_limits.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.duck_configure.restype = ctypes.c_int
    lib.duck_configure.argtypes = [ctypes.c_int] * 2
    lib.duck_occupancy.restype = ctypes.c_int
    lib.duck_occupancy.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    lib.duck_physics_step.restype = ctypes.c_int
    lib.duck_physics_step.argtypes = (
        [ctypes.POINTER(_DuckModel), ctypes.POINTER(_DuckDR), ctypes.c_int, ctypes.c_int,
         ctypes.c_int]
        + [ctypes.c_void_p] * 12 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    )
    lib.duck_stamp.restype = ctypes.c_int
    lib.duck_stamp.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_ulonglong,
                               ctypes.c_void_p]
    lib.duck_adam.restype = ctypes.c_int
    lib.duck_adam.argtypes = ([ctypes.c_int] + [ctypes.POINTER(ctypes.c_void_p)] * 4
                              + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_void_p] * 3
                              + [ctypes.c_float] * 7 + [ctypes.c_void_p])
    lib.duck_gae.restype = ctypes.c_int
    lib.duck_gae.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 7 + [ctypes.c_float] * 3
                             + [ctypes.c_void_p])
    lib.duck_swish_forward.restype = ctypes.c_int
    lib.duck_swish_forward.argtypes = [ctypes.c_longlong] + [ctypes.c_void_p] * 3
    lib.duck_swish_backward.restype = ctypes.c_int
    lib.duck_swish_backward.argtypes = [ctypes.c_longlong] + [ctypes.c_void_p] * 4
    return lib


def _stamp(ring: int, count: int, capacity: int, stream: int) -> int:
    """The tracer's stamp kernel (``csrc/stamp.cu``): see profiling.stamp_with."""
    return _library().duck_stamp(ring, count, capacity, stream)


profiling.stamp_with(_stamp)


# the most tensors one launch of the optimizer's kernel takes (DUCK_ADAM_LEAVES)
ADAM_MAX_TENSORS = 32


class KernelLaunches:
    """The launches of a hand-written kernel, kept as FusedPhysics keeps its
    own (`launches`; a CUDA graph's replay adds those its capture recorded,
    utils.graphs.GraphedBody); `name` is the kernel's in a graph's
    ``launches_per_replay``."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0


# the optimizer's kernel: one launch is one fused step (the tracer's optim.fused_steps)
ADAM = KernelLaunches("duck_adam")


def adam_step(params, grads, mu, nu, norm: Optional[torch.Tensor], bc1: torch.Tensor,
              bc2: torch.Tensor, max_norm: Optional[float], b1: float, b2: float, eps: float,
              learning_rate: float) -> None:
    """The optimizer's kernel (``csrc/adam.cu``) on the current stream: the
    clip's select (where `norm`, the global norm as a device scalar, is
    given), both Adam moments and the update, in place on `params`, `mu`
    and `nu`, every tensor (1 to ADAM_MAX_TENSORS) in one launch, counted in
    ``ADAM.launches``. `bc1` and `bc2` are the bias corrections as device
    scalars. The Python constants go over as the float32 values torch casts
    them to. Raises ValueError on what the kernel does not take."""
    if not 1 <= len(params) <= ADAM_MAX_TENSORS:
        raise ValueError(f"{len(params)} tensors: one launch takes 1 to {ADAM_MAX_TENSORS}")
    dev = params[0].device
    if not len(params) == len(grads) == len(mu) == len(nu):
        raise ValueError(f"{len(params)} params, {len(grads)} grads, {len(mu)} + {len(nu)} "
                         "moments")
    scalars = [("bc1", bc1), ("bc2", bc2)] + ([("norm", norm)] if norm is not None else [])
    for name, t in scalars:
        if t.device != dev or t.dtype != torch.float32 or t.numel() != 1:
            raise ValueError(f"{name} must be one float32 on {dev}")
    for i, group in enumerate(zip(params, grads, mu, nu)):
        for t in group:
            if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError(f"tensor {i}: params, grads and moments must be contiguous "
                                 f"float32 on {dev}")
            if t.shape != group[0].shape:
                raise ValueError(f"tensor {i}: shape {tuple(t.shape)}, param "
                                 f"{tuple(group[0].shape)}")
    ptrs = [(ctypes.c_void_p * len(params))(*[t.data_ptr() for t in ts])
            for ts in (params, grads, mu, nu)]
    numel = (ctypes.c_longlong * len(params))(*[p.numel() for p in params])
    err = _library().duck_adam(
        len(params), *ptrs, numel, None if norm is None else norm.data_ptr(), bc1.data_ptr(),
        bc2.data_ptr(), 0.0 if max_norm is None else max_norm, b1, 1 - b1, b2, 1 - b2, eps,
        -learning_rate, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"optimizer kernel launch failed: cudaError {err}")
    ADAM.launches += 1


# the GAE kernel: one launch is one fused GAE (the tracer's gae.fused_steps)
GAE = KernelLaunches("duck_gae")


def gae_step(reward: torch.Tensor, discount: torch.Tensor, truncation: torch.Tensor,
             values: torch.Tensor, bootstrap_value: torch.Tensor, reward_scaling: float,
             discounting: float, gae_lambda: float):
    """The GAE kernel (``csrc/gae.cu``) on the current stream: ppo.compute_gae
    of `values` [T, b] and `bootstrap_value` [b], on the rewards
    ``reward * reward_scaling`` and the termination ``(1 - discount) * (1 -
    truncation)``, as ppo.loss_points makes them, rounded as those torch ops
    round; returns (vs, advantages) [T, b], new tensors, after one launch
    counted in ``GAE.launches``. The Python constants go over as the float32
    values torch casts them to. Raises ValueError on what the kernel does not
    take: anything but contiguous float32 tensors of those shapes on one
    CUDA device."""
    if values.dim() != 2 or values.shape[0] < 1 or values.shape[1] < 1:
        raise ValueError(f"values must be [T, b] with T, b >= 1, not {tuple(values.shape)}")
    T, b = values.shape
    dev = values.device
    named = {"reward": reward, "discount": discount, "truncation": truncation,
             "values": values, "bootstrap_value": bootstrap_value}
    for name, t in named.items():
        want = (b,) if name == "bootstrap_value" else (T, b)
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want {want}")
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 on {dev}")
    if dev.type != "cuda":
        raise ValueError(f"the GAE kernel runs on a CUDA device, not {dev}")
    vs, advantages = torch.empty_like(values), torch.empty_like(values)
    err = _library().duck_gae(
        T, b, reward.data_ptr(), discount.data_ptr(), truncation.data_ptr(), values.data_ptr(),
        bootstrap_value.data_ptr(), vs.data_ptr(), advantages.data_ptr(), reward_scaling,
        discounting, gae_lambda, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"GAE kernel launch failed: cudaError {err}")
    GAE.launches += 1
    return vs, advantages


# the swish's kernels: each launch, forward or backward, is one fused call
# (the tracer's swish.fused_calls)
SWISH = KernelLaunches("duck_swish")


def _swish_launch(entry: str, out: torch.Tensor, *inputs: torch.Tensor) -> torch.Tensor:
    for t in (*inputs, out):
        if t.device.type != "cuda" or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"the swish kernels take contiguous float32 CUDA tensors, not "
                             f"{t.dtype} on {t.device} (contiguous: {t.is_contiguous()})")
        if t.shape != out.shape or t.device != out.device:
            raise ValueError(f"shape {tuple(t.shape)} on {t.device}, want "
                             f"{tuple(out.shape)} on {out.device}")
    if out.numel():
        err = getattr(_library(), entry)(out.numel(), *[t.data_ptr() for t in (*inputs, out)],
                                         torch.cuda.current_stream(out.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"swish kernel launch failed: cudaError {err}")
        SWISH.launches += 1
    return out


def swish_forward(x: torch.Tensor) -> torch.Tensor:
    """``x * torch.sigmoid(x)`` by the swish's forward kernel
    (``csrc/swish.cu``) on the current stream, bit for bit: a new tensor,
    after one launch counted in ``SWISH.launches`` (none for an empty `x`).
    Raises ValueError on anything but a contiguous float32 CUDA tensor."""
    return _swish_launch("duck_swish_forward", torch.empty_like(x), x)


def swish_backward(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The gradient of ``x * torch.sigmoid(x)`` at `x` given the output's
    gradient `g`, by the swish's backward kernel, as autograd computes it,
    bit for bit: ``g * s + ((g * x) * (1 - s)) * s`` with ``s`` recomputed
    from `x`. A new tensor after one launch counted in ``SWISH.launches``;
    raises ValueError as `swish_forward`, or if the shapes differ."""
    return _swish_launch("duck_swish_backward", torch.empty_like(x), g, x)


def kernel_limits() -> Dict[str, int]:
    lib = _library()
    buf = (ctypes.c_int * 16)()
    n = lib.duck_limits(buf)
    return dict(zip(_LIMIT_NAMES, buf[:n]))


def card_occupancy(env_bytes: int, device, ceiling: int, profile: bool = False):
    """(SM count, {k: resident blocks per SM}) for blocks of k envs of the
    kernel instantiated for LDL ceiling `ceiling` on `device`, from the
    runtime, after raising its dynamic shared-memory limit once to the
    largest block considered."""
    lib = _library(profile)
    ks = [k for k in _ENVS_PER_BLOCK if k * env_bytes <= MAX_SHARED_BYTES]
    occ, out = {}, (ctypes.c_int * 2)()
    with torch.cuda.device(device):
        err = lib.duck_configure(ks[-1] * env_bytes, ceiling) if ks else 0
        for k in ks:
            err = err or lib.duck_occupancy(32 * k, k * env_bytes, ceiling, out)
            occ[k] = out[0]
    if err != 0:
        raise RuntimeError(f"fused physics kernel: shared-memory set-up failed: cudaError {err}")
    return out[1], occ


# ---------------------------------------------------------------------------
# model packing
# ---------------------------------------------------------------------------


def _imp_block(solref, solimp):
    k, b, dmin, dmax, width, mid, power = _kbi_const(solref, solimp)
    return [k, b, dmin, dmax, width, mid, power,
            mid ** (1.0 - power), (1.0 - mid) ** (1.0 - power), dmax - dmin]


def _masks(nv: int, pattern, strict: bool) -> np.ndarray:
    out = np.zeros(nv, np.uint64)
    for (i, j) in pattern:
        if j < i or (j == i and not strict):
            out[i] |= np.uint64(1) << np.uint64(j)
    return out.astype(np.uint32).view(np.int32)


def _bits(dofs) -> int:
    v = 0
    for d in dofs:
        v |= 1 << d
    return v - (1 << 32) if v >= 1 << 31 else v


def pack_model(lane: LanePhysics) -> Dict[str, dict]:
    """What the kernel reads: ``sizes`` and ``scalars`` (python numbers) and
    ``arrays`` (int32 / float32 numpy, C-contiguous). Each pair type is
    packed by name; any other raises."""
    m, c = lane.m, lane.c
    for t in m.jnt_type:
        if int(t) not in (JointType.FREE, JointType.HINGE):
            raise NotImplementedError(f"joint type {int(t)} in the fused kernel")
    i32 = lambda x: np.ascontiguousarray(np.asarray(x, np.int64).astype(np.int32))  # noqa: E731
    f32 = lambda x: np.ascontiguousarray(np.asarray(x, np.float64).astype(np.float32))  # noqa: E731

    fri_D, fri_b = [], []
    for i in lane.fri_dofs:
        k, b, dmin, *_ = _kbi_const(c.dof_solref[i], c.dof_solimp[i])
        R = max(_MINVAL, (1.0 - dmin) / dmin * float(c.dof_invweight0[i]))
        fri_D.append(1.0 / R)
        fri_b.append(b)
    lim_prm = []
    for j in lane.lim_jnts:
        dofadr = int(m.jnt_dofadr[j])
        lim_prm.append(_imp_block(c.jnt_solref[j], c.jnt_solimp[j]) + [
            float(c.jnt_range[j, 0]), float(c.jnt_range[j, 1]), float(c.jnt_margin[j]),
            float(c.dof_invweight0[dofadr])])

    impratio = float(m.opt.impratio)
    pair_i, pair_f = [], []
    for p in range(m.npair):
        g1, g2, ptype = int(m.pair_geom1[p]), int(m.pair_geom2[p]), int(m.pair_type[p])
        if ptype not in (PairType.PLANE_HULL, PairType.HFIELD_HULL, PairType.HULL_HULL):
            raise NotImplementedError(f"pair type {ptype} in the fused kernel")
        b1, b2 = int(m.geom_bodyid[g1]), int(m.geom_bodyid[g2])
        p1, p2 = int(m.geom_priority[g1]), int(m.geom_priority[g2])
        if p1 == p2:
            mu_g = (g1, g2)
            mu = max(float(c.geom_friction[g1, 0]), float(c.geom_friction[g2, 0]))
            solref = 0.5 * (c.geom_solref[g1] + c.geom_solref[g2])
            solimp = 0.5 * (c.geom_solimp[g1] + c.geom_solimp[g2])
        else:
            gsrc = g1 if p1 > p2 else g2
            mu_g = (gsrc, gsrc)
            mu = float(c.geom_friction[gsrc, 0])
            solref, solimp = c.geom_solref[gsrc], c.geom_solimp[gsrc]
        invweight = float(c.body_invweight0[b1, 0] + c.body_invweight0[b2, 0])
        diag = max((invweight + mu * mu * invweight) * 2.0 * mu * mu / impratio, _MINVAL)
        n, ppn, frame, hf_pose = [0.0] * 3, 0.0, [0.0] * 9, [0.0] * 12
        if ptype == PairType.HFIELD_HULL:
            # the terrain's body is static: a constant pose, as the twin's
            bpos, bquat = lane._static_body_pose(b1)
            hp = bpos + _np_quat_rot(bquat, c.geom_pos[g1])
            R = _np_quat_to_mat(_np_quat_mul(bquat, c.geom_quat[g1]))
            hf_pose = [float(v) for v in hp] + [float(v) for v in R.ravel()]
        if ptype == PairType.PLANE_HULL:
            bpos, bquat = lane._static_body_pose(b1)
            pp = bpos + _np_quat_rot(bquat, c.geom_pos[g1])
            pq = _np_quat_mul(bquat, c.geom_quat[g1])
            w_, x_, y_, z_ = pq
            n = [2 * (x_ * z_ + w_ * y_), 2 * (y_ * z_ - w_ * x_), 1 - 2 * (x_ * x_ + y_ * y_)]
            ppn = float(np.dot(pp, np.asarray(n)))
            frame = [v for row in lane._const_frame(n) for v in row]
        hull1 = max(int(m.geom_dataid[g1]), 0)
        pair_i.append([ptype, g1, g2, b1, b2, int(m.body_rootid[b1]), int(m.body_rootid[b2]),
                       hull1, int(m.geom_dataid[g2]), mu_g[0], mu_g[1],
                       _bits(lane._body_dofs(b1)), _bits(lane._body_dofs(b2))])
        pair_f.append(_imp_block(solref, solimp) + [diag, mu] + [float(v) for v in n]
                      + [ppn] + frame + [invweight, impratio] + hf_pose)

    act_adr, act_prm = [], []
    for u in range(m.nu):
        j = int(m.actuator_trnid[u])
        act_adr.append([int(m.jnt_qposadr[j]), int(m.jnt_dofadr[j])])
        act_prm.append([c.actuator_ctrlrange[u, 0], c.actuator_ctrlrange[u, 1],
                        c.actuator_gear[u], c.actuator_gainprm[u, 0], c.actuator_biasprm[u, 0],
                        c.actuator_biasprm[u, 1], c.actuator_biasprm[u, 2],
                        c.actuator_forcerange[u, 0], c.actuator_forcerange[u, 1]])

    hfield = {}
    nrow = ncol = 0
    if any(int(t) == PairType.HFIELD_HULL for t in m.pair_type):
        # the table row major as the model holds it (the TPU kernel took it
        # transposed, for its one-hot matmul), and its constants, each
        # rounded to float32 once as the twin's python floats are
        nrow, ncol = c.hfield_data.shape
        if min(nrow, ncol) < 2:
            raise ValueError(f"heightfield of {nrow} x {ncol}: the kernel needs 2 x 2 or more")
        rx, ry, ztop = (float(v) for v in c.hfield_size[:3])
        hfield = dict(
            hfield_data=f32(c.hfield_data),
            hfield_prm=f32([rx, ry, 2.0 * rx, 2.0 * ry, ncol - 1, nrow - 1, ncol - 1.001,
                            nrow - 1.001, ztop, 2.0 * rx / (ncol - 1), 2.0 * ry / (nrow - 1)]))

    # constraint rows over their supports only, in the twin's row order
    # (friction, limits, then 16 rows per pair) and column order (ascending)
    supports = efc_supports(lane)
    efc_off = np.cumsum([0] + [len(r) for r in supports])
    nfl = len(lane.fri_dofs) + len(lane.lim_jnts)
    # each dof's friction row and limit row (-1 for none): the rows of width
    # one that touch H's diagonal and grad
    dof_rows = np.full((m.nv, 2), -1)
    for r, (d,) in enumerate(supports[:nfl]):
        kind = int(r >= len(lane.fri_dofs))
        if dof_rows[d, kind] >= 0:
            raise NotImplementedError(f"dof {d} has two {('friction', 'limit')[kind]} rows")
        dof_rows[d, kind] = r
    depth = [0] * m.nbody
    for b in range(1, m.nbody):
        depth[b] = depth[int(m.body_parentid[b])] + 1
    return dict(
        sizes=dict(nq=m.nq, nv=m.nv, nu=m.nu, nbody=m.nbody, njnt=m.njnt, ngeom=m.ngeom,
                   nsite=m.nsite, nsensor=len(m.sensor_type), npair=m.npair,
                   nfri=len(lane.fri_dofs), nlim=len(lane.lim_jnts),
                   hv=int(c.hull_vert.shape[1]), hf=int(c.hull_face_n.shape[1]),
                   iterations=int(m.opt.iterations), ls_iterations=int(m.opt.ls_iterations),
                   hfield_nrow=nrow, hfield_ncol=ncol, nefc=len(supports),
                   max_depth=max(depth),
                   efc_nnz=int(efc_off[-1]),
                   efc_pair_width=sum(len(d) for d in lane.pair_dofs)),
        scalars=dict(dt=float(m.opt.timestep), gx=float(c.gravity[0]),
                     gy=float(c.gravity[1]), gz=float(c.gravity[2])),
        arrays=dict(
            body_parentid=i32(m.body_parentid), body_rootid=i32(m.body_rootid),
            body_jntadr=i32(m.body_jntadr), body_jntnum=i32(m.body_jntnum),
            body_dofadr=i32(m.body_dofadr), body_dofnum=i32(m.body_dofnum),
            body_pos=f32(c.body_pos), body_quat=f32(c.body_quat), body_ipos=f32(c.body_ipos),
            body_iquat=f32(c.body_iquat), body_mass=f32(c.body_mass),
            body_inertia=f32(c.body_inertia),
            jnt_type=i32(m.jnt_type), jnt_qposadr=i32(m.jnt_qposadr),
            jnt_dofadr=i32(m.jnt_dofadr), jnt_pos=f32(c.jnt_pos), jnt_axis=f32(c.jnt_axis),
            dof_bodyid=i32(m.dof_bodyid), dof_armature=f32(c.dof_armature),
            dof_damping=f32(c.dof_damping), dof_frictionloss=f32(c.dof_frictionloss),
            tree_mask=_masks(m.nv, lane.tree_pat, strict=False),
            ldl_mask=_masks(m.nv, lane.ldl.pat, strict=True),
            ldlh_mask=_masks(m.nv, lane.ldl_h.pat, strict=True),
            fri_dof=i32(lane.fri_dofs), fri_D=f32(fri_D), fri_b=f32(fri_b),
            lim_jnt=i32(lane.lim_jnts), lim_prm=f32(lim_prm),
            geom_bodyid=i32(m.geom_bodyid), geom_pos=f32(c.geom_pos),
            geom_quat=f32(c.geom_quat), geom_friction=f32(c.geom_friction),
            site_bodyid=i32(m.site_bodyid), site_pos=f32(c.site_pos),
            site_quat=f32(c.site_quat), sensor_type=i32(m.sensor_type),
            sensor_objid=i32(m.sensor_objid), sensor_adr=i32(m.sensor_adr),
            act_adr=i32(act_adr), act_prm=f32(act_prm),
            gainprm=f32(c.actuator_gainprm), biasprm=f32(c.actuator_biasprm),
            qpos0=f32(c.qpos0), pair_i=i32(pair_i), pair_f=f32(pair_f),
            hull_vert=f32(c.hull_vert), hull_face_n=f32(c.hull_face_n),
            efc_off=i32(efc_off), efc_col=i32([d for r in supports for d in r]),
            efc_dof_rows=i32(dof_rows), body_depth=i32(depth),
            **hfield,
        ),
    )


def efc_supports(lane: LanePhysics):
    """The dofs of each constraint row's support, as LanePhysics.make_efc
    builds its rows: one per friction dof, one per limited joint, and for
    each contact pair 4 candidates x 4 pyramid directions over the pair's
    dofs."""
    m = lane.m
    rows = [[i] for i in lane.fri_dofs] + [[int(m.jnt_dofadr[j])] for j in lane.lim_jnts]
    for dofs in lane.pair_dofs:
        rows += [list(dofs)] * 16
    return rows


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------


def _lanes(x: torch.Tensor):
    return [x[:, i] for i in range(x.shape[1])]


def _stack(lanes, like: torch.Tensor) -> torch.Tensor:
    """(B,) tiles (or python floats) -> (B, n), on `like`'s device."""
    B = like.shape[0]
    return torch.stack([torch.as_tensor(v, dtype=torch.float32, device=like.device).expand(B)
                        for v in lanes], 1)


class FusedPhysics:
    """n-substep physics step of one scene, on CUDA through the fused kernel
    and on the CPU through its plain version. ``launches`` counts kernel
    launches (``name``: the kernel's in a graph's ``launches_per_replay``)."""

    name = "fused_physics_step"

    def __init__(self, model: Model, profile: bool = False):
        self.model = model.to("cpu")
        self.profile = profile  # launch the stage-counting build (stage_cycles)
        self.lane = LanePhysics(self.model)
        self.launches = 0
        profiling.watch(self, "launches", "physics.launches")
        self._packed = None
        self._device_model = {}

    # -- outputs -----------------------------------------------------------
    def out_widths(self) -> Dict[str, int]:
        m = self.model
        return dict(qpos=m.nq, qvel=m.nv, qacc_warmstart=m.nv, sensordata=m.nsensordata,
                    actuator_force=m.nu, contact_dist=m.ncon, site_xpos=3 * m.nsite,
                    site_xmat=9 * m.nsite)

    def __call__(self, qpos, qvel, warm, ctrl, n_substeps: int,
                 dr: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """qpos (B, nq), qvel / warm (B, nv), ctrl (B, nu); dr: flat (B, rows)
        DR fields or None. Returns the flat (B, width) outputs."""
        dev = qpos.device
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"fused physics step runs on cuda or cpu tensors, not {dev}")
        with profiling.span("physics", dev):
            if dev.type == "cpu":
                return self.plain(qpos, qvel, warm, ctrl, n_substeps, dr)
            return self._launch(qpos, qvel, warm, ctrl, n_substeps, dr)

    def plain(self, qpos, qvel, warm, ctrl, n_substeps: int, dr=None):
        """The kernel's plain PyTorch version (any device; the reference)."""
        m = self.model
        dr_n = None
        if dr is not None:
            dr_n = {}
            for f in DR_FIELDS:
                dims = _DR_SHAPES[f]
                x = dr[f]
                if len(dims) == 1:
                    dr_n[f] = _lanes(x)
                else:
                    n0, n1 = getattr(m, dims[0]), dims[1]
                    dr_n[f] = [[x[:, i * n1 + j] for j in range(n1)] for i in range(n0)]
        qp, qv, w, der = self.lane.step_n(_lanes(qpos), _lanes(qvel), _lanes(ctrl),
                                          n_substeps, dr=dr_n, warm=_lanes(warm))
        out = dict(qpos=_stack(qp, qpos), qvel=_stack(qv, qpos), qacc_warmstart=_stack(w, qpos))
        for k in ("sensordata", "actuator_force", "contact_dist", "site_xpos", "site_xmat"):
            out[k] = _stack(der[k], qpos)
        return out

    # -- CUDA --------------------------------------------------------------
    def packed(self) -> dict:
        """pack_model's tables, with the env's shared-memory layout (raises
        if the model does not fit the kernel)."""
        if self._packed is None:
            packed = pack_model(self.lane)
            packed["layout"] = shared_layout(packed["sizes"])
            self._packed = packed
        return self._packed

    def _device_tables(self, device):
        key = str(device)
        if key not in self._device_model:
            packed = self.packed()
            lim = kernel_limits()
            sz = packed["sizes"]
            for name in _LIMIT_NAMES:
                if sz[name] > lim[name]:
                    raise ValueError(
                        f"model does not fit the fused kernel: {name}={sz[name]} > {lim[name]}")
            tensors = {k: torch.from_numpy(v).to(device) for k, v in packed["arrays"].items()}
            lay = packed["layout"]
            cm = _DuckModel()
            for k in _INT_SIZES[:-1]:
                setattr(cm, k, sz[k])
            cm.env_floats = lay["env_floats"]
            cm.lay[:] = lay["offsets"]
            for k, v in packed["scalars"].items():
                setattr(cm, k, v)
            for k, t in tensors.items():
                setattr(cm, k, t.data_ptr())
            sms, occ = card_occupancy(lay["env_bytes"], device, self.ceiling(), self.profile)
            self._device_model[key] = (cm, tensors, sms, occ)
        return self._device_model[key]

    def ceiling(self) -> int:
        """The LDL ceiling of the kernel instantiation this model runs."""
        return ldl_ceiling(self.model.nv)

    def stage_cycles(self) -> Dict[str, int]:
        """Clock cycles per stage, summed over warps and substeps since the
        last call (a FusedPhysics built with profile=True)."""
        buf = (ctypes.c_ulonglong * len(PROFILE_STAGES))()
        err = _library(self.profile).duck_profile(buf)
        if err != 0:
            raise RuntimeError(f"stage profile unavailable (cudaError or unprofiled build: {err})")
        return dict(zip(PROFILE_STAGES, buf))

    def geometry(self, B: int, device) -> dict:
        """The launch geometry for B envs on `device` (see launch_geometry)."""
        _, _, sms, occ = self._device_tables(device)
        return launch_geometry(B, self.packed()["layout"]["env_bytes"], sms, occ.get)

    def _launch(self, qpos, qvel, warm, ctrl, n_substeps, dr):
        m = self.model
        B = qpos.shape[0]
        if n_substeps < 1:
            raise ValueError("n_substeps must be >= 1")
        args = dict(qpos=(qpos, m.nq), qvel=(qvel, m.nv), qacc_warmstart=(warm, m.nv),
                    ctrl=(ctrl, m.nu))
        if dr is not None:
            missing = set(DR_FIELDS) - set(dr)
            if missing:
                raise ValueError(f"DR fields missing: {sorted(missing)}")
            for f in DR_FIELDS:
                args[f] = (dr[f], dr_rows(m, f))
        for name, (t, width) in args.items():
            if t.device != qpos.device:
                raise ValueError(f"{name} is on {t.device}, qpos on {qpos.device}")
            if t.dtype != torch.float32:
                raise TypeError(f"{name} must be float32, got {t.dtype}")
            if tuple(t.shape) != (B, width):
                raise ValueError(f"{name} must have shape {(B, width)}, got {tuple(t.shape)}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        lib = _library(self.profile)
        cm, _keep, _, _ = self._device_tables(qpos.device)
        geo = self.geometry(B, qpos.device)
        cdr = _DuckDR()
        if dr is not None:
            for f in DR_FIELDS:
                setattr(cdr, f, dr[f].data_ptr())
        outs = {k: torch.empty((B, n), dtype=torch.float32, device=qpos.device)
                for k, n in self.out_widths().items()}
        stream = torch.cuda.current_stream(qpos.device).cuda_stream
        err = lib.duck_physics_step(
            ctypes.byref(cm), ctypes.byref(cdr), B, n_substeps, m.nsensordata,
            qpos.data_ptr(), qvel.data_ptr(), warm.data_ptr(), ctrl.data_ptr(),
            outs["qpos"].data_ptr(), outs["qvel"].data_ptr(),
            outs["qacc_warmstart"].data_ptr(), outs["sensordata"].data_ptr(),
            outs["actuator_force"].data_ptr(), outs["contact_dist"].data_ptr(),
            outs["site_xpos"].data_ptr(), outs["site_xmat"].data_ptr(),
            geo["envs_per_block"], self.ceiling(), stream)
        if err != 0:
            raise RuntimeError(f"fused physics kernel launch failed: cudaError {err}")
        self.launches += 1
        return outs
