"""Tile primitives of the physics step, on ``(B,)`` torch tensors.

Counterpart of ``open_duck_playground_tpu/ops/lane.py`` (the heightfield
gather in its "direct" mode only). A "tile" is
one scalar per environment: a ``(B,)`` tensor, or a python float for a
model constant (it broadcasts for free). Geometric objects are plain python
lists of tiles:

    vec3  = [x, y, z]
    quat  = [w, x, y, z]
    mat3  = [m00, m01, m02, m10, ..., m22]        (row major)
    vec6  = [wx, wy, wz, vx, vy, vz]              (spatial motion/force)
    sym6  = 21 entries, lower triangle row major:
            [(0,0),(1,0),(1,1),(2,0),(2,1),(2,2),(3,0)...(5,5)]

``maximum`` and ``minimum`` take tiles or python floats, like their
``jax.numpy`` namesakes, so ``lane_physics`` reads as the JAX package's
straight-line program with ``torch`` in place of ``jax.numpy``. The CUDA kernel
(``csrc/physics_step.cu``) computes the same program with one thread per
env.
"""

from __future__ import annotations

import torch


def _is_t(x) -> bool:
    return isinstance(x, torch.Tensor)


def maximum(a, b):
    if _is_t(a) and _is_t(b):
        return torch.maximum(a, b)
    if _is_t(a):
        return torch.clamp(a, min=b)
    if _is_t(b):
        return torch.clamp(b, min=a)
    return max(a, b)


def minimum(a, b):
    if _is_t(a) and _is_t(b):
        return torch.minimum(a, b)
    if _is_t(a):
        return torch.clamp(a, max=b)
    if _is_t(b):
        return torch.clamp(b, max=a)
    return min(a, b)


def div(a, c: float):
    """a / c for a model constant c, rounded to float32 and divided by, as
    jax.numpy and the CUDA kernel divide, on every device: torch divides a
    CUDA tensor by a python number as a multiplication by its reciprocal,
    which can differ in the last bit (and move a heightfield vertex to
    another cell)."""
    if _is_t(a):
        return a / torch.full((), c, dtype=a.dtype, device=a.device)
    return a / c


# ---------------------------------------------------------------------------
# vec3
# ---------------------------------------------------------------------------


def v3_add(a, b):
    return [a[0] + b[0], a[1] + b[1], a[2] + b[2]]


def v3_sub(a, b):
    return [a[0] - b[0], a[1] - b[1], a[2] - b[2]]


def v3_scale(a, s):
    return [a[0] * s, a[1] * s, a[2] * s]


def v3_dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def v3_cross(a, b):
    return [
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ]


# ---------------------------------------------------------------------------
# quaternion (w, x, y, z); conventions of ops/math3d.py
# ---------------------------------------------------------------------------


def q_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return [
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ]


def q_rot(q, v):
    """Rotate vec3 v by quaternion q (local -> world)."""
    qw = q[0]
    qv = q[1:4]
    uv = v3_cross(qv, v)
    t = v3_add(v3_scale(uv, qw), v3_cross(qv, uv))
    return v3_add(v, v3_scale(t, 2.0))


def q_normalize(q):
    n2 = q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]
    inv = 1.0 / torch.sqrt(n2)
    return [q[0] * inv, q[1] * inv, q[2] * inv, q[3] * inv]


def q_to_mat(q):
    """Quaternion -> mat3 (row major, columns = local axes in world)."""
    w, x, y, z = q
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return [
        1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
        2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
        2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
    ]


def axis_angle_q(axis_const, angle):
    """Constant unit axis (python floats) + per-lane angle -> quat."""
    s = torch.sin(angle * 0.5)
    c = torch.cos(angle * 0.5)
    return [c, axis_const[0] * s, axis_const[1] * s, axis_const[2] * s]


def q_integrate(q, w_local, dt):
    """mju_quatIntegrate: q <- normalize(q * exp(w_local dt / 2))."""
    n2 = v3_dot(w_local, w_local)
    angle = torch.sqrt(n2)
    safe = torch.where(angle > 1e-12, angle, 1.0)
    half = angle * (dt * 0.5)
    s = torch.sin(half) / safe
    dq = [torch.cos(half), w_local[0] * s, w_local[1] * s, w_local[2] * s]
    return q_normalize(q_mul(q, dq))


# ---------------------------------------------------------------------------
# mat3 (row-major list of 9)
# ---------------------------------------------------------------------------


def m3_vec(m, v):
    """Matrix * vector."""
    return [
        m[0] * v[0] + m[1] * v[1] + m[2] * v[2],
        m[3] * v[0] + m[4] * v[1] + m[5] * v[2],
        m[6] * v[0] + m[7] * v[1] + m[8] * v[2],
    ]


def m3_t_vec(m, v):
    """Matrix^T * vector."""
    return [
        m[0] * v[0] + m[3] * v[1] + m[6] * v[2],
        m[1] * v[0] + m[4] * v[1] + m[7] * v[2],
        m[2] * v[0] + m[5] * v[1] + m[8] * v[2],
    ]


def m3_col(m, j):
    return [m[j], m[3 + j], m[6 + j]]


# ---------------------------------------------------------------------------
# spatial 6-vectors (angular[3], linear[3])
# ---------------------------------------------------------------------------


def v6_add(a, b):
    return [a[i] + b[i] for i in range(6)]


def v6_scale(a, s):
    return [a[i] * s for i in range(6)]


def v6_dot(a, b):
    return sum(a[i] * b[i] for i in range(6))


def motion_cross(vel, m):
    """(w1,v1) x (w2,v2) = (w1 x w2, w1 x v2 + v1 x w2)."""
    w1, v1 = vel[:3], vel[3:]
    w2, v2 = m[:3], m[3:]
    return v3_cross(w1, w2) + v3_add(v3_cross(w1, v2), v3_cross(v1, w2))


def force_cross(vel, f):
    """(w,v) x* (n,f) = (w x n + v x f, w x f)."""
    w, v = vel[:3], vel[3:]
    n, fo = f[:3], f[3:]
    return v3_add(v3_cross(w, n), v3_cross(v, fo)) + v3_cross(w, fo)


# ---------------------------------------------------------------------------
# sym6: symmetric 6x6 as 21 lower-triangle entries (row major)
# ---------------------------------------------------------------------------

_SYM6_IDX = {}
for _i in range(6):
    for _j in range(_i + 1):
        _SYM6_IDX[(_i, _j)] = len(_SYM6_IDX)


def sym6_get(s, i, j):
    return s[_SYM6_IDX[(i, j)]] if i >= j else s[_SYM6_IDX[(j, i)]]


def sym6_add(a, b):
    return [a[k] + b[k] for k in range(21)]


def sym6_vec(s, v):
    """Symmetric 6x6 times 6-vector."""
    return [
        sum(sym6_get(s, i, j) * v[j] for j in range(6))
        for i in range(6)
    ]


def spatial_inertia_sym(mass, inertia_world_m3, c):
    """sym6 spatial inertia about origin O (see math3d.spatial_inertia).

    mass: tile (or float); inertia_world_m3: mat3 (list of 9, symmetric);
    c: vec3 from O to body com (world).

    [[I_c - m [c]x[c]x ,  m [c]x ],
     [    -m [c]x      ,  m 1_3  ]]
    Note the 6x6 is symmetric: (m [c]x)^T = -m [c]x = bottom-left.
    """
    cx, cy, cz = c
    # -[c]x[c]x = diag(cy^2+cz^2, cx^2+cz^2, cx^2+cy^2) - off diag terms
    xx = mass * (cy * cy + cz * cz)
    yy = mass * (cx * cx + cz * cz)
    zz = mass * (cx * cx + cy * cy)
    xy = -mass * (cx * cy)
    xz = -mass * (cx * cz)
    yz = -mass * (cy * cz)
    I = inertia_world_m3
    out = [None] * 21
    # top-left block (rows 0..2)
    out[_SYM6_IDX[(0, 0)]] = I[0] + xx
    out[_SYM6_IDX[(1, 0)]] = I[3] + xy
    out[_SYM6_IDX[(1, 1)]] = I[4] + yy
    out[_SYM6_IDX[(2, 0)]] = I[6] + xz
    out[_SYM6_IDX[(2, 1)]] = I[7] + yz
    out[_SYM6_IDX[(2, 2)]] = I[8] + zz
    # bottom-left block (rows 3..5, cols 0..2): m [c]x^T = -m [c]x
    # [c]x = [[0,-cz,cy],[cz,0,-cx],[-cy,cx,0]]; block(i,j) = (m [c]x)^T_{ij}
    # = m [c]x_{ji}
    zero = mass * 0.0
    mcx = mass * cx
    mcy = mass * cy
    mcz = mass * cz
    out[_SYM6_IDX[(3, 0)]] = zero
    out[_SYM6_IDX[(3, 1)]] = mcz
    out[_SYM6_IDX[(3, 2)]] = -mcy
    out[_SYM6_IDX[(4, 0)]] = -mcz
    out[_SYM6_IDX[(4, 1)]] = zero
    out[_SYM6_IDX[(4, 2)]] = mcx
    out[_SYM6_IDX[(5, 0)]] = mcy
    out[_SYM6_IDX[(5, 1)]] = -mcx
    out[_SYM6_IDX[(5, 2)]] = zero
    # bottom-right block: m I_3
    out[_SYM6_IDX[(3, 3)]] = mass * 1.0
    out[_SYM6_IDX[(4, 3)]] = zero
    out[_SYM6_IDX[(4, 4)]] = mass * 1.0
    out[_SYM6_IDX[(5, 3)]] = zero
    out[_SYM6_IDX[(5, 4)]] = zero
    out[_SYM6_IDX[(5, 5)]] = mass * 1.0
    return out


def rotate_inertia(diag_inertia, ximat):
    """R diag(I) R^T as mat3 (list of 9) from principal moments + rotation."""
    ix, iy, iz = diag_inertia
    R = ximat
    out = []
    for r in range(3):
        for c in range(3):
            out.append(
                R[3 * r + 0] * ix * R[3 * c + 0]
                + R[3 * r + 1] * iy * R[3 * c + 1]
                + R[3 * r + 2] * iz * R[3 * c + 2]
            )
    return out


# ---------------------------------------------------------------------------
# heightfield table gather
# ---------------------------------------------------------------------------


def hf_bilinear_gather(H, iy, ix):
    """The 4 cell-corner heights H[iy, ix], H[iy, ix+1], H[iy+1, ix],
    H[iy+1, ix+1] of integer tiles (iy, ix), from the (nrow, ncol) table H
    on the tiles' device, by indexed loads (the JAX package's "direct"
    mode; its "onehot" mode is a matmul because Mosaic has no vector
    gather). The indices are clamped to the table: a no-op for the cells
    of finite coordinates, which _hf_indices keeps within [0, n-2]; a NaN
    coordinate then reads some cell and stays NaN through its fraction."""
    nrow, ncol = H.shape
    iy = iy.long().clamp(0, nrow - 2)
    ix = ix.long().clamp(0, ncol - 2)
    return H[iy, ix], H[iy, ix + 1], H[iy + 1, ix], H[iy + 1, ix + 1]


def hf_window_corners(H, iys, ixs):
    """Bilinear corners for the V vertices of a hull: length-V lists of
    integer tiles -> length-V list of (z00, z10, z01, z11) tuples."""
    return [hf_bilinear_gather(H, iy, ix) for iy, ix in zip(iys, ixs)]
