"""Quaternion and spatial (6D) algebra, MuJoCo conventions, batched.

Counterpart of the JAX package's ``ops/math3d.py``, function for function:

- Quaternions are (w, x, y, z), unit norm, rotating a vector from the LOCAL
  frame into the PARENT/WORLD frame: ``v_world = R(q) v_local``.
- Motion ("velocity") 6-vectors are ``(angular[3], linear[3])`` at a shared
  origin O in world orientation; force 6-vectors ``(torque[3], force[3])``.
- Free-joint qvel is 3 world-frame linear dofs followed by 3 BODY-frame
  angular dofs; quaternion integration is local: q <- q * exp(w_local*h/2).

Every function works on the last dim(s) and broadcasts over leading dims,
so a shared model constant meets a ``(B, ...)`` state directly.
"""

from __future__ import annotations

import torch

# ---------------------------------------------------------------------------
# Quaternions
# ---------------------------------------------------------------------------


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the last dim, leading dims broadcast (``jnp.cross``)."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_inv(q: torch.Tensor) -> torch.Tensor:
    """Conjugate of a unit quaternion."""
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_rot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector v by quaternion q (local -> world)."""
    qw = q[..., 0:1]
    qv = q[..., 1:4]
    # v' = v + 2*qw*(qv x v) + 2*qv x (qv x v)
    uv = cross(qv, v)
    return v + 2.0 * (qw * uv + cross(qv, uv))


def quat_rot_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector v by the inverse of q (world -> local)."""
    return quat_rot(quat_inv(q), v)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion -> 3x3 rotation matrix (columns = local axes in world)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            1.0 - 2.0 * (yy + zz),
            2.0 * (xy - wz),
            2.0 * (xz + wy),
            2.0 * (xy + wz),
            1.0 - 2.0 * (xx + zz),
            2.0 * (yz - wx),
            2.0 * (xz - wy),
            2.0 * (yz + wx),
            1.0 - 2.0 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def axis_angle_to_quat(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Unit axis (..., 3) + angle (...) -> quaternion (..., 4)."""
    s = torch.sin(angle * 0.5)[..., None]
    c = torch.cos(angle * 0.5)[..., None]
    axis_s = axis * s
    return torch.cat([c.expand(axis_s.shape[:-1] + (1,)), axis_s], dim=-1)


def quat_integrate(q: torch.Tensor, w_local: torch.Tensor, dt) -> torch.Tensor:
    """MuJoCo mju_quatIntegrate: q <- normalize(q * exp(w_local * dt / 2)),
    with the angular velocity in the LOCAL (child body) frame."""
    angle = torch.linalg.norm(w_local, dim=-1, keepdim=True)
    # safe normalize: zero velocity -> identity rotation
    axis = w_local / torch.where(angle > 1e-12, angle, torch.ones_like(angle))
    half = angle[..., 0] * dt * 0.5
    dq = torch.cat([torch.cos(half)[..., None], axis * torch.sin(half)[..., None]], dim=-1)
    out = quat_mul(q, dq)
    return out / torch.linalg.norm(out, dim=-1, keepdim=True)


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    n = torch.linalg.norm(v, dim=dim, keepdim=True)
    return v / torch.where(n > eps, n, torch.ones_like(n))


# ---------------------------------------------------------------------------
# Spatial 6D algebra: vectors are (angular[3], linear[3])
# ---------------------------------------------------------------------------


def motion_cross(vel: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Spatial cross product of motion vectors, vel x m (mju_crossMotion):
    (w1, v1) x (w2, v2) = (w1 x w2,  w1 x v2 + v1 x w2)."""
    w1, v1 = vel[..., :3], vel[..., 3:]
    w2, v2 = m[..., :3], m[..., 3:]
    return torch.cat([cross(w1, w2), cross(w1, v2) + cross(v1, w2)], dim=-1)


def force_cross(vel: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Dual spatial cross product vel x* f (mju_crossForce):
    (w, v) x* (n, f) = (w x n + v x f,  w x f)."""
    w, v = vel[..., :3], vel[..., 3:]
    n, fo = f[..., :3], f[..., 3:]
    return torch.cat([cross(w, n) + cross(v, fo), cross(w, fo)], dim=-1)


def skew(v: torch.Tensor) -> torch.Tensor:
    """3-vector -> skew-symmetric matrix [v]x such that [v]x u = v x u."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def spatial_inertia(mass: torch.Tensor, inertia_world: torch.Tensor,
                    com_offset: torch.Tensor) -> torch.Tensor:
    """6x6 spatial inertia about origin O in world orientation.

    mass (...), inertia_world (..., 3, 3) about the body's own com in world
    axes, com_offset (..., 3) from O to the body com. Returns (..., 6, 6):
        [[I_c - m [c]x[c]x ,  m [c]x ],
         [    -m [c]x      ,  m 1_3  ]]
    mapping motion (w, v_O) -> momentum (L_O, p).
    """
    c = skew(com_offset)
    eye = torch.eye(3, dtype=com_offset.dtype, device=com_offset.device)
    mm = mass[..., None, None]
    m3 = mm * eye
    top_left = inertia_world - mm * (c @ c)
    top_right = mm * c
    bottom_left = -top_right
    top = torch.cat(torch.broadcast_tensors(top_left, top_right), dim=-1)
    bottom = torch.cat(torch.broadcast_tensors(bottom_left, m3), dim=-1)
    return torch.cat([top, bottom], dim=-2)


def transform_motion(vec: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """Re-express a motion vector at a new origin O' = O + offset: the
    angular part is unchanged, the linear part gains w x offset."""
    w, v = vec[..., :3], vec[..., 3:]
    return torch.cat([w, v + cross(w, offset)], dim=-1)
