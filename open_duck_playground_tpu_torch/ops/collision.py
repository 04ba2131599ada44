"""Narrowphase collision: convex hull vs plane / heightfield / convex hull.

Counterpart of the JAX package's ``ops/collision.py``, batched over envs
(every state argument has a leading env dim, hull tables are shared). Each
geom pair always yields 4 candidate contact points; candidates that do not
exist get a large positive distance (inactive in the solver).

The plane-convex manifold selection follows MJX (deepest point, then spread
for maximal area). Heightfield-convex is a per-vertex height lookup on the
triangulated grid (MuJoCo splits each cell into two triangles).

``torch.argmax`` / ``torch.argmin`` return the first extremum, as
``jnp.argmax`` does; a selected index is read back with ``_take``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from open_duck_playground_tpu_torch.ops import lane as ln
from open_duck_playground_tpu_torch.ops.math3d import cross

BIG: float = 1e10


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, V, ...) at indices idx (B, K) along dim 1 -> (B, K, ...)."""
    i = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(idx.shape + x.shape[2:])
    return torch.gather(x, 1, i)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (B, V, 3) . b (B, 3) -> (B, V)."""
    return (a @ b[..., None])[..., 0]


def _manifold_points(poly: torch.Tensor, mask: torch.Tensor, normal: torch.Tensor,
                     support: torch.Tensor | None = None) -> torch.Tensor:
    """Choose 4 points on `poly` (B, V, 3) with ~max area among masked
    points; returns their indices (B, 4).

    When `support` (penetration depth per vertex) is given, the first point
    is the DEEPEST vertex, as MuJoCo's plane-convex collider contacts the
    deepest vertex first.
    """
    dist_mask = torch.where(mask, 0.0, -1e6)
    if support is not None:
        # deepest vertex overall: also the closest vertex when separated
        a_idx = torch.argmax(support, dim=-1)
    else:
        a_idx = torch.argmax(dist_mask, dim=-1)
    a = _take(poly, a_idx[:, None])[:, 0]
    b_idx = torch.argmax(((a[:, None] - poly) ** 2).sum(-1) + dist_mask, dim=-1)
    b = _take(poly, b_idx[:, None])[:, 0]
    ab = cross(normal, a - b)
    ap = a[:, None] - poly
    c_idx = torch.argmax(torch.abs(_dot(ap, ab)) + dist_mask, dim=-1)
    c = _take(poly, c_idx[:, None])[:, 0]
    ac = cross(normal, a - c)
    bc = cross(normal, b - c)
    bp = b[:, None] - poly
    d_idx = torch.argmax(torch.abs(_dot(bp, bc)) + torch.abs(_dot(ap, ac)) + dist_mask, dim=-1)
    return torch.stack([a_idx, b_idx, c_idx, d_idx], dim=-1)


def _dedup(idx: torch.Tensor) -> torch.Tensor:
    """valid[:, k] = idx[:, k] not seen among idx[:, :k] (suppress duplicate rows)."""
    valid = [torch.ones_like(idx[:, 0], dtype=torch.bool)]
    for k in range(1, idx.shape[1]):
        seen = (idx[:, k:k + 1] == idx[:, :k]).any(-1)
        valid.append(~seen)
    return torch.stack(valid, dim=-1)


def _make_tangents(n: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Orthonormal tangent basis for normals n (..., 3) (mju_makeFrame-style)."""
    use_y = torch.abs(n[..., 1]) < 0.9
    ref = torch.stack([torch.zeros_like(n[..., 0]), use_y.to(n.dtype), (~use_y).to(n.dtype)], -1)
    t1 = cross(ref, n)
    t1 = t1 / torch.clamp(torch.linalg.norm(t1, dim=-1, keepdim=True), min=1e-12)
    t2 = cross(n, t1)
    return t1, t2


def _world(pos: torch.Tensor, mat: torch.Tensor, verts: torch.Tensor) -> torch.Tensor:
    """Geom-frame vertices (V, 3) at the geom poses pos (B, 3), mat (B, 3, 3)."""
    return pos[:, None] + verts @ mat.transpose(-1, -2)


def _first_valid(valid: torch.Tensor) -> torch.Tensor:
    # the first candidate always reports the true min distance (for queries)
    valid = valid.clone()
    valid[:, 0] = True
    return valid


def plane_hull(plane_pos, plane_mat, hull_pos, hull_mat, verts):
    """Plane vs convex hull (geom-frame vertices `verts` (V, 3)).

    Returns dist (B,4), pos (B,4,3), frame (B,3,3) [rows normal,t1,t2],
    valid (B,4). The normal points from the plane into the hull (up).
    """
    n = plane_mat[..., :, 2]
    w = _world(hull_pos, hull_mat, verts)  # (B, V, 3) world
    support = _dot(plane_pos[:, None] - w, n)  # depth below plane (positive = penetrating)
    # candidate band: within 1mm of the deepest vertex (MJX plane_convex)
    mask = support > torch.clamp(support.amax(-1, keepdim=True) - 1e-3, min=0.0)
    idx = _manifold_points(w, mask, n, support)
    valid = _first_valid(_dedup(idx) & torch.gather(mask, 1, idx))
    dist = -torch.gather(support, 1, idx)
    pos = _take(w, idx) - 0.5 * dist[..., None] * n[:, None, :]
    t1, t2 = _make_tangents(n)
    frame = torch.stack([n, t1, t2], dim=-2)
    dist = torch.where(valid, dist, BIG)
    return dist, pos, frame, valid


def hfield_height_normal(hdata: torch.Tensor, hsize: torch.Tensor, xy: torch.Tensor):
    """Piecewise-linear surface height and normal at local xy (..., 2).

    MuJoCo triangulates each grid cell into two triangles; row index maps to
    y, column index to x, data row 0 at -ry.
    """
    nrow, ncol = hdata.shape
    rx, ry, ztop = hsize[0], hsize[1], hsize[2]
    gx = (xy[..., 0] + rx) / (2 * rx) * (ncol - 1)
    gy = (xy[..., 1] + ry) / (2 * ry) * (nrow - 1)
    gx = torch.clamp(gx, 0.0, ncol - 1.001)
    gy = torch.clamp(gy, 0.0, nrow - 1.001)
    ix = torch.floor(gx).to(torch.int64)
    iy = torch.floor(gy).to(torch.int64)
    fx = gx - ix
    fy = gy - iy
    z00 = hdata[iy, ix] * ztop
    z10 = hdata[iy, ix + 1] * ztop
    z01 = hdata[iy + 1, ix] * ztop
    z11 = hdata[iy + 1, ix + 1] * ztop
    dx = ln.div(2 * rx, ncol - 1)
    dy = ln.div(2 * ry, nrow - 1)
    lower = fx + fy < 1.0
    # lower triangle (00, 10, 01): z = z00 + fx (z10-z00) + fy (z01-z00)
    z_lo = z00 + fx * (z10 - z00) + fy * (z01 - z00)
    gx_lo = (z10 - z00) / dx
    gy_lo = (z01 - z00) / dy
    # upper triangle (11, 10, 01): z = z11 + (1-fx)(z01-z11) + (1-fy)(z10-z11)
    z_hi = z11 + (1 - fx) * (z01 - z11) + (1 - fy) * (z10 - z11)
    gx_hi = (z11 - z01) / dx
    gy_hi = (z11 - z10) / dy
    z = torch.where(lower, z_lo, z_hi)
    gxs = torch.where(lower, gx_lo, gx_hi)
    gys = torch.where(lower, gy_lo, gy_hi)
    nvec = torch.stack([-gxs, -gys, torch.ones_like(gxs)], dim=-1)
    nvec = nvec / torch.linalg.norm(nvec, dim=-1, keepdim=True)
    return z, nvec


def hfield_hull(hf_pos, hf_mat, hdata, hsize, hull_pos, hull_mat, verts):
    """Heightfield vs convex hull: per-vertex surface test, 4-point manifold."""
    w = _world(hull_pos, hull_mat, verts)  # world
    local = (w - hf_pos[:, None]) @ hf_mat  # hfield frame
    z_surf, n_local = hfield_height_normal(hdata, hsize, local[..., :2])
    # signed distance along the surface normal (approx: vertical gap projected)
    gap = (local[..., 2] - z_surf) * n_local[..., 2]
    support = -gap
    # candidate band near the deepest vertex (see plane_hull)
    mask = support > torch.clamp(support.amax(-1, keepdim=True) - 1e-3, min=0.0)
    idx = _manifold_points(w, mask, hf_mat[..., :, 2], support)
    valid = _first_valid(_dedup(idx) & torch.gather(mask, 1, idx))
    dist = -torch.gather(support, 1, idx)
    n_world = _take(n_local, idx) @ hf_mat.transpose(-1, -2)
    # single shared frame from the deepest point's normal
    n0 = n_world[:, 0]
    n0 = n0 / torch.clamp(torch.linalg.norm(n0, dim=-1, keepdim=True), min=1e-12)
    t1, t2 = _make_tangents(n0)
    frame = torch.stack([n0, t1, t2], dim=-2)
    pos = _take(w, idx) - 0.5 * dist[..., None] * n0[:, None, :]
    dist = torch.where(valid, dist, BIG)
    return dist, pos, frame, valid


def hull_hull(pos1, mat1, verts1, face_n1, face_d1, pos2, mat2, verts2, face_n2, face_d2):
    """Convex-convex via face-normal SAT (approximate: no edge-edge axes).

    Face normals (F, 3) and plane offsets (F,) are in each geom's frame.
    Returns the same 4-candidate layout as the other colliders.
    """
    w1 = _world(pos1, mat1, verts1)
    w2 = _world(pos2, mat2, verts2)
    n1w = face_n1 @ mat1.transpose(-1, -2)  # world face normals of hull 1
    n2w = face_n2 @ mat2.transpose(-1, -2)

    axes = torch.cat([n1w, n2w], dim=1)  # (B, A, 3)
    p1 = w1 @ axes.transpose(-1, -2)  # (B, V1, A)
    p2 = w2 @ axes.transpose(-1, -2)
    # depth along axis a (pointing from 1 into 2): overlap = max1 - min2
    depth_f = p1.amax(1) - p2.amin(1)
    depth_b = p2.amax(1) - p1.amin(1)
    depth = torch.minimum(depth_f, depth_b)
    best = torch.argmin(depth, dim=-1)[:, None]
    d = torch.gather(depth, 1, best)[:, 0]
    axis = _take(axes, best)[:, 0]
    flip = torch.gather(depth_f, 1, best) <= torch.gather(depth_b, 1, best)
    axis = torch.where(flip, axis, -axis)  # 1 -> 2
    # contact points: vertices of hull2 deepest along -axis
    support2 = -_dot(w2, axis)  # larger = deeper into hull 1
    thresh = support2.amax(-1, keepdim=True) - 1e-4
    mask = (support2 >= thresh) & (d[:, None] > 0)
    idx = _manifold_points(w2, mask, axis)
    valid = _first_valid(_dedup(idx) & torch.gather(mask, 1, idx))
    dist = torch.where(valid & (d[:, None] > 0), -d[:, None], BIG)
    t1, t2 = _make_tangents(axis)
    frame = torch.stack([axis, t1, t2], dim=-2)
    pos = _take(w2, idx) + 0.5 * d[:, None, None] * axis[:, None, :]
    return dist, pos, frame, valid
