"""Minimal STL mesh loader (binary + ASCII) and convex hull extraction.

Replaces MuJoCo's mesh asset pipeline for collision purposes: we only need
the convex hull vertices of collision meshes (reference geoms
`left/right_foot_bottom_tpu`, open_duck_mini_v2.xml:203-205,408-410).
"""

from __future__ import annotations

import struct

import numpy as np


def load_stl(path_or_bytes) -> np.ndarray:
    """Load an STL file, returning deduplicated vertices (V, 3) float64."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        raw = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            raw = f.read()

    if _is_ascii_stl(raw):
        verts = _parse_ascii(raw)
    else:
        verts = _parse_binary(raw)

    # Deduplicate exact-duplicate vertices (triangle soup -> vertex set).
    verts = np.unique(verts.round(decimals=9), axis=0)
    return verts


def _is_ascii_stl(raw: bytes) -> bool:
    head = raw[:512].lower()
    return head.lstrip().startswith(b"solid") and b"facet" in head


def _parse_binary(raw: bytes) -> np.ndarray:
    ntri = struct.unpack("<I", raw[80:84])[0]
    expected = 84 + ntri * 50
    if len(raw) < expected:
        raise ValueError(f"binary STL truncated: {len(raw)} < {expected}")
    body = np.frombuffer(raw[84:expected], dtype=np.uint8).reshape(ntri, 50)
    tri = body[:, :48].copy().view(np.float32).reshape(ntri, 4, 3)
    return tri[:, 1:4, :].reshape(-1, 3).astype(np.float64)


def _parse_ascii(raw: bytes) -> np.ndarray:
    verts = []
    for line in raw.decode("ascii", errors="ignore").splitlines():
        line = line.strip()
        if line.startswith("vertex"):
            parts = line.split()
            verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
    return np.asarray(verts, dtype=np.float64)


def convex_hull(verts: np.ndarray) -> np.ndarray:
    """Vertices of the convex hull of a point set, (H, 3) float64.

    Falls back to the input set if scipy is unavailable or the hull is
    degenerate (the duck foot sole is a proper 3D solid, so the fast path
    always applies in practice).
    """
    try:
        from scipy.spatial import ConvexHull  # noqa: PLC0415

        hull = ConvexHull(verts)
        return verts[hull.vertices]
    except Exception:
        return verts
