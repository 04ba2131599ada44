"""Hashable wrapper for static (non-traced) numpy metadata in pytree aux data.

Model structure arrays (parent ids, joint types, addresses, ...) drive Python
loop unrolling at trace time, so they must live in pytree aux data. JAX
requires aux data to be hashable and equality-comparable for jit caching;
raw numpy arrays are neither, hence this wrapper.
"""

from __future__ import annotations

import numpy as np


class StaticArray:
    """Immutable, hashable numpy array for use as jit-static metadata."""

    __slots__ = ("_a", "_hash")

    def __init__(self, arr):
        a = np.asarray(arr)
        a.setflags(write=False)
        self._a = a
        self._hash = hash((a.shape, a.dtype.str, a.tobytes()))

    @property
    def np(self) -> np.ndarray:
        return self._a

    # --- ndarray delegation (read-only) ---
    def __getitem__(self, idx):
        out = self._a[idx]
        return out

    def __len__(self):
        return len(self._a)

    def __iter__(self):
        return iter(self._a)

    def __array__(self, dtype=None):
        return self._a if dtype is None else self._a.astype(dtype)

    @property
    def shape(self):
        return self._a.shape

    @property
    def dtype(self):
        return self._a.dtype

    def tolist(self):
        return self._a.tolist()

    # --- hashability ---
    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        if isinstance(other, StaticArray):
            return self._a.shape == other._a.shape and np.array_equal(self._a, other._a)
        return NotImplemented

    def __repr__(self):
        return f"StaticArray({self._a!r})"


def sarr(arr, dtype=None) -> StaticArray:
    a = np.asarray(arr)
    if dtype is not None:
        a = a.astype(dtype)
    return StaticArray(a)
