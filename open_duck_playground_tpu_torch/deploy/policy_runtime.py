"""ctypes bindings for the native C++ policy runtime (deploy/cpp).

`CppOnnxPolicy` mirrors the OnnxInfer interface; `build()` compiles the
shared library with the system toolchain on first use, into
``build/duck_policy/`` of the checkout (or the directory given).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_CPP_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cpp")
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "duck_policy")


def build(force: bool = False, out_dir: Optional[str] = None) -> str:
    """Path of libduck_policy.so in `out_dir` (default BUILD_DIR), built
    there with make if absent (or `force`)."""
    out_dir = os.path.abspath(out_dir or BUILD_DIR)
    lib_path = os.path.join(out_dir, "libduck_policy.so")
    if force or not os.path.exists(lib_path):
        subprocess.run(["make", "-B" if force else "-s", "-C", _CPP_DIR, f"OUT={out_dir}"],
                       check=True, capture_output=True)
    return lib_path


class CppOnnxPolicy:
    def __init__(self, onnx_model_path: str, lib_path: Optional[str] = None):
        lib = ctypes.CDLL(lib_path or build())
        lib.duck_policy_load.restype = ctypes.c_void_p
        lib.duck_policy_load.argtypes = [ctypes.c_char_p]
        lib.duck_policy_obs_size.restype = ctypes.c_int
        lib.duck_policy_obs_size.argtypes = [ctypes.c_void_p]
        lib.duck_policy_act_size.restype = ctypes.c_int
        lib.duck_policy_act_size.argtypes = [ctypes.c_void_p]
        lib.duck_policy_infer.restype = ctypes.c_int
        lib.duck_policy_infer.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
        ]
        lib.duck_policy_free.restype = None
        lib.duck_policy_free.argtypes = [ctypes.c_void_p]
        self._lib = lib
        self._h = lib.duck_policy_load(onnx_model_path.encode())
        if not self._h:
            raise RuntimeError(f"failed to load {onnx_model_path}")
        self.obs_size = lib.duck_policy_obs_size(self._h)
        self.act_size = lib.duck_policy_act_size(self._h)

    def infer(self, obs: np.ndarray) -> np.ndarray:
        obs = np.ascontiguousarray(obs, np.float32).ravel()
        out = np.zeros(self.act_size, np.float32)
        rc = self._lib.duck_policy_infer(
            self._h,
            obs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            obs.size,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out.size,
        )
        if rc != 0:
            raise RuntimeError(f"duck_policy_infer failed with code {rc}")
        return out

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.duck_policy_free(self._h)
            self._h = None

    def __del__(self):
        self.close()
