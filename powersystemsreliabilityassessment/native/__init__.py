"""Native (C++) components, loaded via ctypes.

``native.box_lp``: the float64 CPU reference interior-point LP solver
(native/box_lp_ipm.cpp) — the verification oracle for the batched f32
device solver. Built on demand with g++ and cached next to the source.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "box_lp_ipm.cpp")
_SO = os.path.join(_REPO_ROOT, "native", "libboxlp.so")

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if (not os.path.exists(_SO)
            or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-o", _SO, _SRC], check=True)
    lib = ctypes.CDLL(_SO)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.solve_box_lp_f64.restype = ctypes.c_int
    lib.solve_box_lp_f64.argtypes = [dp, dp, dp, dp, dp,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_double, dp, dp]
    _lib = lib
    return lib


def solve_box_lp_f64(c, A, b, l, u, max_iters: int = 100,
                     tol: float = 1e-9):
    """Solve min c'x s.t. Ax=b, l<=x<=u in float64. Returns (x, obj)."""
    lib = _load()
    c = np.ascontiguousarray(c, np.float64)
    A = np.ascontiguousarray(A, np.float64)
    b = np.ascontiguousarray(b, np.float64)
    l = np.ascontiguousarray(l, np.float64)
    u = np.ascontiguousarray(u, np.float64)
    m, n = A.shape
    x = np.zeros(n)
    obj = ctypes.c_double()
    dp = ctypes.POINTER(ctypes.c_double)

    def p(a):
        return a.ctypes.data_as(dp)

    status = lib.solve_box_lp_f64(p(c), p(A), p(b), p(l), p(u), m, n,
                                  max_iters, tol, p(x), ctypes.byref(obj))
    if status == 2:
        raise RuntimeError("native LP: factorization failure")
    return x, float(obj.value)
