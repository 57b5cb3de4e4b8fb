"""ctypes loader for the native C++ core (``native/celerite_core.cpp``).

The port's own copy of ``celerite_tpu/native.py``.  The shared library is
compiled on demand with g++ from the repository's ``native/celerite_core.cpp``
(a flat C ABI, no JAX and no PyTorch), cached by source hash under
``build/native/`` beside the package, and loaded with ctypes.
``available()`` is False when no toolchain is present.

The native path is an eager host solver for small N: ``CholeskySolver``
takes it on the CPU below 4096 points, and anywhere with ``method="native"``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["available", "NativeSolver", "loglike", "factor", "matmul"]

_ROOT = Path(__file__).resolve().parent.parent
_SRC = _ROOT / "native" / "celerite_core.cpp"
_BUILD_DIR = _ROOT / "build" / "native"

_lib = None
_tried = False


def _compile_and_load():
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so_path = _BUILD_DIR / "celerite_core_{0}.so".format(digest)
    if not so_path.exists():
        tmp = so_path.with_suffix(".{0}.tmp".format(os.getpid()))
        cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared",
               "-fPIC", "-o", str(tmp), str(_SRC)]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(str(so_path))

    i64 = ctypes.c_int64
    dptr = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.ct_factor.restype = ctypes.c_int
    lib.ct_factor.argtypes = [i64, i64, dptr, dptr, dptr, dptr, dptr, dptr,
                              ctypes.POINTER(i64)]
    lib.ct_loglike.restype = ctypes.c_int
    lib.ct_loglike.argtypes = [i64, i64, dptr, dptr, dptr, dptr, dptr, dptr]
    for name in ("ct_solve", "ct_dot_l", "ct_matmul"):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [i64, i64, dptr, dptr, dptr, dptr, dptr, dptr]
    lib.ct_abi_version.restype = ctypes.c_int
    if lib.ct_abi_version() != 1:
        raise RuntimeError("native core ABI version mismatch")
    return lib


def _get_lib():
    global _lib, _tried
    if _lib is None and not _tried:
        _tried = True
        try:
            _lib = _compile_and_load()
        except (OSError, RuntimeError, subprocess.CalledProcessError):
            _lib = None
    return _lib


def available():
    """Whether the native core compiled and loaded."""
    return _get_lib() is not None


def _as_c(x):
    return np.ascontiguousarray(np.asarray(x, dtype=np.float64))


def factor(U, V, phi, A):
    """Native factor; returns (D, W, ok)."""
    lib = _get_lib()
    U, V, phi, A = map(_as_c, (U, V, phi, A))
    n, p = U.shape
    D = np.empty(n)
    W = np.empty((n, p))
    bad = ctypes.c_int64(-1)
    rc = lib.ct_factor(n, p, U, V, phi, A, D, W, ctypes.byref(bad))
    return D, W, rc == 0


def matmul(U, V, phi, A, z):
    """Native K @ z (single column) without factorizing."""
    lib = _get_lib()
    U, V, phi, A, z = map(_as_c, (U, V, phi, A, z))
    n, p = U.shape
    y = np.empty_like(z)
    lib.ct_matmul(n, p, U, V, phi, A, z, y)
    return y


def loglike(U, V, phi, A, y):
    """Native fused GP log-likelihood; returns (ll, ok)."""
    lib = _get_lib()
    U, V, phi, A, y = map(_as_c, (U, V, phi, A, y))
    n, p = U.shape
    out = np.empty(2)
    rc = lib.ct_loglike(n, p, U, V, phi, A, y, out)
    if rc != 0:
        return -np.inf, False
    ll = -0.5 * (out[0] + out[1] + n * np.log(2.0 * np.pi))
    return float(ll), bool(np.isfinite(ll))


class NativeSolver:
    """Eager host solver over pre-lowered (U, V, phi, A) arrays.

    Pass precomputed ``D``/``W`` (e.g. from a pickled factor state) to
    skip re-factorization.
    """

    def __init__(self, U, V, phi, A, D=None, W=None):
        self.U, self.V, self.phi, self.A = map(_as_c, (U, V, phi, A))
        if D is not None:
            self.D, self.W, self.ok = _as_c(D), _as_c(W), True
        else:
            self.D, self.W, self.ok = factor(self.U, self.V, self.phi,
                                             self.A)

    @property
    def log_determinant(self):
        return float(np.sum(np.log(self.D)))

    def _apply(self, name, x, *arrays):
        x = _as_c(x)
        out = np.empty_like(x)
        n, p = self.U.shape
        getattr(_get_lib(), name)(n, p, *arrays, x, out)
        return out

    def solve(self, y):
        return self._apply("ct_solve", y, self.U, self.phi, self.W, self.D)

    def dot_L(self, z):
        return self._apply("ct_dot_l", z, self.U, self.phi, self.W, self.D)

    def matmul(self, z):
        return self._apply("ct_matmul", z, self.U, self.V, self.phi, self.A)
