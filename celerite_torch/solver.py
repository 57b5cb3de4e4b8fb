"""Stateful solver facade with reference-parity semantics.

Port of ``celerite_tpu/solver.py:41-593``, the reference's pybind11 module
``celerite.solver``: ``CholeskySolver`` with ``compute / solve / dot_solve
/ dot_L / dot / predict / log_determinant / computed /
grad_log_likelihood`` and pickling, the free functions
``get_kernel_value``, ``get_psd_value``, ``check_coefficients``,
``has_autodiff`` and ``get_library_version``, and ``LinAlgError``; it
re-exports ``ops.carma.CARMASolver`` as the JAX package's does.

The class adds state, numpy conversion, dimension checks and exceptions
to the pure ops: ``ops.seq`` (``method="scan"``), ``ops.blocked``
(``"blocked"``; on the card its factor runs the three-pass kernels) and the
native host core (``"native"``, :mod:`celerite_torch.native`).  Routing of
``"auto"``: on the CPU the JAX package's rule (solver.py:136-166), the
native core below 4096 points when g++ is there, ``scan`` below 16384,
``blocked`` above; on the card ``blocked`` at every N.  ``"native"`` runs
only when asked for (on the host, whatever the device) and raises without
g++.  The solver computes on ``cuda`` unless made with ``device="cpu"``,
and raises when CUDA is missing.

General semiseparable blocks ``(A, U, V)`` (``A`` (N,), ``U`` and ``V``
(J_general, N)) lower with the kernel's terms on every route
(``ops.lower``: phi = 1 columns after the complex pairs, ``A`` on the
diagonal), with the JAX package's shape checks (solver.py:248-256).
"""

from __future__ import annotations

import numpy as np
import torch

from . import native
from .ops import blocked, kernels, lanes4, seq
from .ops.carma import CARMASolver  # noqa: F401  (parity re-export)
from .ops.lower import SSM, Coefficients, lower
from .ops.poly import check_coefficients as _check_coefficients

__all__ = ["CholeskySolver", "CARMASolver", "LinAlgError", "get_kernel_value",
           "get_psd_value", "check_coefficients", "has_autodiff",
           "get_library_version"]

__library_version__ = "0.1.0"

# Routing of method="auto" on the CPU (celerite_tpu/solver.py:136-166).
_NATIVE_BELOW = 4096
_SCAN_BELOW = 16384
_OPS = {"scan": seq, "blocked": blocked}


class LinAlgError(Exception):
    """Raised when the Cholesky-like factorization hits a negative pivot
    (the reference's ``celerite.solver.LinAlgError``, solver.cpp:87)."""


def _not_in_slice(what, item):
    return NotImplementedError(
        "{0}: not ported yet (ROADMAP {1})".format(what, item)
    )


def has_autodiff():
    """Gradients are always available (torch.autograd); parity shim."""
    return True


def get_library_version():
    return __library_version__


def _tensors(*xs):
    return [torch.as_tensor(np.asarray(x, dtype=float)) for x in xs]


def get_kernel_value(a_real, c_real, a_comp, b_comp, c_comp, d_comp, tau):
    return kernels.kernel_value(*_tensors(a_real, c_real, a_comp, b_comp,
                                          c_comp, d_comp, tau)).numpy()


def get_psd_value(a_real, c_real, a_comp, b_comp, c_comp, d_comp, omega):
    return kernels.psd_value(*_tensors(a_real, c_real, a_comp, b_comp,
                                       c_comp, d_comp, omega)).numpy()


def check_coefficients(*args):
    return _check_coefficients(*args)


def _coefficients(jitter, a_real, c_real, a_comp, b_comp, c_comp, d_comp):
    """Validated numpy coefficient blocks."""
    a_real, c_real, a_comp, b_comp, c_comp, d_comp = (
        np.array(np.atleast_1d(v), dtype=float)
        for v in (a_real, c_real, a_comp, b_comp, c_comp, d_comp))
    if a_real.shape != c_real.shape:
        raise ValueError("dimension mismatch")
    if not a_comp.shape == b_comp.shape == c_comp.shape == d_comp.shape:
        raise ValueError("dimension mismatch")
    return Coefficients(a_real, c_real, a_comp, b_comp, c_comp, d_comp,
                        float(np.asarray(jitter)))


def _general(A, U, V, n):
    """The general blocks as float64 numpy ``dict(A_gen, U_gen, V_gen)``
    for :func:`lower`, empty without them; the JAX package's checks
    against ``n`` points (solver.py:248-256) raise ValueError."""
    A = np.empty(0) if A is None else np.atleast_1d(np.asarray(A, float))
    U = np.empty((0, 0)) if U is None else np.atleast_2d(np.asarray(U, float))
    V = np.empty((0, 0)) if V is None else np.atleast_2d(np.asarray(V, float))
    has_general = A.shape[0] != 0
    if has_general and A.shape[0] != n:
        raise ValueError("dimension mismatch")
    if has_general and (U.shape[1] != n or V.shape[1] != n):
        raise ValueError("dimension mismatch")
    if U.shape[0] != V.shape[0]:
        raise ValueError("dimension mismatch")
    return dict(A_gen=A, U_gen=U, V_gen=V) if has_general else {}


def _lower(coeffs, t, diag, device, general):
    """The float64 SSM of numpy coefficients and general blocks on
    ``device``."""
    def dev(x):
        return torch.as_tensor(x, dtype=torch.float64, device=device)

    return lower(Coefficients(*map(dev, coeffs)), dev(t), dev(diag),
                 **{k: dev(x) for k, x in general.items()})


class CholeskySolver:
    """Stateful O(N J^2) factor / O(N J) solve facade.

    ``method``: "scan" (the sequential solver), "blocked" (the
    block-parallel solver), "native" (the host C++ core, float64) or
    "auto" (module docstring).  ``device``: where it computes; ``None``
    means ``"cuda"``.  After ``compute`` it holds the factor ``(D, W)``
    and the lowered inputs the other ops need (solver.cpp:32-59).
    """

    def __init__(self, method="auto", device=None):
        if method not in ("auto", "scan", "blocked", "native"):
            raise ValueError("unknown method '{0}'".format(method))
        self._method = method
        self._device = device
        self._reset()

    def _reset(self):
        self._computed = False
        self._n = 0
        self._route = None
        self._ssm = None
        self._fact = None
        self._coeffs = None
        self._t = None
        self._log_det = None
        self._native = None

    def _pick(self, n):
        """``(route, device)`` for an ``n``-point problem."""
        device = lanes4.resolve_device(self._device)
        if self._method == "native":
            if not native.available():
                raise RuntimeError(
                    "method='native' requires a working g++ toolchain")
            return "native", torch.device("cpu")
        if self._method != "auto":
            return self._method, device
        if device.type == "cuda":
            return "blocked", device
        if n < _NATIVE_BELOW and native.available():
            return "native", device
        return ("scan" if n < _SCAN_BELOW else "blocked"), device

    # -- main entry ---------------------------------------------------------
    def compute(self, jitter, a_real, c_real, a_comp, b_comp, c_comp, d_comp,
                A=None, U=None, V=None, t=None, diag=None):
        """Factor K, with the general blocks ``(A, U, V)`` where given;
        raises LinAlgError on a negative pivot (cholesky.h:41-210)."""
        if t is None:
            raise ValueError("t is required")
        t = np.ascontiguousarray(np.atleast_1d(t), dtype=float)
        n = t.shape[0]
        diag = np.ascontiguousarray(np.atleast_1d(diag), dtype=float)
        if diag.shape[0] != n:
            raise ValueError("dimension mismatch")
        coeffs = _coefficients(jitter, a_real, c_real, a_comp, b_comp,
                               c_comp, d_comp)
        general = _general(A, U, V, n)
        # Drop a previous factor before either branch: a native factor
        # must never survive into a later torch recompute, or vice versa.
        self._reset()
        route, device = self._pick(n)
        ssm = _lower(coeffs, t, diag, device, general)
        if route == "native":
            ns = native.NativeSolver(*(x.numpy() for x in ssm))
            if not ns.ok or np.any(ns.D < 0):
                raise LinAlgError("failed to factorize or solve matrix")
            fact = seq.FactorResult(D=torch.as_tensor(ns.D),
                                    W=torch.as_tensor(ns.W),
                                    ok=torch.tensor(True))
            d = ns.D
            self._native = ns
        else:
            fact = _OPS[route].factor(ssm)
            d = fact.D.cpu().numpy()
            if np.any(d < 0) or np.any(np.isnan(d)):
                raise LinAlgError("failed to factorize or solve matrix")
        self._computed = True
        self._n = n
        self._route = route
        self._ssm = ssm
        self._fact = fact
        self._coeffs = Coefficients(*(torch.as_tensor(c, dtype=torch.float64,
                                                      device=ssm.U.device)
                                      for c in coeffs))
        self._t = t
        self._log_det = float(np.sum(np.log(d)))

    # -- queries ------------------------------------------------------------
    def computed(self):
        return self._computed

    def log_determinant(self):
        self._require_computed()
        return self._log_det

    def _require_computed(self):
        if not self._computed:
            raise RuntimeError("you must call 'compute' first")

    def _check_rhs(self, b):
        b = np.ascontiguousarray(b, dtype=float)
        if b.shape[0] != self._n:
            raise ValueError("dimension mismatch")
        return b

    def _on_device(self, x):
        return torch.as_tensor(x, dtype=torch.float64,
                               device=self._ssm.U.device)

    def _native_columns(self, fn, b):
        if b.ndim == 1:
            return fn(b)
        return np.stack([fn(b[:, k]) for k in range(b.shape[1])], axis=1)

    # -- ops ----------------------------------------------------------------
    def solve(self, b):
        """K^-1 b for b of shape (N,) or (N, nrhs)."""
        self._require_computed()
        b = self._check_rhs(b)
        if self._native is not None:
            return self._native_columns(self._native.solve, b)
        ops = _OPS[self._route]
        return ops.solve(self._ssm, self._fact,
                         self._on_device(b)).cpu().numpy()

    def dot_solve(self, b):
        """b^T K^-1 b (scalar)."""
        self._require_computed()
        b = self._check_rhs(b)
        if b.ndim > 1:
            b = b.reshape(self._n)
        if self._native is not None:
            return float(b @ self._native.solve(b))
        if self._route == "scan":
            return float(seq.dot_solve(self._ssm, self._fact,
                                       self._on_device(b)))
        z = blocked.solve_lower(self._ssm, self._fact, self._on_device(b))
        return float(torch.sum(z * z / self._fact.D))

    def dot_L(self, z):
        """L sqrt(D) z: prior sample transport; returns (N, nrhs)."""
        self._require_computed()
        z = self._check_rhs(z)
        if z.ndim == 1:
            z = z[:, None]
        if self._native is not None:
            return self._native_columns(self._native.dot_L, z)
        ops = _OPS[self._route]
        return ops.dot_L(self._ssm, self._fact,
                         self._on_device(z)).cpu().numpy()

    def dot(self, jitter, a_real, c_real, a_comp, b_comp, c_comp, d_comp, A,
            U, V, t, z):
        """K z without factorizing (no yerr on the diagonal)."""
        t = np.ascontiguousarray(np.atleast_1d(t), dtype=float)
        z = np.ascontiguousarray(z, dtype=float)
        if z.shape[0] != t.shape[0]:
            raise ValueError("dimension mismatch")
        coeffs = _coefficients(jitter, a_real, c_real, a_comp, b_comp,
                               c_comp, d_comp)
        general = _general(A, U, V, t.shape[0])
        route, device = self._pick(t.shape[0])
        ssm = _lower(coeffs, t, np.zeros(t.shape[0]), device, general)
        if route == "native":
            return self._native_columns(
                lambda col: native.matmul(*(x.numpy() for x in ssm), col), z)
        zt = torch.as_tensor(z, dtype=torch.float64, device=device)
        return _OPS[route].matmul(ssm, zt).cpu().numpy()

    def predict(self, y, x):
        """Conditional mean K_*(x, t) K^-1 y at sorted test points x.

        With the blocked route the solve and the lag-state recursions run
        in parallel (Hillis-Steele scans) instead of as sequential loops.
        """
        self._require_computed()
        y = self._check_rhs(np.atleast_1d(y))
        x = np.ascontiguousarray(np.atleast_1d(x), dtype=float)
        alpha = self._on_device(self.solve(y))
        return seq.predict_mean(self._coeffs, self._on_device(self._t),
                                alpha, self._on_device(x),
                                parallel=self._route == "blocked"
                                ).cpu().numpy()

    def grad_log_likelihood(self, jitter, a_real, c_real, a_comp, b_comp,
                            c_comp, d_comp, A, U, V, t, resid, diag):
        """(ll, grad) w.r.t. [jitter, a_real, c_real, a_c, b_c, c_c, d_c]:
        one reverse pass of autograd through the sequential solver
        (the blocked one on the blocked route)."""
        t = np.ascontiguousarray(np.atleast_1d(t), dtype=float)
        resid = np.ascontiguousarray(resid, dtype=float)
        diag = np.ascontiguousarray(np.atleast_1d(diag), dtype=float)
        general = _general(A, U, V, t.shape[0])
        blocks = [np.atleast_1d(np.asarray(jitter, dtype=float))] + [
            np.atleast_1d(np.asarray(v, dtype=float))
            for v in (a_real, c_real, a_comp, b_comp, c_comp, d_comp)]
        route, device = self._pick(t.shape[0])
        if route == "native":
            route, device = "scan", torch.device("cpu")
        flat = torch.as_tensor(np.concatenate(blocks), device=device)
        flat.requires_grad_()
        parts = torch.split(flat, [len(b) for b in blocks])
        coeffs = Coefficients(*parts[1:], jitter=parts[0][0])
        ssm = lower(coeffs, torch.as_tensor(t, device=device),
                    torch.as_tensor(diag, device=device),
                    **{k: torch.as_tensor(x, device=device)
                       for k, x in general.items()})
        ll, ok = _OPS[route].gp_log_likelihood(
            ssm, torch.as_tensor(resid, device=device))
        if not bool(ok):
            raise LinAlgError("failed to factorize or solve matrix")
        (grad,) = torch.autograd.grad(ll, flat)
        return float(ll.detach()), grad.cpu().numpy()

    # -- pickling (PicklableCholeskySolver, solver.cpp:36-58) ---------------
    def __getstate__(self):
        state = {"computed": self._computed, "method": self._method,
                 "device": None if self._device is None
                 else str(self._device)}
        if self._computed:
            state.update(
                n=self._n, route=self._route, t=self._t,
                log_det=self._log_det,
                ssm=tuple(x.cpu().numpy() for x in self._ssm),
                fact=tuple(x.cpu().numpy() for x in self._fact),
                coeffs=tuple(x.cpu().numpy() for x in self._coeffs),
            )
        return state

    def __setstate__(self, state):
        self._method = state["method"]
        self._device = state["device"]
        self._reset()
        if not state["computed"]:
            return
        route = state["route"]
        device = (torch.device("cpu") if route == "native"
                  else lanes4.resolve_device(self._device))

        def dev(x):
            return torch.as_tensor(x, device=device)

        self._computed = True
        self._n = state["n"]
        self._route = route
        self._t = state["t"]
        self._log_det = state["log_det"]
        self._ssm = SSM(*map(dev, state["ssm"]))
        self._fact = seq.FactorResult(*map(dev, state["fact"]))
        self._coeffs = Coefficients(*map(dev, state["coeffs"]))
        if route == "native":
            self._native = native.NativeSolver(*state["ssm"],
                                               D=state["fact"][0],
                                               W=state["fact"][1])
