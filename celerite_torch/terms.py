"""The celerite kernel ("terms") DSL, in torch.

Port of ``celerite_tpu/terms.py``.  Each term lowers its named parameters to
the six coefficient arrays ``(a_real, c_real, a_comp, b_comp, c_comp,
d_comp)`` plus a scalar jitter; sums concatenate coefficient blocks;
products expand trigonometric cross-products; validity is checked with
Sturm's theorem on the PSD.

Parameters arrive as a 1-D tensor; every lowering is written as torch ops,
so ``torch.autograd`` (and ``torch.func``) differentiate through it.
``get_padded_coefficients`` has parameter-independent shapes: ``SHOTerm``
always emits 2 real + 1 complex slots and picks the active branch of the
Q = 1/2 switch with a double ``where``, so gradients stay finite on both
sides of the boundary.  Eager methods (``get_value``, ``get_psd``,
``coefficients``) take and return numpy with the reference's shapes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .modeling import Model, ModelSet
from .ops import kernels

__all__ = [
    "Term",
    "TermSum",
    "TermProduct",
    "JitterTerm",
    "RealTerm",
    "ComplexTerm",
    "SHOTerm",
    "Matern32Term",
]


def _params(params):
    """Parameters as a 1-D tensor (numpy input becomes float64)."""
    if isinstance(params, torch.Tensor):
        return params
    return torch.as_tensor(np.asarray(params, dtype=np.float64))


def _empty(like):
    return torch.zeros((0,), dtype=like.dtype, device=like.device)


def _atleast_1d(x, like):
    return torch.atleast_1d(
        torch.as_tensor(x, dtype=like.dtype, device=like.device)
    )


class Term(Model):
    """Abstract base term.

    Subclasses overload :func:`get_real_coefficients` and/or
    :func:`get_complex_coefficients` (and, for value-dependent shapes,
    :func:`get_padded_coefficients`).
    """

    _has_jitter = False
    _has_coeffs = True

    # Static (worst-case) number of (real, complex) slots emitted by the
    # padded lowering.  Overridden per subclass.
    padded_size = (0, 0)

    @property
    def terms(self):
        """All the terms in a sum (a single term is its own list)."""
        return [self]

    # -- coefficient lowering (eager, reference-shaped) ---------------------
    def get_real_coefficients(self, params):
        return _empty(params), _empty(params)

    def get_complex_coefficients(self, params):
        return _empty(params), _empty(params), _empty(params), _empty(params)

    def get_all_coefficients(self, params=None):
        if params is None:
            params = self.get_parameter_vector(include_frozen=True)
        params = _params(params)
        r = self.get_real_coefficients(params)
        c = self.get_complex_coefficients(params)
        if len(c) == 3:
            c = (c[0], torch.zeros_like(_atleast_1d(c[0], params)), c[1], c[2])
        return [_atleast_1d(v, params) for v in tuple(r) + tuple(c)]

    @property
    def coefficients(self):
        """The validated 6-tuple of 1-D coefficient arrays (numpy)."""
        pars = [p.detach().cpu().numpy() for p in self.get_all_coefficients()]
        if len(pars) != 6:
            raise ValueError("there must be 6 coefficient blocks")
        if any(p.ndim != 1 for p in pars):
            raise ValueError("coefficient blocks must be 1D")
        if len(pars[0]) != len(pars[1]):
            raise ValueError("coefficient blocks must have the same shape")
        if any(len(pars[2]) != len(p) for p in pars[3:]):
            raise ValueError("coefficient blocks must have the same shape")
        return pars

    # -- coefficient lowering (statically padded) ---------------------------
    def get_padded_coefficients(self, params):
        """Lowering with parameter-independent shapes.

        Default: identical to the eager lowering (true for every built-in
        term except SHOTerm, which overrides).
        """
        return self.get_all_coefficients(params)

    # -- jitter -------------------------------------------------------------
    def get_jitter(self, params):
        params = _params(params)
        return torch.zeros((), dtype=params.dtype, device=params.device)

    @property
    def jitter(self):
        return float(
            self.get_jitter(self.get_parameter_vector(include_frozen=True))
        )

    # -- evaluation ---------------------------------------------------------
    def get_value(self, tau):
        """Evaluate k(tau) elementwise (excludes jitter, like the ref)."""
        tau = np.asarray(tau, dtype=float)
        coeffs = [torch.as_tensor(c) for c in self.coefficients]
        k = kernels.kernel_value(*coeffs, torch.as_tensor(tau.ravel()))
        return k.numpy().reshape(tau.shape)

    def get_psd(self, omega):
        """Evaluate the PSD S(omega) elementwise."""
        omega = np.asarray(omega, dtype=float)
        coeffs = [torch.as_tensor(c) for c in self.coefficients]
        p = kernels.psd_value(*coeffs, torch.as_tensor(omega.ravel()))
        return p.numpy().reshape(omega.shape)

    def check_parameters(self):
        """Sturm-theorem check that the PSD is everywhere non-negative."""
        from .ops.poly import check_coefficients

        return check_coefficients(*self.coefficients)

    # -- jacobians (for reference grad-path API parity) ---------------------
    def get_coeffs_jacobian(self, include_frozen=False):
        def fn(p):
            return torch.cat(self.get_all_coefficients(p))

        params = _params(self.get_parameter_vector(include_frozen=True))
        jac = torch.func.jacfwd(fn)(params).T.numpy()
        if include_frozen:
            return jac
        return jac[self.unfrozen_mask]

    def get_jitter_jacobian(self, include_frozen=False):
        params = _params(self.get_parameter_vector(include_frozen=True))
        jac = torch.func.jacfwd(self.get_jitter)(params).numpy()
        if include_frozen:
            return jac
        return jac[self.unfrozen_mask]

    # -- algebra ------------------------------------------------------------
    def __add__(self, other):
        return TermSum(self, other)

    def __radd__(self, other):
        return TermSum(other, self)

    def __mul__(self, other):
        return TermProduct(self, other)

    def __rmul__(self, other):
        return TermProduct(other, self)


class TermSum(Term, ModelSet):
    """A sum of terms: coefficient blocks concatenate, jitters add."""

    def __init__(self, *terms):
        flat = []
        for term in terms:
            flat.extend(term.terms)
        super().__init__(
            [("terms[{0}]".format(i), t) for i, t in enumerate(flat)]
        )

    def __repr__(self):
        return "(" + " + ".join(map(repr, self.terms)) + ")"

    @property
    def terms(self):
        return list(self.models.values())

    @property
    def _has_jitter(self):
        return any(t._has_jitter for t in self.models.values())

    @property
    def _has_coeffs(self):
        return any(t._has_coeffs for t in self.models.values())

    @property
    def padded_size(self):
        sizes = [t.padded_size for t in self.models.values()]
        return (sum(s[0] for s in sizes), sum(s[1] for s in sizes))

    def _map_subterms(self, method, params):
        out = []
        i = 0
        for t in self.models.values():
            n = t.full_size
            out.append(getattr(t, method)(params[i : i + n]))
            i += n
        return out

    def get_all_coefficients(self, params=None):
        if params is None:
            params = self.get_parameter_vector(include_frozen=True)
        blocks = self._map_subterms("get_all_coefficients", _params(params))
        return [torch.cat(b) for b in zip(*blocks)]

    def get_padded_coefficients(self, params):
        blocks = self._map_subterms("get_padded_coefficients", _params(params))
        return [torch.cat(b) for b in zip(*blocks)]

    def get_jitter(self, params=None):
        if params is None:
            params = self.get_parameter_vector(include_frozen=True)
        return sum(self._map_subterms("get_jitter", _params(params)))


def _product_coefficients(c1, c2):
    """Cross-product expansion of two 6-tuples of coefficient arrays.

    The trig identities for products of damped sinusoids (reference
    terms.py:234-277) in vectorized outer-product form; the ordering matches
    the reference's itertools loops.
    """
    ar1, cr1, ac1, bc1, cc1, dc1 = c1
    ar2, cr2, ac2, bc2, cc2, dc2 = c2

    def outer(x, y):
        return (x[:, None] * y[None, :]).reshape(-1)

    def outer_sum(x, y):
        return (x[:, None] + y[None, :]).reshape(-1)

    # real x real -> real
    ar = outer(ar1, ar2)
    cr = outer_sum(cr1, cr2)

    # real1 x complex2, then real2 x complex1 -> complex
    ac_rc = [outer(ar1, ac2), outer(ar2, ac1)]
    bc_rc = [outer(ar1, bc2), outer(ar2, bc1)]
    cc_rc = [outer_sum(cr1, cc2), outer_sum(cr2, cc1)]
    dc_rc = [
        dc2[None, :].expand(ar1.shape[0], dc2.shape[0]).reshape(-1),
        dc1[None, :].expand(ar2.shape[0], dc1.shape[0]).reshape(-1),
    ]

    # complex x complex -> two complex terms each (d1 -/+ d2), interleaved in
    # the reference's (minus, plus) order per (j, k) pair.
    aa = outer(ac1, ac2)
    bb = outer(bc1, bc2)
    ab = outer(ac1, bc2)
    ba = outer(bc1, ac2)
    cc_cc = outer_sum(cc1, cc2)
    dd_minus = (dc1[:, None] - dc2[None, :]).reshape(-1)
    dd_plus = (dc1[:, None] + dc2[None, :]).reshape(-1)

    ac_m = 0.5 * (aa + bb)
    bc_m = 0.5 * (ba - ab)
    ac_p = 0.5 * (aa - bb)
    bc_p = 0.5 * (ba + ab)

    def interleave(x, y):
        return torch.stack([x, y], dim=-1).reshape(-1)

    ac = torch.cat(ac_rc + [interleave(ac_m, ac_p)])
    bc = torch.cat(bc_rc + [interleave(bc_m, bc_p)])
    cc = torch.cat(cc_rc + [interleave(cc_cc, cc_cc)])
    dc = torch.cat(dc_rc + [interleave(dd_minus, dd_plus)])

    return [ar, cr, ac, bc, cc, dc]


class TermProduct(Term, ModelSet):
    """A product of two terms (jitter factors are rejected, like the ref)."""

    def __init__(self, k1, k2):
        if k1._has_jitter or k2._has_jitter:
            raise ValueError(
                "Products are not implemented for terms with jitter"
            )
        super().__init__([("k1", k1), ("k2", k2)])

    def __repr__(self):
        return "{0!r} * {1!r}".format(self.models["k1"], self.models["k2"])

    @property
    def terms(self):
        return [self]

    @property
    def padded_size(self):
        r1, c1 = self.models["k1"].padded_size
        r2, c2 = self.models["k2"].padded_size
        return (r1 * r2, r1 * c2 + r2 * c1 + 2 * c1 * c2)

    def _split_params(self, params):
        n = self.models["k1"].full_size
        return params[:n], params[n:]

    def get_all_coefficients(self, params=None):
        if params is None:
            params = self.get_parameter_vector(include_frozen=True)
        p1, p2 = self._split_params(_params(params))
        return _product_coefficients(
            self.models["k1"].get_all_coefficients(p1),
            self.models["k2"].get_all_coefficients(p2),
        )

    def get_padded_coefficients(self, params):
        p1, p2 = self._split_params(_params(params))
        return _product_coefficients(
            self.models["k1"].get_padded_coefficients(p1),
            self.models["k2"].get_padded_coefficients(p2),
        )


class JitterTerm(Term):
    r"""Pure white noise: k(tau_nm) = sigma^2 delta_nm.

    Parameter: ``log_sigma``.  (Reference terms.py:327-357.)
    """

    _has_jitter = True
    _has_coeffs = False
    parameter_names = ("log_sigma",)
    padded_size = (0, 0)

    def __repr__(self):
        return "JitterTerm({0.log_sigma})".format(self)

    def get_jitter(self, params):
        return torch.exp(2.0 * _params(params)[0])


class RealTerm(Term):
    r"""k(tau) = a exp(-c tau).  Parameters: ``log_a``, ``log_c``.

    (Reference terms.py:360-391.)
    """

    parameter_names = ("log_a", "log_c")
    padded_size = (1, 0)

    def __repr__(self):
        return "RealTerm({0.log_a}, {0.log_c})".format(self)

    def get_real_coefficients(self, params):
        return torch.exp(params[0]), torch.exp(params[1])


class ComplexTerm(Term):
    r"""General celerite term: damped sinusoid with parameters
    ``log_a``, (optional ``log_b``), ``log_c``, ``log_d``.

    The box prior enforces a*c >= b*d (positive-definiteness on its own;
    reference terms.py:446-451).
    """

    padded_size = (0, 1)

    def __init__(self, *args, **kwargs):
        if len(args) == 4 or "log_b" in kwargs:
            self.fit_b = True
            self.parameter_names = ("log_a", "log_b", "log_c", "log_d")
        else:
            self.fit_b = False
            self.parameter_names = ("log_a", "log_c", "log_d")
        super().__init__(*args, **kwargs)

    def __repr__(self):
        if not self.fit_b:
            return "ComplexTerm({0.log_a}, {0.log_c}, {0.log_d})".format(
                self
            )
        return (
            "ComplexTerm({0.log_a}, {0.log_b}, {0.log_c}, {0.log_d})"
        ).format(self)

    def get_complex_coefficients(self, params):
        if not self.fit_b:
            return (
                torch.exp(params[0]),
                torch.zeros((), dtype=params.dtype, device=params.device),
                torch.exp(params[1]),
                torch.exp(params[2]),
            )
        return tuple(torch.exp(params[i]) for i in range(4))

    def log_prior(self):
        if self.fit_b and self.log_a + self.log_c < self.log_b + self.log_d:
            return -np.inf
        return super().log_prior()


class SHOTerm(Term):
    r"""Stochastically-driven damped harmonic oscillator.

    PSD: S(w) = sqrt(2/pi) S0 w0^4 / ((w^2 - w0^2)^2 + w0^2 w^2 / Q^2).
    Parameters: ``log_S0``, ``log_Q``, ``log_omega0``.

    The eager lowering branches on Q (overdamped Q < 1/2 -> two real terms;
    otherwise one complex term; reference terms.py:489-517).  The padded
    lowering emits a fixed 2-real + 1-complex block and switches branches
    with a double ``where`` so gradients are finite at the boundary.
    """

    parameter_names = ("log_S0", "log_Q", "log_omega0")
    padded_size = (2, 1)

    def __repr__(self):
        return "SHOTerm({0.log_S0}, {0.log_Q}, {0.log_omega0})".format(self)

    def _branch_q(self, params):
        """Concrete Q used for eager branch selection."""
        try:
            return float(params[1])
        except RuntimeError:
            # Inside a torch.func transform the value is not concrete:
            # fall back to the currently stored value.
            return float(self.log_Q)

    def get_real_coefficients(self, params):
        if math.exp(self._branch_q(params)) >= 0.5:
            return _empty(params), _empty(params)
        s0 = torch.exp(params[0])
        q = torch.exp(params[1])
        w0 = torch.exp(params[2])
        f = torch.sqrt(1.0 - 4.0 * q**2)
        return (
            0.5 * s0 * w0 * q * torch.stack([1.0 + 1.0 / f, 1.0 - 1.0 / f]),
            0.5 * w0 / q * torch.stack([1.0 - f, 1.0 + f]),
        )

    def get_complex_coefficients(self, params):
        if math.exp(self._branch_q(params)) < 0.5:
            return _empty(params), _empty(params), _empty(params), _empty(params)
        s0 = torch.exp(params[0])
        q = torch.exp(params[1])
        w0 = torch.exp(params[2])
        f = torch.sqrt(4.0 * q**2 - 1.0)
        return (
            s0 * w0 * q,
            s0 * w0 * q / f,
            0.5 * w0 / q,
            0.5 * w0 / q * f,
        )

    def get_padded_coefficients(self, params):
        params = _params(params)
        s0 = torch.exp(params[0])
        q = torch.exp(params[1])
        w0 = torch.exp(params[2])
        over = q < 0.5
        one = torch.ones((), dtype=q.dtype, device=q.device)

        # Double-where: each branch sees a parameter value safely inside its
        # own domain, so both values and gradients stay finite everywhere.
        q_over = torch.where(over, q, 0.25 * one)
        q_under = torch.where(over, one, q)

        # Tiny floor keeps value AND gradient finite at exactly Q == 1/2
        # (sqrt' diverges there); the induced error lives in a ~1e-6-wide
        # band where the kernel itself is ill-conditioned in any branch.
        tiny = 1e-12

        f_over = torch.sqrt(torch.clamp(1.0 - 4.0 * q_over**2, min=tiny))
        amp = 0.5 * s0 * w0 * q_over
        a_real = torch.where(
            over,
            amp * torch.stack([1.0 + 1.0 / f_over, 1.0 - 1.0 / f_over]),
            torch.zeros((2,), dtype=q.dtype, device=q.device),
        )
        c_base_over = 0.5 * w0 / q_over
        c_real = torch.where(
            over,
            c_base_over * torch.stack([1.0 - f_over, 1.0 + f_over]),
            # Inert positive decay for the padded slots.
            w0 * torch.ones((2,), dtype=q.dtype, device=q.device),
        )

        f_under = torch.sqrt(torch.clamp(4.0 * q_under**2 - 1.0, min=tiny))
        c_under = 0.5 * w0 / q_under
        zero = 0.0 * one
        a_comp = torch.where(over, zero, s0 * w0 * q_under)[None]
        b_comp = torch.where(over, zero, s0 * w0 * q_under / f_under)[None]
        c_comp = torch.where(over, w0, c_under)[None]
        d_comp = torch.where(over, zero, c_under * f_under)[None]

        return [a_real, c_real, a_comp, b_comp, c_comp, d_comp]


class Matern32Term(Term):
    r"""epsilon-approximation of the Matern-3/2 kernel.

    k(tau) -> sigma^2 (1 + sqrt(3) tau / rho) exp(-sqrt(3) tau / rho) as
    eps -> 0.  Parameters: ``log_sigma``, ``log_rho``; ``eps`` is a fixed
    constructor argument (reference terms.py:520-566).
    """

    parameter_names = ("log_sigma", "log_rho")
    padded_size = (0, 1)

    def __init__(self, *args, **kwargs):
        eps = kwargs.pop("eps", 0.01)
        super().__init__(*args, **kwargs)
        self.eps = eps

    def __repr__(self):
        return "Matern32Term({0.log_sigma}, {0.log_rho}, eps={0.eps})".format(
            self
        )

    def get_complex_coefficients(self, params):
        w0 = math.sqrt(3.0) * torch.exp(-params[1])
        s0 = torch.exp(2.0 * params[0]) / w0
        eps = torch.full((), self.eps, dtype=params.dtype, device=params.device)
        return (w0 * s0, w0 * w0 * s0 / self.eps, w0, eps)
