"""The port's adjoint pipeline against the JAX package's.

``celerite_torch.ops.adjoint``'s plain versions of the four kernels are held
against ``celerite_tpu.ops.adjoint``'s ``_elements_fwd`` / ``_elements_bwd``
/ ``_factor_fwd`` / ``_factor_bwd`` (interpret mode, as the JAX package's
own tests run them on the CPU) on the same streams, every output and the
saves, at rtol 1e-12 (atol 1e-12 of the output's largest value); the
end-to-end ``run_kernel`` and its gradient with respect to the streams
against JAX's ``run_kernel`` and ``jax.grad`` at 1e-10; and the reused
fused4 glue against the JAX package's ``blocked`` prefixes at P = 16.  The
streams are JAX's lane lowering of models of padded width 4, 13 and 16 on
8 lanes of at most 8 steps.  The CUDA kernels are held against these plain
versions by tests/test_torch_kernels.py (marked ``cuda``) and by
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from celerite_tpu import terms as jterms
from celerite_tpu.ops import adjoint as jadj, blocked, lanes as jlanes, seq
from celerite_tpu.ops.lower import Coefficients as JCoefficients, lower
from celerite_torch.ops import adjoint, fused4, lower as tlower
from celerite_torch.testing import make_data, wide_kernel

B = 8
WIDTHS = (4, 13, 16)


def _kernel(terms, p):
    if p == 4:
        return terms.SHOTerm(log_S0=0.1, log_Q=1.0, log_omega0=0.5)
    return wide_kernel(terms, p)


def _streams(p, n=60, seed=1):
    """JAX's lane lowering of a width-``p`` model: numpy ``(u, v, ph, a,
    y)`` on B lanes of ceil(n / B) steps."""
    t, y, yerr = make_data(n, seed=seed, t_max=6.0)
    kernel = _kernel(jterms, p)
    assert sum(np.multiply(kernel.padded_size, (1, 2))) == p
    theta = jnp.asarray(kernel.get_parameter_vector())
    plan = jlanes.make_plan(t, y, yerr**2, B, dtype=np.float64)
    coeffs = JCoefficients(*kernel.get_padded_coefficients(theta),
                           jitter=kernel.get_jitter(theta))
    u, v, ph, a = jlanes.lower_lanes(coeffs, plan)
    return tuple(np.asarray(x) for x in (u, v, ph, a, plan.y))


def _t(*xs):
    return [torch.as_tensor(np.array(x)) for x in xs]


def _close(got, want, rtol=1e-12):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want.reshape(got.shape), rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _saves(sv, p, nmat):
    """The port's ``(L, B, NSV)`` saves as JAX's ``(L, P, P, B)`` matrices
    and ``(L, P, B)`` vector."""
    steps = [adjoint._load(s, p, nmat) for s in sv]
    return [torch.stack(x) for x in zip(*steps)]


def _cotangents(shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s) for s in shapes]


@pytest.mark.parametrize("p", WIDTHS)
def test_elements_kernels_match_jax(p):
    u, v, ph, a, _ = _streams(p)
    (jA, jJ, jC), res = jax.jit(jadj._elements_fwd)(
        *map(jnp.asarray, (u, v, ph, a)))
    A, J, C, sv = adjoint.elements_fwd_reference(*_t(u, v, ph, a))
    for got, want in zip((A, J, C, *_saves(sv, p, 2)),
                         (jA, jJ, jC, res[4], res[5])):
        _close(got, want)
    cots = _cotangents([(p, p, B)] * 3)
    want = jax.jit(jadj._elements_bwd)(res, tuple(map(jnp.asarray, cots)))
    got = adjoint.elements_bwd_reference(*_t(u, v, ph, a), sv, *_t(*cots))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("p", WIDTHS)
def test_factor_kernels_match_jax(p):
    u, v, ph, a, y = _streams(p, seed=2)
    uu, vv, pp, aa, yy = _t(u, v, ph, a, y)
    A, J, C, _ = adjoint.elements_fwd_reference(uu, vv, pp, aa)
    sh0 = fused4.prefix_sh0(A, J, C, B)
    jouts, res = jax.jit(jadj._factor_fwd)(
        *map(jnp.asarray, (sh0.numpy(), u, v, ph, a, y)))
    *outs, sv = adjoint.factor_fwd_reference(sh0, uu, vv, pp, aa, yy)
    for got, want in zip((*outs, *_saves(sv, p, 2)), (*jouts, *res[5:])):
        _close(got, want)
    cots = _cotangents([(p, p, B), (p, B), (p, p, B), (p, B), (1, B),
                        (1, B), (1, B)], seed=3)
    jh = jax.jit(jadj._factor_bwd)(res, tuple(map(jnp.asarray, cots)))
    got = adjoint.factor_bwd_reference(uu, vv, pp, aa, yy, sv,
                                       *_t(*cots[:4]),
                                       *[torch.as_tensor(c[0])
                                         for c in cots[4:6]])
    # JAX returns (hsh0, hu, hv, hph, ha, hy); the port (hu, ..., hy, hsh0).
    for g, w in zip(got, (*jh[1:], jh[0])):
        _close(g, w)


@pytest.mark.parametrize("p", (13, 16))
def test_run_kernel_and_its_gradient_match_jax(p):
    """ll and d ll / d (u, v, ph, a, y) through the whole pipeline: the
    hand-written transposes and the glue's autograd against JAX's custom
    VJPs and XLA's differentiation of its glue."""
    streams = _streams(p, seed=4)
    n = 60
    ll_j, grads_j = jax.jit(jax.value_and_grad(
        lambda *xs: jadj.run_kernel(*xs, n)[0], argnums=(0, 1, 2, 3, 4)))(
        *map(jnp.asarray, streams))
    xs = [x.requires_grad_() for x in _t(*streams)]
    ll, ok = adjoint.run_kernel(*xs, n)
    assert bool(ok)
    ll.backward()
    np.testing.assert_allclose(float(ll.detach()), float(ll_j), rtol=1e-10)
    for x, g in zip(xs, grads_j):
        _close(x.grad, g, rtol=1e-10)


def test_glue_matches_blocked_prefixes():
    """fused4's float64 glue, reused by the adjoint route, against the JAX
    package's ``blocked`` exclusive prefixes at P = 16: the element prefix
    gives the seeds, the affine prefix each lane's incoming state h, from
    which both assemble ``q0 - 2 qv.h + h^T Qm h``."""
    p = 16
    u, v, ph, a, y = _streams(p, seed=5)
    uu, vv, pp, aa, yy = _t(u, v, ph, a, y)
    A, J, C, _ = adjoint.elements_fwd_reference(uu, vv, pp, aa)
    sh0 = fused4.prefix_sh0(A, J, C, B)
    elems = tuple(jnp.asarray(x.permute(2, 0, 1).numpy()) for x in (A, J, C))
    _close(sh0, np.asarray(blocked._exclusive_prefix_elements(elems)[2])
           .transpose(1, 2, 0))
    M, m, Qm, qv, q0, _, _, _ = adjoint.factor_fwd_reference(
        sh0, uu, vv, pp, aa, yy)
    _, mp = blocked._exclusive_prefix_affine(
        jnp.asarray(M.permute(2, 0, 1).numpy()), jnp.asarray(m.T.numpy()))
    h = np.asarray(mp).T
    want = (q0.numpy() - 2.0 * np.sum(qv.numpy() * h, axis=0)
            + np.sum(h * np.einsum("ijb,jb->ib", Qm.numpy(), h), axis=0))
    _close(fused4.lane_quad(M, m, Qm, qv, q0, B), want)


def test_ssm_level_log_likelihood_matches_seq():
    """``gp_log_likelihood`` on an SSM (``fused._to_lanes``'s padding) and
    its gradient in the data against the JAX package's sequential solver."""
    t, y, yerr = make_data(97, seed=6, t_max=8.0)
    kernel = _kernel(jterms, 13)
    theta = jnp.asarray(kernel.get_parameter_vector())
    coeffs = JCoefficients(*kernel.get_padded_coefficients(theta),
                           jitter=kernel.get_jitter(theta))
    ssm = lower(coeffs, jnp.asarray(t), jnp.asarray(yerr**2))
    ll_j, g_j = jax.value_and_grad(
        lambda r: seq.gp_log_likelihood(ssm, r)[0])(jnp.asarray(y))
    tssm = tlower.SSM(*_t(*ssm))
    resid = torch.tensor(y, requires_grad=True)
    ll, ok = adjoint.gp_log_likelihood(tssm, resid, num_blocks=B)
    ll.backward()
    assert bool(ok)
    np.testing.assert_allclose(float(ll.detach()), float(ll_j), rtol=1e-10)
    _close(resid.grad, g_j, rtol=1e-9)


def test_dispatchers_take_plain_versions_on_cpu():
    u, v, ph, a, _ = _t(*_streams(4))
    for got, want in zip(adjoint.elements_fwd(u, v, ph, a),
                         adjoint.elements_fwd_reference(u, v, ph, a)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("name", adjoint.ADJOINT_KERNELS)
def test_wrappers_reject_cpu_tensors(name):
    """A kernel wrapper takes CUDA tensors only; it never runs the plain
    version (checked before any kernel is loaded, so no card is needed)."""
    p, L = 4, 8
    z = torch.zeros
    u, a = z(L, p, B), z(L, 1, B)
    args = {
        "elements_fwd": (u, u, u, a),
        "elements_bwd": (u, u, u, a, z(L, B, 2 * p * p), z(p, p, B),
                         z(p, p, B), z(p, p, B)),
        "factor_fwd": (z(p, p, B), u, u, u, a, a),
        "factor_bwd": (u, u, u, a, a, z(L, B, 2 * p * p + p), z(p, p, B),
                       z(p, B), z(p, p, B), z(p, B), z(B), z(B)),
    }[name]
    fn = getattr(adjoint, name + "_cuda")
    before = fn.launches
    with pytest.raises(ValueError, match="CUDA"):
        fn(*args)
    assert fn.launches == before


def test_wrappers_reject_widths_above_16():
    u = torch.zeros(2, 17, B)
    with pytest.raises(NotImplementedError, match="1..16"):
        adjoint.elements_fwd_cuda(u, u, u, torch.zeros(2, 1, B))


@pytest.mark.parametrize("width", [13, 14, 16])
def test_wide_kernel_widths(width):
    """The card tests' wide models (``testing.wide_kernel``) have the padded
    width they are named by, in this package's terms and in the JAX
    package's alike."""
    from celerite_torch import terms as tterms

    for mod in (tterms, jterms):
        kernel = wide_kernel(mod, width)
        assert sum(np.multiply(kernel.padded_size, (1, 2))) == width
