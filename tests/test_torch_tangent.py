"""The port's forward-mode gradient (``fast_grad="tangent"``) against the
JAX package's tangent kernels and routes.

The plain versions of the three tangent kernels (``celerite_torch.ops.
tangent``) against ``celerite_tpu.ops.tangent``'s Pallas kernels in
interpret mode (as the JAX package's own tests run them on the CPU), on the
same streams and tangents (numpy, seeded): the split pair output by output
(``_run_elements_jvp``, ``_run_factor_jvp``, the factor taking the port's
seeds) and through ``_jac_impl`` (which JAX runs as the split pair at any
width) at padded width 5 with T = 3, and the single-sweep kernel with
tangents (``_run_fused_jac``) at width 5 with T = 5, every output at rtol
1e-10 of its largest value, the gradients at 1e-8.
``gp_log_likelihood_jac`` against ``jax.jacfwd`` of JAX's ``blocked``
(tests/test_tangent.py's reference), with a mean-parameter direction and
in chunks of two directions.  The GP routes are in
tests/test_torch_tangent_gp.py.  The CUDA kernels are held against these
plain versions by tests/test_torch_kernels.py (marked ``cuda``) and by
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from celerite_tpu import terms as jterms
from celerite_tpu.ops import blocked as jblocked
from celerite_tpu.ops import fused as jfused
from celerite_tpu.ops import tangent as jtangent
from celerite_tpu.ops.lower import Coefficients as JCoefficients
from celerite_tpu.ops.lower import lower as jlower
from celerite_torch import terms as tterms
from celerite_torch.ops import dsfused, tangent
from celerite_torch.ops.lower import Coefficients, lower
from celerite_torch.testing import make_data, width_kernel


def _streams(width, n, b, T, seed=1):
    """JAX's lane layout of a width-``width`` model on ``b`` lanes and T
    random tangent streams: numpy ``(u, v, ph, a, y)`` and ``(du, dv, dph,
    da, dy)``."""
    k = width_kernel(jterms, width)
    th = jnp.asarray(k.get_parameter_vector())
    cs = [jnp.asarray(c) for c in (*k.get_padded_coefficients(th),
                                   k.get_jitter(th))]
    t, y, yerr = make_data(n, seed=seed, t_max=50.0)
    ssm = jlower(JCoefficients(*cs[:6], jitter=cs[6]), jnp.asarray(t),
                 jnp.asarray(yerr**2))
    s = [np.array(x) for x in jfused._to_lanes(ssm, jnp.asarray(y), b)[:5]]
    rng = np.random.default_rng(seed)
    d = [0.01 * rng.standard_normal((x.shape[0], T) + x.shape[1:])
         for x in s]
    return s, d


def _close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want.reshape(got.shape), rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def test_split_kernels_match_jax():
    """Padded width 5, T = 3, N = 256 on 8 lanes: each output of the plain
    elements and factor kernels; the factor takes the port's seeds."""
    s, d = _streams(5, 256, 8, 3)
    ts, td = [list(map(torch.as_tensor, x)) for x in (s, d)]
    el = tangent.elements_jvp_reference(*ts[:4], *td[:4])
    want = jax.jit(jtangent._run_elements_jvp, static_argnums=8)(
        *s[:4], *d[:4], True)
    for got, w in zip(el, want):
        _close(got, w, 1e-10)
    sh = dsfused.prefix_sh0_ds(*(torch.cat([x[None], dx])
                                 for x, dx in zip(el[:3], el[3:])), 8)
    fac = tangent.factor_jvp_reference(sh[0], sh[1:], *ts, *td)
    want = jax.jit(jtangent._run_factor_jvp, static_argnums=12)(
        sh[0].numpy(), sh[1:].numpy(), *s, *d, True)
    for got, w in zip(fac, want):
        _close(got, w, 1e-10)


def test_jac_impl_matches_jax():
    """The split pipeline with its forward-mode glue, both packages, at
    padded width 5 (JAX's ``_jac_impl`` takes the split pair at any
    width): ll at 1e-10, dll at 1e-8; and the plain single-sweep kernel
    with tangents gives the same."""
    s, d = _streams(5, 256, 8, 3, seed=2)
    ll_j, ok_j, dll_j = jax.jit(jtangent._jac_impl,
                                static_argnums=(10, 11))(*s, *d, 256, True)
    args = [torch.as_tensor(x) for x in s + d]
    ll, ok, dll = tangent._jac_impl(*args, 256)
    assert bool(ok[0]) and bool(ok_j)
    np.testing.assert_allclose(float(ll[0]), float(ll_j), rtol=1e-10)
    _close(dll[:, 0], dll_j, 1e-8)
    ll2, ok2, dll2 = tangent._run_fused_jac(*args, 256)
    np.testing.assert_allclose(float(ll2[0]), float(ll_j), rtol=1e-10)
    _close(dll2[:, 0], dll_j, 1e-8)


def test_fused_jac_matches_jax():
    """The single-sweep kernel with tangents, padded width 5, T = 5, N =
    256 on 8 lanes: ll at 1e-10, dll at 1e-8."""
    s, d = _streams(5, 256, 8, 5, seed=3)
    ll_j, ok_j, dll_j = jax.jit(jtangent._run_fused_jac,
                                static_argnums=(10, 11))(*s, *d, 256, True)
    ll, ok, dll = tangent.run_jac_kernel(*map(torch.as_tensor, s + d), 256)
    assert bool(ok) and bool(ok_j)
    np.testing.assert_allclose(float(ll), float(ll_j), rtol=1e-10)
    _close(dll, dll_j, 1e-8)


@pytest.mark.parametrize("num_blocks", [8, 16])
def test_gp_log_likelihood_jac_matches_jacfwd_blocked(num_blocks):
    """tests/test_tangent.py's reference: an SHO term plus a real term and a
    constant mean (a direction that moves the residual) at N = 600, against
    ``jax.jacfwd`` of JAX's ``blocked``, jitted; the single-sweep route on
    8 or 16 lanes, and in chunks of two directions."""
    rng = np.random.default_rng(1)
    n = 600
    t = np.sort(rng.uniform(0, 20, n))
    yerr = np.full(n, 0.2)
    y = np.sin(t) + 0.3
    jk = jterms.SHOTerm(log_S0=0.1, log_Q=1.0, log_omega0=0.3) \
        + jterms.RealTerm(log_a=0.2, log_c=-0.4)
    tk = tterms.SHOTerm(log_S0=0.1, log_Q=1.0, log_omega0=0.3) \
        + tterms.RealTerm(log_a=0.2, log_c=-0.4)
    nk = jk.full_size
    theta = np.concatenate([jk.get_parameter_vector(), [0.25]])

    def ll_ref(p):
        c = JCoefficients(*jk.get_padded_coefficients(p[:nk]),
                          jitter=jk.get_jitter(p[:nk]))
        return jblocked.gp_log_likelihood(
            jlower(c, jnp.asarray(t), jnp.asarray(yerr) ** 2),
            jnp.asarray(y) - p[nk])[0]

    ll0, jac = jax.jit(lambda p: (ll_ref(p), jax.jacfwd(ll_ref)(p)))(
        jnp.asarray(theta))

    def make(p):
        c = Coefficients(*tk.get_padded_coefficients(p[:nk]),
                         jitter=tk.get_jitter(p[:nk]))
        return (lower(c, torch.as_tensor(t), torch.as_tensor(yerr) ** 2),
                torch.as_tensor(y) - p[nk])

    th = torch.as_tensor(theta)
    eye = torch.eye(th.shape[0], dtype=th.dtype)
    vals, tans = torch.func.vmap(
        lambda e: torch.func.jvp(make, (th,), (e,)))(eye)
    ssm, resid = torch.utils._pytree.tree_map(lambda x: x[0], vals)
    ll, ok, dll = tangent.gp_log_likelihood_jac(
        ssm, resid, *tans, num_blocks=num_blocks)
    assert bool(ok)
    np.testing.assert_allclose(float(ll), float(ll0), rtol=1e-10)
    _close(dll, jac, 1e-8)
    ll2, ok2, dll2 = tangent.gp_log_likelihood_jac(
        ssm, resid, *tans, num_blocks=num_blocks, max_tangents=2)
    assert float(ll2) == float(ll)
    _close(dll2, dll.numpy(), 1e-13)


def test_tangent_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers take CUDA tensors only; the dispatchers take the
    plain versions for CPU streams; a jac launch needs a direction."""
    s = [torch.ones(4, 2, 3)] * 3 + [torch.ones(4, 1, 3)] * 2
    d = [torch.ones(4, 1, 2, 3)] * 3 + [torch.ones(4, 1, 1, 3)] * 2
    with pytest.raises(ValueError, match="CUDA tensor"):
        tangent.jac_cuda(*s, *d)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tangent.elements_jvp_cuda(*s[:4], *d[:4])
    with pytest.raises(ValueError, match="tangent direction"):
        tangent.jac_cuda(*s, *(x[:, :0] for x in d))
