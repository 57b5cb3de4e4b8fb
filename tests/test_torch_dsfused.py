"""The port's exact-mode pipeline (``ops/dsfused``) against the JAX package.

On the CPU the pipeline runs its kernels' plain versions (forward mode of
the plain fused4 sweeps) and the forward-mode glue.  The JAX package's
dsfused kernels run only in interpret mode (minutes a case; its tests are
``slow``), so the JAX side here is its float64 route: the value at 1e-11
relative and ``jax.grad`` at 1e-9 in norm, the gradient taken to theta
through the VJP of ``pack_cf_ds`` on the port's side.  ``pack_cf_ds``
itself is held at 1e-15.  N = 256 on 16 lanes, for one SHO term (P = 4,
C = 9) and config[2]'s kernel (P = 8, C = 17), one to all directions a
launch.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import celerite_tpu
from celerite_tpu import terms as jterms
from celerite_tpu.ops import dsfused as jdsf
from celerite_tpu.ops.lower import Coefficients as JCoefficients
from celerite_torch import GP, convert, terms as tterms
from celerite_torch.ops import dsfused
from celerite_torch.ops.lower import Coefficients
from celerite_torch.testing import config2_kernel, make_data


def _sho(terms):
    return terms.SHOTerm(log_S0=0.1, log_Q=1.0, log_omega0=0.5)


KERNELS = {"sho": _sho, "config2": config2_kernel}
N, LANES = 256, 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors: the tests run in
    several worker processes at once, and per-op thread hand-offs then
    cost more than the arithmetic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(kname):
    jgp = celerite_tpu.GP(KERNELS[kname](jterms))
    rng = np.random.default_rng(3)
    v = jgp.get_parameter_vector()
    jgp.set_parameter_vector(v + 0.05 * rng.standard_normal(v.size))
    tgp = GP(KERNELS[kname](tterms), device="cpu")
    convert.load_parameters(
        tgp, jgp.get_parameter_names(include_frozen=True),
        jgp.get_parameter_vector(include_frozen=True), jgp.unfrozen_mask)
    return jgp, tgp


def _data():
    return make_data(N, seed=4, t_max=30.0)


@functools.lru_cache(maxsize=None)
def _jax_f64(kname):
    """JAX's float64 value and gradient at the pair's parameters."""
    jgp, _ = _pair(kname)
    t, y, yerr = _data()
    fl = jgp.build_loglik(t, y, yerr=yerr, solver="blocked")
    ll, g = jax.jit(jax.value_and_grad(lambda th: fl(th)[0]))(
        jnp.asarray(jgp.get_parameter_vector()))
    return float(ll), np.asarray(g)


def _packed(tgp, th):
    kp = th[:tgp.kernel.full_size]
    return dsfused.pack_cf_ds(Coefficients(
        *tgp.kernel.get_padded_coefficients(kp),
        jitter=tgp.kernel.get_jitter(kp)))


@pytest.mark.parametrize("kname", sorted(KERNELS))
def test_pack_cf_ds_matches_jax(kname):
    jgp, tgp = _pair(kname)
    theta = jgp.get_parameter_vector()
    k = jgp.kernel
    want = jdsf.pack_cf_ds(JCoefficients(
        *k.get_padded_coefficients(jnp.asarray(theta)),
        jitter=k.get_jitter(jnp.asarray(theta))), dtype=jnp.float64)
    got = _packed(tgp, torch.as_tensor(theta))
    pr, pc = tgp.kernel.padded_size
    assert got.shape == (dsfused.cf_len(pr, pc),)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-15,
                               atol=0)


@pytest.mark.parametrize("kname", sorted(KERNELS))
@pytest.mark.parametrize("chunk", [1, 4, None])
def test_plain_pipeline_matches_jax_f64(kname, chunk):
    """Value at 1e-11 relative, theta gradient at 1e-9 in norm, whatever
    the directions a launch (None: all C)."""
    jgp, tgp = _pair(kname)
    llj, gj = _jax_f64(kname)
    t, y, yerr = _data()
    plan = dsfused.make_plan_ds(t, y, yerr**2, LANES, device="cpu")
    pr, pc = tgp.kernel.padded_size
    fn = dsfused.build_ll_and_grad_ds(plan, pr, pc, tan_chunk=chunk)
    th = torch.tensor(jgp.get_parameter_vector(), requires_grad=True)
    cf = _packed(tgp, th)
    ll, ok, gcf = fn(cf.detach())
    (grad,) = torch.autograd.grad(cf, th, gcf)
    assert bool(ok) and gcf.shape == cf.shape
    np.testing.assert_allclose(float(ll), llj, rtol=1e-11)
    assert np.linalg.norm(grad.numpy() - gj) <= 1e-9 * np.linalg.norm(gj)


def test_plain_value_launch_and_partial_directions():
    """The value launch alone (no tangents) gives the same ll, and
    ``tan_count`` leaves the later coefficients' gradient at 0."""
    _, tgp = _pair("config2")
    t, y, yerr = _data()
    plan = dsfused.make_plan_ds(t, y, yerr**2, LANES, device="cpu")
    pr, pc = tgp.kernel.padded_size
    cf = _packed(tgp, torch.as_tensor(tgp.get_parameter_vector()))
    ll, ok, g = dsfused.build_ll_and_grad_ds(plan, pr, pc)(cf)
    llv, okv = dsfused.build_ll_ds(plan, pr, pc)(cf)
    assert bool(okv) and float(llv) == float(ll)
    _, _, g5 = dsfused.build_ll_and_grad_ds(plan, pr, pc, tan_count=5,
                                            tan_chunk=2)(cf)
    np.testing.assert_allclose(g5[:5].numpy(), g[:5].numpy(), rtol=1e-12)
    assert bool((g5[5:] == 0).all())


def test_non_pd_gives_minus_inf_and_zero_gradient():
    t, y, _ = _data()
    plan = dsfused.make_plan_ds(t, y, np.full(N, 1e-12), LANES, device="cpu")
    # One complex term with a*c < b*d: not positive definite.
    cf = torch.tensor([0.1, 3.0, 0.05, 2.0, 0.0], dtype=torch.float64)
    ll, ok, g = dsfused.build_ll_and_grad_ds(plan, 0, 1)(cf)
    assert not bool(ok) and float(ll) == -np.inf
    assert bool((g == 0).all())
