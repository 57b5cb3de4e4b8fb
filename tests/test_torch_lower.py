"""Lowering, double-single helpers and the lane plan against the JAX package.

- ``lower`` against ``celerite_tpu.ops.lower.lower`` in float64 at 1e-12;
- ``two_prod`` and ``reduced_angle`` in float32 within 1 ulp of JAX's (the
  conftest's SSE4_2 pin keeps the JAX side's compensated arithmetic exact);
- ``make_plan4`` streams and ``pack_cf`` equal to JAX's exactly, after the
  ``(L, 8, W)`` -> ``(L, B)`` reshape, for ``n_chain`` 1 and 2.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from celerite_tpu.ops import ds as jds, lanes4 as jl4, lower as jlower
from celerite_torch import convert
from celerite_torch.ops import ds as tds, lanes4 as tl4, lower as tlower
from celerite_torch.testing import CASES, make_data


def _coeffs(jr, jc, vals, jitter=0.05):
    vals = np.asarray(vals, np.float64)
    parts = [vals[:jr], vals[jr:2 * jr]] + [
        vals[2 * jr + k * jc: 2 * jr + (k + 1) * jc] for k in range(4)
    ]
    return parts + [np.float64(jitter)]


@pytest.mark.parametrize("jr,jc,vals", CASES)
@pytest.mark.parametrize("ds_grid", [False, True])
def test_lower_matches_jax(jr, jc, vals, ds_grid):
    t, y, yerr = make_data(64, seed=1, t_max=30.0)
    parts = _coeffs(jr, jc, vals)
    kw_j, kw_t = {}, {}
    if ds_grid:
        dt = np.concatenate([[0.0], np.diff(t)])
        t_lo = np.zeros_like(t)
        kw_j = dict(dt=jnp.asarray(dt), t_lo=jnp.asarray(t_lo))
        kw_t = dict(dt=torch.as_tensor(dt), t_lo=torch.as_tensor(t_lo))
    sj = jlower.lower(jlower.Coefficients(*[jnp.asarray(p) for p in parts]),
                      jnp.asarray(t), jnp.asarray(yerr**2), **kw_j)
    st = tlower.lower(tlower.Coefficients(*[torch.as_tensor(p) for p in parts]),
                      torch.as_tensor(t), torch.as_tensor(yerr**2), **kw_t)
    for a, b in zip(sj, st):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-12,
                                   atol=1e-15)


def test_two_prod_f32_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.uniform(-2e3, 2e3, 4096).astype(np.float32)
    b = rng.uniform(-5.0, 5.0, 4096).astype(np.float32)
    pj, ej = jds.two_prod(jnp.asarray(a), jnp.asarray(b))
    pt, et = tds.two_prod(torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_array_max_ulp(np.asarray(pj), pt.numpy(), maxulp=1)
    np.testing.assert_array_max_ulp(np.asarray(ej), et.numpy(), maxulp=1)
    # The pair is exact: p + e == a * b in float64.
    np.testing.assert_array_equal(
        pt.numpy().astype(np.float64) + et.numpy().astype(np.float64),
        a.astype(np.float64) * b.astype(np.float64),
    )


def test_reduced_angle_f32_matches_jax():
    rng = np.random.default_rng(4)
    t64 = np.sort(rng.uniform(0.0, 1000.0, 4096))
    hi, lo = jds.host_ds(t64)
    d = np.float32(2.7)
    rj = jds.reduced_angle(jnp.float32(d), jnp.asarray(hi), jnp.asarray(lo))
    rt = tds.reduced_angle(torch.tensor(d), torch.as_tensor(hi),
                           torch.as_tensor(lo))
    for a, b in zip(rj, rt):
        np.testing.assert_array_max_ulp(np.asarray(a), b.numpy(), maxulp=1)
    # And the angle itself: hi + lo == d*t mod 2 pi to float32 ulps.
    ref = np.mod(np.float64(d) * t64 + np.pi, 2 * np.pi) - np.pi
    got = rt[0].numpy().astype(np.float64) + rt[1].numpy()
    assert np.max(np.abs(got - ref)) < 1e-6


@pytest.mark.parametrize("n_chain", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_plan_matches_jax(n_chain, dtype):
    t, y, yerr = make_data(1001, seed=2, t_max=300.0)
    b = 64
    pj = jl4.make_plan4(t, y, yerr**2, b, dtype=np.dtype(dtype),
                        n_chain=n_chain)
    pt = tl4.make_plan4(t, y, yerr**2, b, dtype=getattr(torch, dtype),
                        n_chain=n_chain)
    L = pj.t.shape[0]
    assert pt.n == pj.n and pt.num_blocks == pj.num_blocks
    for name in ("t", "t_lo", "dt", "diag", "y", "mask"):
        a = np.asarray(getattr(pj, name)).reshape(L, -1)
        np.testing.assert_array_equal(a, getattr(pt, name).numpy())
    # The converter reproduces the port's plan from the JAX arrays.
    pc = convert.plan_from_numpy(
        *[np.asarray(getattr(pj, k)) for k in
          ("t", "t_lo", "dt", "diag", "y", "mask")], pj.n, pj.num_blocks)
    for name in ("t", "t_lo", "dt", "diag", "y", "mask"):
        assert torch.equal(getattr(pc, name), getattr(pt, name))


@pytest.mark.parametrize("jr,jc,vals", CASES)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pack_cf_matches_jax(jr, jc, vals, dtype):
    parts = _coeffs(jr, jc, vals, jitter=0.3)
    cj = jl4.pack_cf(jlower.Coefficients(*[jnp.asarray(p) for p in parts]),
                     dtype=getattr(jnp, dtype))
    ct = tl4.pack_cf(tlower.Coefficients(*[torch.as_tensor(p) for p in parts]),
                     dtype=getattr(torch, dtype))
    assert ct.shape == (tl4.cf_len(jr, jc),)
    np.testing.assert_array_equal(np.asarray(cj), ct.numpy())


def test_plan_rejects_bad_lane_counts():
    t, y, yerr = make_data(32)
    with pytest.raises(ValueError):
        tl4.make_plan4(t, y, yerr**2, 12)
    with pytest.raises(ValueError):
        tl4.make_plan4(t, y, yerr**2, 16, n_chain=3)
