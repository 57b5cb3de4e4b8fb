"""Chain folding of the port's gradient pipeline against the JAX package.

A ``(4, C)`` coefficient batch on a chain-folded plan, a one-step grid
(L = 1) and ``lanes4.fold_lanes``: the port's plain pipeline against
``celerite_tpu.ops.fused4.build_ll_and_grad(..., interpret=True)`` at 1e-9
relative, 1e-12 absolute (tests/test_fused4.py's bar), and the folding
itself exactly.  Kept apart from tests/test_torch_grad.py so the two
interpret-mode files run on separate workers.
"""

import numpy as np
import torch

import jax.numpy as jnp

from celerite_tpu.ops import lanes4 as jl4
from celerite_torch import convert
from celerite_torch.ops import fused4, lanes4
from celerite_torch.testing import CASES, make_data, pack_values
from test_torch_grad import _close, _jax_grads, _plans, _torch_grads


def test_grad_pipeline_chain_folded_matches_jax():
    jr, jc, vals = CASES[3]
    pj, pt = _plans(n_chain=4)
    cf = pack_values(jr, jc, vals)
    cfs = np.stack([cf * s for s in (1.0, 0.9, 1.1, 1.2)])
    llj, gcfj, gyj = _jax_grads(pj, jr, jc, cfs, n_chain=4)
    fn = fused4.build_ll_and_grad(pt, jr, jc, n_chain=4)
    llt, gcft, gyt = _torch_grads(fn, pt, cfs)
    assert gcft.shape == cfs.shape
    np.testing.assert_allclose(llt, llj, rtol=1e-12)
    _close(gcft, gcfj)
    _close(gyt, gyj)


def test_grad_pipeline_one_step_grid_matches_jax():
    """L = 1: every lane one step, so the prefixes carry all the state."""
    jr, jc, vals = CASES[2]
    pj, pt = _plans(n=29, b=32)
    assert tuple(pt.t.shape) == (1, 32)
    cf = pack_values(jr, jc, vals)
    llj, gcfj, gyj = _jax_grads(pj, jr, jc, cf)
    llt, gcft, gyt = _torch_grads(fused4.build_ll_and_grad(pt, jr, jc), pt, cf)
    np.testing.assert_allclose(llt, llj, rtol=1e-12)
    _close(gcft, gcfj)
    _close(gyt, gyj)


def test_fold_lanes_matches_jax():
    """Per-chain values folded onto lanes: JAX's (L, 8, W) tiling carried
    through ``plan_from_numpy``'s reshape equals the port's (L, B) tiling,
    exactly; and it equals the folded plan's own y stream."""
    nc, n, b = 4, 250, 16
    rng = np.random.default_rng(11)
    x = rng.standard_normal((nc, n))
    L = -(-n // b)
    xj = np.asarray(jl4.fold_lanes(jnp.asarray(x), b, L))
    xt = lanes4.fold_lanes(torch.as_tensor(x), b, L)
    carried = convert.plan_from_numpy(xj, xj, xj, xj, xj, xj, n, nc * b,
                                      device="cpu").y
    assert xt.shape == (L, nc * b)
    np.testing.assert_array_equal(xt.numpy(), carried.numpy())
    t, y, yerr = make_data(n, seed=2)
    pt = lanes4.make_plan4(t, y, yerr**2, b, dtype=torch.float64,
                           n_chain=nc, device="cpu")
    assert tuple(pt.y.shape) == (L, nc * b)
    folded = lanes4.fold_lanes(torch.as_tensor(np.tile(y, (nc, 1))), b, L)
    np.testing.assert_array_equal(folded.numpy(), pt.y.numpy())
