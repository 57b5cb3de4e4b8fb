"""The port's gradient pipeline against the JAX package and against autograd.

``celerite_torch.ops.fused4.build_ll_and_grad`` on a CPU plan runs the plain
versions of the four gradient kernels (``elem_fwd`` / ``factor_fwd`` /
``factor_bwd`` / ``elem_bwd``) and the float64 torch glue.  Its cf and y
cotangents are held against ``celerite_tpu.ops.fused4.build_ll_and_grad`` in
interpret mode on the same plan (JAX's own bar, tests/test_fused4.py:
1e-9 relative, 1e-12 absolute; the chain-folded and one-step cases are in
tests/test_torch_grad_fold.py), and against autograd through the port's
``primal_reference``, an independent check.  The CUDA kernels are held
against these plain versions by tests/test_torch_kernels.py (marked
``cuda``) and by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from celerite_tpu.ops import fused4 as jf4, lanes4 as jl4
from celerite_torch.ops import fused4, lanes4
from celerite_torch.testing import CASES, make_data, pack_values

N, B = 257, 32


def _plans(n=N, b=B, n_chain=1, seed=3):
    t, y, yerr = make_data(n, seed=seed)
    pj = jl4.make_plan4(t, y, yerr**2, b, dtype=np.float64, n_chain=n_chain)
    pt = lanes4.make_plan4(t, y, yerr**2, b, dtype=torch.float64,
                           n_chain=n_chain, device="cpu")
    return pj, pt


def _jax_grads(pj, jr, jc, cf, n_chain=1):
    """(ll, d ll/d cf, d ll/d y) from JAX's pipeline in interpret mode; a
    folded batch's ll is summed over chains."""
    fn = jf4.build_ll_and_grad(pj, jr, jc, n_chain=n_chain, interpret=True)

    def total(c, y4):
        return jnp.sum(fn(c, y4)[0])

    ll, (gcf, gy) = jax.value_and_grad(total, argnums=(0, 1))(
        jnp.asarray(cf), pj.y)
    return float(ll), np.asarray(gcf), np.asarray(gy).reshape(gy.shape[0], -1)


def _torch_grads(fn, pt, cf):
    c = torch.tensor(cf, requires_grad=True)
    y4 = pt.y.clone().requires_grad_()
    ll, ok = fn(c, y4)
    assert bool(torch.all(ok))
    ll.sum().backward()
    return float(ll.sum()), c.grad.numpy(), y4.grad.numpy()


def _close(got, want, rtol=1e-9, atol=1e-12):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("jr,jc,vals", CASES)
def test_grad_pipeline_matches_jax(jr, jc, vals):
    pj, pt = _plans()
    cf = pack_values(jr, jc, vals)
    llj, gcfj, gyj = _jax_grads(pj, jr, jc, cf)
    llt, gcft, gyt = _torch_grads(fused4.build_ll_and_grad(pt, jr, jc), pt, cf)
    np.testing.assert_allclose(llt, llj, rtol=1e-12)
    _close(gcft, gcfj)
    _close(gyt, gyj)


@pytest.mark.parametrize("jr,jc,vals", CASES)
@pytest.mark.parametrize("n_chain", [1, 2])
def test_grad_pipeline_matches_autograd(jr, jc, vals, n_chain):
    """The hand-written transposes against autograd through the primal."""
    _, pt = _plans(n=301, b=16, n_chain=n_chain, seed=5)
    cf = pack_values(jr, jc, vals)
    if n_chain > 1:
        cf = np.stack([cf, cf * 1.05])
    llg, gcfg, gyg = _torch_grads(
        fused4.build_ll_and_grad(pt, jr, jc, n_chain=n_chain), pt, cf)
    lla, gcfa, gya = _torch_grads(fused4.build_ll(pt, jr, jc), pt, cf)
    np.testing.assert_allclose(llg, lla, rtol=1e-12)
    _close(gcfg, gcfa, atol=1e-12 * np.abs(gcfa).max())
    _close(gyg, gya, atol=1e-12 * np.abs(gya).max())


def test_grad_pipeline_segments():
    """One cf row over several 8-lane segments: the per-lane coefficient
    rows sum per segment, and no state crosses a segment boundary."""
    jr, jc, vals = CASES[1]
    _, pt = _plans(n=300, b=32, seed=6)
    cf = torch.as_tensor(pack_values(jr, jc, vals))
    A, J, C, sv0 = fused4.elem_fwd(cf, pt, jr, jc, seg=8)
    sh0 = fused4.prefix_sh0(A, J, C, 8)
    assert torch.all(sh0[..., ::8] == 0)
    whole = fused4.prefix_sh0(A, J, C, 32)
    assert torch.equal(sh0[..., :8], whole[..., :8])
    assert not torch.equal(sh0[..., 8:16], whole[..., 8:16])


def test_dispatchers_take_plain_versions_on_cpu():
    jr, jc, vals = CASES[2]
    _, pt = _plans(n=100, b=8)
    cf = torch.as_tensor(pack_values(jr, jc, vals))
    for a, b in zip(fused4.elem_fwd(cf, pt, jr, jc),
                    fused4.elem_fwd_reference(cf, pt, jr, jc)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", fused4.GRAD_KERNELS)
def test_grad_wrappers_reject_cpu_tensors(name):
    """A kernel wrapper takes CUDA tensors only; it never runs the plain
    version (checked before any kernel is loaded, so no card is needed)."""
    jr, jc, vals = CASES[0]
    _, pt = _plans(n=64, b=8)
    cf = torch.as_tensor(pack_values(jr, jc, vals))
    p, b, L = 1, 8, pt.t.shape[0]
    z = torch.zeros
    args = {
        "elem_fwd": (),
        "factor_fwd": (pt.y, z(p, p, b, dtype=torch.float64)),
        "factor_bwd": (pt.y, z(L, 2 * p * p + p, b, dtype=torch.float64),
                       z(p, p, b), z(p, b), z(p, p, b), z(p, b), z(b), z(b)),
        "elem_bwd": (z(L, 2 * p * p, b, dtype=torch.float64), z(p, p, b),
                     z(p, p, b), z(p, p, b)),
    }[name]
    before = getattr(fused4, name + "_cuda").launches
    with pytest.raises(ValueError, match="CUDA"):
        getattr(fused4, name + "_cuda")(cf, pt, jr, jc, *args)
    assert getattr(fused4, name + "_cuda").launches == before
