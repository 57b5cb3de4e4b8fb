"""The config[1], config[2] and config[4] examples, ``utils.debug`` and
``plot_setup`` of the port on the CPU (no JAX).

The first two examples at a few dozen points with a few NUTS transitions
(trees of at most 8 leapfrogs: a test of their plumbing, not of the
sampler): config[1] ends in ``GP.predict(return_var=True)``, config[2]
draws its data with ``ops.smoother.sample_prior``; config[4] at 3 curves
and 8 particles for one SMC stage.  ``check_backends_agree`` on config[2]'s
SSM (seq, blocked, native where g++ is there, and the three-pass solver's
plain versions) and its AssertionError on a disagreement; ``debug_mode``
switching autograd's anomaly detection on and back; ``plot_setup``
imported with matplotlib blocked, ``setup()`` then raising ImportError.
"""

import importlib
import math
import sys

import numpy as np
import pytest
import torch

from celerite_torch import terms
from celerite_torch.inference import sample_nuts
from celerite_torch.ops import blocked
from celerite_torch.ops.lower import Coefficients, lower
from celerite_torch.testing import config2_kernel, make_data
from celerite_torch.utils import check_backends_agree, debug_mode


def _shallow_nuts(monkeypatch, module):
    def shallow(*args, **kwargs):
        return sample_nuts(*args, **{**kwargs, "max_tree_depth": 3})

    monkeypatch.setattr(module, "sample_nuts", shallow)


def test_example_config1_on_cpu(monkeypatch):
    from celerite_torch.examples import config1_sho_lightcurve

    _shallow_nuts(monkeypatch, config1_sho_lightcurve)
    stats, mu, var = config1_sho_lightcurve.main(
        n=48, warmup=3, samples=3, device="cpu")
    assert np.all(np.isfinite(stats["mean"]))
    assert mu.shape == var.shape == (500,)
    assert np.all(np.isfinite(mu)) and np.all(var >= 0)


def test_example_config2_on_cpu(monkeypatch):
    from celerite_torch.examples import config2_asteroseismic

    _shallow_nuts(monkeypatch, config2_asteroseismic)
    chain, info = config2_asteroseismic.main(
        n=48, chains=2, warmup=3, samples=3, warmup_depth=3, device="cpu")
    assert chain.shape == (2, 3, 7)
    assert torch.isfinite(chain).all()


def _ssm(n=300):
    t, y, yerr = make_data(n, seed=3, t_max=n / 10.0)
    k = config2_kernel(terms)
    coeffs = Coefficients(*(torch.as_tensor(c) for c in k.coefficients),
                          jitter=torch.tensor(k.jitter))
    ssm = lower(coeffs, torch.as_tensor(t), torch.as_tensor(yerr**2))
    return ssm, torch.as_tensor(y)


def test_check_backends_agree_on_cpu(monkeypatch):
    ssm, resid = _ssm()
    values = check_backends_agree(ssm, resid, rtol=1e-10,
                                  include_pallas=True)
    assert {"seq", "blocked", "pallas"} <= set(values)
    assert np.isfinite(values["seq"])
    real = blocked.gp_log_likelihood

    def shifted(ssm, resid):
        ll, ok = real(ssm, resid)
        return ll + 1.0, ok

    monkeypatch.setattr(blocked, "gp_log_likelihood", shifted)
    with pytest.raises(AssertionError, match="backend disagreement"):
        check_backends_agree(ssm, resid, include_native=False)


def test_debug_mode_sets_anomaly_detection():
    before = torch.is_anomaly_enabled()
    with debug_mode():
        assert torch.is_anomaly_enabled()
    assert torch.is_anomaly_enabled() == before
    with debug_mode(nans=False, disable_jit=True):
        assert not torch.is_anomaly_enabled()


def test_plot_setup_without_matplotlib(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.delitem(sys.modules, "celerite_torch.plot_setup",
                        raising=False)
    plot_setup = importlib.import_module("celerite_torch.plot_setup")
    assert plot_setup.get_figsize(6.0) == pytest.approx(
        (6.0, 6.0 / plot_setup.GOLDEN_RATIO))
    assert plot_setup.COLORS["DATA"] == "k"
    with pytest.raises(ImportError):
        plot_setup.setup()


def test_example_config4_on_cpu(monkeypatch):
    """The config[4] example at 3 curves and 8 particles, one stage of one
    mutation of two leapfrogs: the fleet likelihood's folded calls (8
    particles a call) through the gradient pipeline's plain versions."""
    from celerite_torch.examples import config4_pod_smc
    from celerite_torch.inference import sample_smc

    def short(*args, **kwargs):
        return sample_smc(*args, **{**kwargs, "num_leapfrog": 2})

    monkeypatch.setattr(config4_pod_smc, "sample_smc", short)
    res, log_like = config4_pod_smc.main(n_particles=8, n_curves=3,
                                         device="cpu", num_mutations=1,
                                         max_stages=1)
    assert log_like.chunk == 8 and log_like.plan.num_blocks == 24
    assert res.num_stages == 1
    assert res.particles.shape == (8, 3)
    assert bool(torch.isfinite(res.particles).all())
    assert math.isfinite(float(res.log_evidence))
    vals, grads = log_like.value_and_grad_batch(res.particles[:3])
    assert vals.shape == (3,) and grads.shape == (3, 3)
    assert bool(torch.isfinite(grads).all())
