"""Example programs of the port, one per BASELINE config it can run:
``python -m celerite_torch.examples.<name>`` (on the card; each ``main``
takes ``device="cpu"``).  ``config0_realterm_nuts``,
``config1_sho_lightcurve``, ``config2_asteroseismic``,
``config3_complex_advi`` and ``config4_pod_smc`` port the same-named
scripts of ``examples/``; config[4] runs ``sample_smc`` on one card, where
the JAX example shards the particles over a mesh (ROADMAP queue 1 item
15).
"""
