"""Example programs of the port, one per BASELINE config it can run:
``python -m celerite_torch.examples.<name>`` (on the card; each ``main``
takes ``device="cpu"``).  ``config0_realterm_nuts``,
``config1_sho_lightcurve``, ``config2_asteroseismic`` and
``config3_complex_advi`` port the same-named scripts of ``examples/``;
config[4] waits for the fleet slices (ROADMAP queue 1 items 7, 13 and
15).
"""
