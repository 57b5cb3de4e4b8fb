"""Example programs of the port, one per BASELINE config it can run:
``python -m celerite_torch.examples.<name>`` (on the card; each ``main``
takes ``device="cpu"``).  ``config0_realterm_nuts`` and
``config3_complex_advi`` port ``examples/config0_realterm_nuts.py`` and
``examples/config3_complex_advi.py``; config[1] and config[2] wait for the
predictive variance and the prior sampler (ROADMAP queue 1 item 11),
config[4] for the fleet slices (items 7, 13 and 15).
"""
