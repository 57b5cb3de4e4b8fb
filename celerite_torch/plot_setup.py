"""Matplotlib styling for docs/paper-style figures.

Copy of ``celerite_tpu/plot_setup.py``, the parity shim for the
reference's celerite/plot_setup.py: a neutral color cycle and rcParams
setup used by the example scripts.  matplotlib is an optional dependency —
importing this module is safe without it; only ``setup()`` requires it.
"""

from __future__ import annotations

__all__ = ["COLORS", "setup", "get_figsize"]

COLORS = {
    "DATA": "k",
    "MODEL_1": "#1f77b4",
    "MODEL_2": "#ff7f0e",
    "MODEL_3": "#2ca02c",
    "MODEL_4": "#d62728",
}

GOLDEN_RATIO = 1.61803398875


def get_figsize(width=6.0):
    return (width, width / GOLDEN_RATIO)


def setup(auto=False):
    """Apply the plotting style; returns the matplotlib module."""
    import matplotlib

    if auto:
        matplotlib.use("Agg")
    from matplotlib import rcParams

    rcParams["figure.figsize"] = get_figsize()
    rcParams["font.size"] = 12
    rcParams["axes.prop_cycle"] = matplotlib.cycler(
        color=[
            COLORS["MODEL_1"],
            COLORS["MODEL_2"],
            COLORS["MODEL_3"],
            COLORS["MODEL_4"],
        ]
    )
    rcParams["axes.grid"] = False
    rcParams["savefig.dpi"] = 150
    rcParams["savefig.bbox"] = "tight"
    return matplotlib
