"""Utilities of the port: :mod:`.timer` and :mod:`.debug`."""

from .debug import check_backends_agree, debug_mode  # noqa: F401
