"""Utilities of the port: :mod:`.timer`."""
