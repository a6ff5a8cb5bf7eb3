"""Percent of the window in which the device was idle: the device's busy
time a call, read from the traced stretch, against the window's wall time
a call (tracing.py:idle_share)."""

from benchmark.tracing import idle_share


def read(record: dict):
    return idle_share(record)
