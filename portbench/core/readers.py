"""Arithmetic that several metric readers (portbench/metrics/*.py) share.
A reader returns None where its run has nothing to read, never 0 for a
share."""

from __future__ import annotations


def kernel_share(rec, bound_ms_a_unit, match):
    """% of the least time of a unit's work in the device time of the
    kernels that do it, over the traced slice; None where the unit has no
    such work or the slice no such kernel."""
    t = rec.trace
    if bound_ms_a_unit is None or t is None or t.units <= 0:
        return None
    ms = t.kernel_ms(match)
    if ms <= 0:
        return None
    return 100.0 * bound_ms_a_unit * t.units / ms
