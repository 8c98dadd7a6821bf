"""The share of the traced window in which no kernel and no copy ran on
the device."""

from benchmark.harness.metriclib import idle_pct


def read(run):
    return idle_pct(run)
