"""The shading pass's share of its roofline: K9's work (counted from the
reference's calls on the probed frames' poses) at the card's peaks, over
its kernel's device time on the same frames (harness/metriclib.py)."""

from benchmark.harness.metriclib import roofline_pct

NEEDS = ("work",)
KERNELS = ("shade_kernel",)


def read(run):
    return roofline_pct(run, "shading", KERNELS)
