"""The G-buffer pass's share of its roofline: its work (the attribute
planes, K3, and the tail, K10, counted from the reference's calls on
the probed views' poses) at the card's peaks, over the device time of
those kernels on the same views (harness/metriclib.py)."""

from benchmark.harness.metriclib import roofline_pct

NEEDS = ("work",)
KERNELS = ("attr_planes_kernel", "gbuffer_kernel")


def read(run):
    return roofline_pct(run, "gbuffer", KERNELS)
