"""shade_kernel_ms.frame: device ms per probed replayed frame of the fast
path's shading kernel, K9 ``shade_kernel`` (harness/metriclib.py): in a
cell of many lights its light loop, against the same kernel at the stock
five light rows."""

from benchmark.harness.metriclib import probed_kernel_ms_per_unit

KERNELS = ("shade_kernel",)


def read(run):
    return probed_kernel_ms_per_unit(run, KERNELS)
