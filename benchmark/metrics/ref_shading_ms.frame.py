"""ref_shading_ms.frame: device ms per probed replayed frame of the
reference sampling path's shading kernel, K11 ``shade_ref_kernel``
(harness/metriclib.py)."""

from benchmark.harness.metriclib import probed_kernel_ms_per_unit

KERNELS = ("shade_ref_kernel",)


def read(run):
    return probed_kernel_ms_per_unit(run, KERNELS)
