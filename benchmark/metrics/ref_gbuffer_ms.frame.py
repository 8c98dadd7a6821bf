"""ref_gbuffer_ms.frame: device ms per probed replayed frame of the
reference sampling path's G-buffer kernel, K12 ``gbuffer_ref_kernel``
(harness/metriclib.py)."""

from benchmark.harness.metriclib import probed_kernel_ms_per_unit

KERNELS = ("gbuffer_ref_kernel",)


def read(run):
    return probed_kernel_ms_per_unit(run, KERNELS)
