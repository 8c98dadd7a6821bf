"""ref_raster_ms.frame: device ms per probed replayed frame of
``raster_kernel``, which on the reference sampling path is the full-mode
raster (K6) and the shadow map re-rasterized every frame (K2)
(harness/metriclib.py)."""

from benchmark.harness.metriclib import probed_kernel_ms_per_unit

KERNELS = ("raster_kernel",)


def read(run):
    return probed_kernel_ms_per_unit(run, KERNELS)
