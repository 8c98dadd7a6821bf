"""setup_binning_kernel_ms.frame: device ms per probed replayed frame of
the triangle setup and binning kernels (csrc/raster_setup.cu: the setup,
then the binning's count, scan and fill), every tiling the frame runs:
the frame's own, and on the reference sampling path the shadow map's
(harness/metriclib.py).  A program without these kernels reads nothing."""

from benchmark.harness.metriclib import probed_kernel_ms_per_unit

KERNELS = ("tri_setup_kernel", "bin_count_kernel", "bin_scan_kernel",
           "bin_fill_kernel")


def read(run):
    return probed_kernel_ms_per_unit(run, KERNELS)
