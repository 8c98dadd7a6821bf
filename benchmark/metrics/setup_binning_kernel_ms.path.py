"""setup_binning_kernel_ms.path: device ms per probed view of the
triangle setup and binning kernels (csrc/raster_setup.cu: the setup,
then the binning's count, scan and fill) at 4K (harness/metriclib.py).
A program without these kernels reads nothing."""

from benchmark.harness.metriclib import probed_kernel_ms_per_unit

KERNELS = ("tri_setup_kernel", "bin_count_kernel", "bin_scan_kernel",
           "bin_fill_kernel")


def read(run):
    return probed_kernel_ms_per_unit(run, KERNELS)
