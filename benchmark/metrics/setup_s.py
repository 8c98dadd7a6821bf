"""setup_s: seconds from the process's start to the window's: imports,
the CUDA context, the kernel build (first run of a checkout), the scene,
the IBL precompute, the graph captures and the warm-up frames."""


def read(run):
    return run["setup_s"]
