"""setup_binning_ms: device ms per frame of triangle setup and binning
(kernels/raster_setup.py), from the pass ranges of eager frames of the
traced pose (chip_smoke.py's profile_passes, copied in
harness/trace.py)."""

PASSES = ("triangle setup", "binning")


def read(run):
    passes = run.get("trace", {}).get("passes")
    if not passes:
        return None
    ms = sum(passes.get(p, 0.0) for p in PASSES)
    return ms if ms > 0 else None
