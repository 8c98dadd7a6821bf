"""frame_ms_p99: the 99th percentile of every window frame's host time
(the "1% low" of game benchmarks, where stutter shows)."""

import statistics


def read(run):
    times = run.get("frame_s")
    if not times or len(times) < 2:
        return None
    return statistics.quantiles(times, n=100)[98] * 1e3
