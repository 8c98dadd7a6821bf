"""edit_frame_ms: the median host ms of the window's frames that carry a
spawn or a despawn (the topology layer: incremental_repack,
Renderer._sync_topology, and the full prepares)."""

import statistics


def read(run):
    times = run.get("edit_s")
    if not times:
        return None
    return statistics.median(times) * 1e3
