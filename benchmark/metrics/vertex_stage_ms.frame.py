"""vertex_stage_ms.frame: device ms per frame of the per-vertex stage
(passes/vertex_stage.py ``run_vertex_stage``, the reference sampling
path's first pass), from the pass ranges of eager frames of the traced
pose (harness/trace.py ``profile_passes``)."""


def read(run):
    passes = run.get("trace", {}).get("passes")
    if not passes:
        return None
    ms = passes.get("vertex stage", 0.0)
    return ms if ms > 0 else None
