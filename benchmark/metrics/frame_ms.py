"""frame_ms: the window's wall time over its frames (each the runtime
systems and Renderer.render with the fetch to host memory)."""


def read(run):
    if "frame_s" not in run or not run["frame_s"]:
        return None
    return run["window_s"] / len(run["frame_s"]) * 1e3
