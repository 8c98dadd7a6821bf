"""views_per_s: view frames completed over the window, on all ranks."""


def read(run):
    if "views" not in run:
        return None
    return run["views"] / run["window_s"]
