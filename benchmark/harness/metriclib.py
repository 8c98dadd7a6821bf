"""Arithmetic the metric readers share: device time of named kernels in
a traced run, and a pass's share of its roofline."""

from __future__ import annotations

from . import trace


def probed_kernel_ms_per_unit(run: dict, kernels) -> float | None:
    """Device ms per probed frame (or view) of the operations named
    ``kernels`` that started inside a ``bench::probe`` range: the time of
    the very frames whose work ``run["work"]`` counts (each probed frame
    or call ends in a synchronise, so its operations lie in its range)."""
    rec = run.get("trace")
    if not rec or not rec.get("probed_units"):
        return None
    probes = [(a, b) for name, a, b in rec["host_ranges"]
              if name == trace.PROBE]
    us = sum(e - s for name, s, e in rec["device_ops"]
             if trace.label(name).split("<")[0] in kernels
             and any(a <= s < b for a, b in probes))
    return us / 1e3 / rec["probed_units"] if us > 0 else None


def roofline_pct(run: dict, work_key: str, kernels) -> float | None:
    """100 x the pass's bound ms per probed frame (``run["work"]``, from
    the reference's calls on the probed frames' poses and worlds) over
    its kernels' device ms on those frames."""
    bound = run.get("work", {}).get(work_key)
    ms = probed_kernel_ms_per_unit(run, kernels)
    if bound is None or ms is None:
        return None
    return 100.0 * bound / ms


def idle_pct(run: dict) -> float | None:
    """100 x the share of the traced window with nothing on the device."""
    rec = run.get("trace")
    if not rec or not rec["device_ops"]:
        return None
    a, b = trace.window(rec)
    return 100.0 * (1.0 - trace.busy_us(rec) / (b - a))
