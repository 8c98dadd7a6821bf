"""The readers of the port's tracer (harness/program.py) on synthetic
records: a parent's record reads nothing, the program's ranges stay out
of the device's operations, idle time goes to the innermost range of
either kind, and operations between two pass markers go to that pass."""

import types

import pytest

from benchmark.harness import program, trace
from mo_renderer_tpu_torch.kernels.mark import END, PASSES

from .test_harness_metrics import record as parent_record


def mark(k):
    return f"void mo_mark_kernel<{k}>()"


def test_every_reader_reads_nothing_on_a_parent_record():
    run = {"trace": parent_record(), "frame_s": [0.003] * 10,
           "setup_s": 12.0}
    for name, read in program.READERS.items():
        assert read(run) is None, name
    assert program.marked_passes(parent_record()) is None
    assert program.idle_under(parent_record(), "render_device") is None


def _event(name, start, end, cuda, id_=0):
    import torch

    kind = (torch.autograd.DeviceType.CUDA if cuda
            else torch.autograd.DeviceType.CPU)
    return types.SimpleNamespace(
        name=name, device_type=kind, id=id_,
        time_range=types.SimpleNamespace(start=start, end=end))


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_record_keeps_program_ranges_off_the_device_row():
    events = [_event("bench::window", 0, 100, False),
              _event("mo::render_device", 10, 60, False),
              _event("mo::render_device", 10, 60, True),
              _event("cudaGraphLaunch", 20, 25, False, 7),
              _event(mark(0), 30, 31, True, 7),
              _event("raster_kernel<1, false>(Args)", 31, 40, True, 7),
              _event(mark(END), 40, 41, True, 7),
              _event("Memcpy DtoH (Device -> Pageable)", 60, 90, True, 9)]
    parent = [e for e in events if not e.name.startswith("mo::")]
    rec = program.record(_Prof(events), 1)
    assert [o[0] for o in rec["device_ops"]] == [
        mark(0), "raster_kernel<1, false>(Args)", mark(END),
        "Memcpy DtoH (Device -> Pageable)"]
    assert rec["program_ranges"] == [("mo::render_device", 10.0, 60.0)]
    assert [len(g) for g in rec["graph_ops"]] == [3]
    # the parent's program has no such range: the harness's record agrees
    assert (program.record(_Prof(parent), 1)["device_ops"]
            == trace.record(_Prof(parent), 1)["device_ops"])
    assert trace.busy_us(rec) == pytest.approx(1 + 9 + 1 + 30)


def test_idle_goes_to_the_innermost_range_of_either_kind():
    rec = {"host_ranges": [("bench::window", 0.0, 100.0),
                           ("bench::render_device", 0.0, 80.0)],
           "program_ranges": [("mo::render_device", 5.0, 80.0),
                              ("mo::replay", 40.0, 60.0),
                              ("mo::sync_topology", 10.0, 20.0)],
           "device_ops": [("k", 80.0, 100.0)]}
    assert program.idle_split(rec) == pytest.approx({
        "render_device": 5e-6, "mo::render_device": 45e-6,
        "mo::sync_topology": 10e-6, "mo::replay": 20e-6})
    under = program.idle_under(rec, "render_device")
    assert under["total_s"] == pytest.approx(75e-6)
    assert under["self_s"] == pytest.approx(45e-6)
    assert under["children_s"] == pytest.approx(30e-6)


def test_operations_between_two_markers_go_to_that_pass():
    setup, binning = PASSES.index("triangle setup"), PASSES.index("binning")
    shadow = PASSES.index("shadow")

    def replay(t, extra=0.0):
        return [(mark(0), t, t + 1),
                (mark(setup), t + 1, t + 2), ("sort", t + 2, t + 12 + extra),
                (mark(0), t + 12 + extra, t + 13 + extra),
                (mark(binning), t + 13 + extra, t + 14 + extra),
                ("scan", t + 14 + extra, t + 20 + extra),
                (mark(0), t + 20 + extra, t + 21 + extra),
                ("copy", t + 21 + extra, t + 23 + extra),
                (mark(END), t + 23 + extra, t + 24 + extra)]

    ops = (replay(0.0) + [("Memcpy DtoD", 30.0, 35.0)]
           + [(mark(shadow), 40.0, 41.0), ("depth", 41.0, 51.0),
              (mark(END), 51.0, 52.0)]
           + replay(100.0, extra=2.0))
    graphs = [replay(0.0), replay(100.0, extra=2.0),
              [("stray", 38.0, 39.0)] + ops[10:13]]
    got = program.marked_passes({"device_ops": ops, "graph_ops": graphs})
    assert got["replays"] == 2 and got["shadow_replays"] == 1
    assert got["ms"]["triangle setup"] == pytest.approx(11e-3)
    assert got["ms"]["binning"] == pytest.approx(6e-3)
    assert got["ms"]["frame"] == pytest.approx(2e-3)
    assert got["shadow_ms"] == pytest.approx(10e-3)
    assert got["marker_us"] == pytest.approx((6 + 6 + 2) / 2)
    assert got["unmarked"] == 1  # the stray operation before a launch's mark
    run = {"trace": {"device_ops": ops, "graph_ops": graphs}}
    assert program.replay_setup_binning_ms(run) == pytest.approx(17e-3)


def test_span_readers_on_a_program_record():
    ms = 1_000_000
    spans = [("prepare", None, 0, 0, 900 * ms),
             ("ibl_precompute", 0, 0, 100 * ms, 800 * ms),
             # the window: a repack frame, a plain one, a prepare frame
             ("frame", None, 1, 1000 * ms, 1010 * ms),
             ("repack", 2, 1, 1001 * ms, 1005 * ms),
             ("frame", None, 2, 1010 * ms, 1013 * ms),
             ("frame", None, 3, 1013 * ms, 1613 * ms),
             ("render_device", 5, 3, 1013 * ms, 1610 * ms),
             ("prepare", 6, 3, 1014 * ms, 1600 * ms),
             ("frame", None, 4, 1613 * ms, 1616 * ms),
             ("repack", 8, 4, 1613 * ms, 1615 * ms),
             # the traced stretch
             ("render_device", None, 5, 2000 * ms, 2002 * ms),
             ("render_device", None, 6, 2010 * ms, 2014 * ms)]

    def point(n, prepares):
        return {"n_spans": n, "counters": {"prepares": prepares}}

    run = {"frame_s": [0.003] * 500,
           "program": {"setup_start": point(0, 0),
                       "window_start": point(2, 1),
                       "window_end": point(10, 2),
                       "traced_start": point(10, 2),
                       "traced_end": point(12, 2), "spans": spans}}
    r = program.READERS
    assert r["ibl_precompute_s"](run) == pytest.approx(0.7)
    assert r["repack_ms"](run) == pytest.approx(3.0)
    assert r["full_prepares_per_kframe"](run) == pytest.approx(2.0)
    assert r["prepare_frame_ms"](run) == pytest.approx(600.0)
    assert r["render_device_host_ms"](run) == pytest.approx(3.0)
    split = program.window_split(run)
    assert split["all"]["frame"] == pytest.approx(616 / 4)
    assert split["all"]["repack"] == pytest.approx(6 / 4)
    assert split["prepare"] == pytest.approx(
        {"frame": 600, "render_device": 597, "prepare": 586})
