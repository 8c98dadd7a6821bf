"""The metric arithmetic on synthetic records."""

import importlib.util
import os

import pytest

from benchmark.harness import trace

from .conftest import REPO


def reader(name):
    path = os.path.join(REPO, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def record():
    """A 1000 us window of 2 frames: a G-buffer pair, a shade kernel, a
    fetch and an overlapping pair; idle 0-100, 300-400, 700-1000.  The
    first frame (0-600) is probed; the second repeats its G-buffer pair
    after 600."""
    return {
        "units": 2,
        "probed_units": 1,
        "host_ranges": [("bench::window", 0.0, 1000.0),
                        ("bench::probe", 0.0, 600.0),
                        ("bench::runtime_systems", 0.0, 120.0),
                        ("bench::fetch", 690.0, 1000.0)],
        "device_ops": [
            ("void attr_planes_kernel<3>(int*, float*)", 100.0, 150.0),
            ("gbuffer_kernel(GbufArgs)", 150.0, 250.0),
            ("gbuffer_ref_kernel(Args)", 250.0, 300.0),
            ("shade_kernel(ShadeArgs)", 400.0, 500.0),
            ("Memcpy DtoH (Device -> Pageable)", 500.0, 700.0),
            ("elementwise", 450.0, 550.0),
            ("void attr_planes_kernel<3>(int*, float*)", 700.0, 710.0),
            ("gbuffer_kernel(GbufArgs)", 710.0, 720.0),
        ],
    }


def test_busy_idle_and_gaps():
    rec = record()
    assert trace.busy_us(rec) == pytest.approx(520.0)
    assert trace.idle_gaps(rec) == [(0.0, 100.0), (300.0, 400.0),
                                    (720.0, 1000.0)]
    assert reader("device_idle_pct.frame")({"trace": rec}) == \
        pytest.approx(48.0)
    assert reader("device_idle_pct.path")({"trace": rec}) == \
        pytest.approx(48.0)


def test_breakdown_names_ops_and_the_host_range_of_each_gap():
    b = trace.breakdown(record())
    assert b["device_ops"][0] == ["Memcpy DtoH (Device -> Pageable)",
                                  pytest.approx(200e-6)]
    assert ["attr_planes_kernel<3>", pytest.approx(60e-6)] in \
        b["device_ops"]
    gaps = dict(b["idle_gaps"])
    # 0-100 in runtime_systems; 300-400 in no range (the probe's range
    # marks a frame, not a call); 720-1000 in fetch
    assert gaps["fetch"] == pytest.approx(280e-6)
    assert gaps["runtime_systems"] == pytest.approx(100e-6)
    assert gaps["outside any range"] == pytest.approx(100e-6)
    assert "probe" not in gaps
    split = trace.host_split(record(), 50.0, 700.0)
    assert split == {"runtime_systems": pytest.approx(70.0),
                     "outside any range": pytest.approx(570.0),
                     "fetch": pytest.approx(10.0)}


def test_range_annotations_on_the_device_row_are_no_operations():
    class Evt:
        def __init__(self, name, cuda, a, b):
            import torch

            self.name = name
            self.device_type = (torch.autograd.DeviceType.CUDA if cuda
                                else torch.autograd.DeviceType.CPU)
            self.time_range = type("T", (), {"start": a, "end": b})

    class Prof:
        def events(self):
            return [Evt("bench::window", False, 0, 10),
                    Evt("bench::render_device", True, 1, 9),
                    Evt("pass::binning", True, 2, 3),
                    Evt("shade_kernel(Args)", True, 4, 5)]

    rec = trace.record(Prof(), 1)
    assert rec["device_ops"] == [("shade_kernel(Args)", 4.0, 5.0)]
    assert rec["host_ranges"] == [("bench::window", 0.0, 10.0)]


def test_fetch_and_roofline_shares():
    rec = record()
    assert reader("fetch_ms")({"trace": rec}) == pytest.approx(0.1)
    for name in ("gbuffer_roofline.frame", "shading_roofline.path"):
        assert reader(name)({"trace": dict(rec, probed_units=0),
                             "work": run_work()}) is None
    run = {"trace": rec, "work": {"gbuffer": 0.12, "shading": 0.02}}
    # the probed frame's G-buffer kernels take 150 us and its shading
    # 100 us; the second frame's pair after 600 is not the probed work's
    assert reader("gbuffer_roofline.frame")(run) == pytest.approx(80.0)
    assert reader("gbuffer_roofline.path")(run) == pytest.approx(80.0)
    assert reader("shading_roofline.frame")(run) == pytest.approx(20.0)
    assert reader("shading_roofline.path")(run) == pytest.approx(20.0)


def run_work():
    return {"gbuffer": 0.12, "shading": 0.02}


def test_readers_return_nothing_without_their_source():
    for name in ("fetch_ms", "setup_binning_ms", "gbuffer_roofline.frame",
                 "shading_roofline.path", "device_idle_pct.frame",
                 "edit_frame_ms", "frame_ms", "frame_ms_p99",
                 "views_per_s"):
        assert reader(name)({}) is None, name
    no_work = {"trace": record()}
    assert reader("gbuffer_roofline.frame")(no_work) is None


def test_host_clock_metrics():
    run = {"frame_s": [0.004] * 99 + [0.020], "window_s": 0.416,
           "edit_s": [0.01, 0.03, 0.02], "setup_s": 12.5,
           "views": 640, "trace": {"passes": {"triangle setup": 0.3,
                                              "binning": 0.5, "raster": 1}}}
    assert reader("frame_ms")(run) == pytest.approx(4.16)
    assert 4.0 < reader("frame_ms_p99")(run) <= 20.0
    assert reader("edit_frame_ms")(run) == pytest.approx(20.0)
    assert reader("setup_s")(run) == 12.5
    assert reader("views_per_s")(run) == pytest.approx(640 / 0.416)
    assert reader("setup_binning_ms")(run) == pytest.approx(0.8)
