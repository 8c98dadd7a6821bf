"""The reference sampling path's cell (``sponza_1080p_refsampling``): the
port with the configuration's ``engine`` against the plain reference on
the CPU, bit for bit over poses of the walk's orbit, also after a spawn
repacked in place and after its despawn; the cell found by its name with
its metrics; and its four readers on a synthetic record."""

import importlib.util
import json
import os

import numpy as np
import pytest

import mo_renderer_tpu_torch as P
from mo_renderer_tpu_torch.assets.ibl_resource import IBLResource

from benchmark.harness import spec, traffic, world
from benchmark.reference.render import ReferenceRenderer, ibl_maps
from benchmark.scenes import sponza_grid

from .conftest import REPO, TINY_IBL

CELL = "sponza_1080p_refsampling.walk"
CONFIG = os.path.join(REPO, "benchmark", "configs",
                      "sponza_1080p_refsampling.json")


def _pose(cam, orbit, i):
    """``cam`` at frame ``i``'s pose of ``orbit``, frame ``i - 1``'s
    before it (its previous view), as the frame loop moves it."""
    for k in (i - 1, i):
        pos, rot = orbit.pose(k)
        cam.transform.translation = pos
        cam.transform.rotation = rot
        cam.refresh_view()
    return cam


def _camera(api, orbit, i, cfg):
    cam = api.Camera(position=tuple(float(x) for x in orbit.pose(i)[0]),
                     rotation=orbit.pose(i)[1])
    cam.resize((cfg.width, cfg.height))
    return _pose(cam, orbit, i)


def _walk():
    with open(os.path.join(REPO, "benchmark", "traffic", "walk.json")) as f:
        return json.load(f)


def test_reference_path_frames_equal_the_ports_on_the_cpu():
    engine = json.load(open(CONFIG))["engine"]
    assert engine == {"fast_sampling": False}
    rec = sponza_grid.recipe(22, n_grid=3)
    papi, rapi = world.port_api(), world.reference_api()
    kw = dict(width=160, height=90, shadow_map_size=256, **engine)
    pcfg, rcfg = papi.EngineConfig(**kw), rapi.EngineConfig(**kw)
    st = traffic.Stage(rec, np.pi / 4, 16 / 9, 0.1, 1 / 60)
    orbit = traffic.Orbit(_walk()["camera"], 22, st)
    edits = traffic.Spawns({"every_frames": 30, "lifetime_frames": 15,
                            "size": 1.0, "base_color": [0.2, 1.0],
                            "metallic": [0.0, 1.0], "roughness": [0.1, 0.9],
                            "offset": [2.0, 1.5], "height": [2.6, 4.0]}, 22,
                           st, orbit)

    pw = world.build_world(papi, rec)
    pw.insert_resource(IBLResource.from_equirect(rec["sky"], device="cpu",
                                                 **TINY_IBL))
    cam = _camera(papi, orbit, 0, pcfg)
    pw.insert_resource(cam)
    r = P.Renderer(pcfg, device="cpu")
    r.prepare(pw)
    assert not r._fast  # the reference sampling path
    maps = ibl_maps(rec["sky"], TINY_IBL, "cpu")
    refs = {}

    def reference(live):
        if live not in refs:
            w = world.build_world(rapi, rec)
            for k in live:
                world.spawn_entity(rapi, w, edits.entity(
                    k, orbit.ground_ahead(k * edits.every)))
            refs[live] = ReferenceRenderer(rcfg, maps, "cpu")
            refs[live].prepare(w)
            assert not refs[live].fast
        return refs[live]

    def same(i, live):
        _pose(cam, orbit, i)
        a = r.render(pw)
        b = reference(live).render(_camera(rapi, orbit, i, rcfg))
        assert np.array_equal(a, b), f"frame {i}, entities {live}"

    # poses a quarter turn apart
    for i in (0, 150, 300):
        same(i, ())
    ent = world.spawn_entity(papi, pw, edits.entity(
        0, orbit.ground_ahead(0)))
    prepares = r._prepare_count
    same(300, (0,))
    assert r._prepare_count == prepares  # repacked in place
    pw.despawn(ent)
    same(300, ())
    assert r._prepare_count == prepares


def test_the_cell_finds_its_config_traffic_and_metrics():
    cell = spec.load(REPO, CELL)
    assert cell.chips == 1
    assert cell.config["engine"] == {"fast_sampling": False}
    assert cell.config["reduced"] == []
    assert cell.traffic == _walk()
    assert {m.name for m in cell.end_to_end} == {"setup_s", "frame_ms",
                                                 "frame_ms_p99"}
    assert {m.name for m in cell.per_layer} == {
        "vertex_stage_ms.frame", "ref_raster_ms.frame",
        "ref_gbuffer_ms.frame", "ref_shading_ms.frame",
        "device_idle_pct.frame"}
    # nothing of the cell asks for the reference's work counts
    assert not cell.needs("work")


def _reader(name):
    path = os.path.join(REPO, "benchmark", "metrics", f"{name}.py")
    s = importlib.util.spec_from_file_location(name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.read


def _record():
    """Two probed frames of a 1000 us window: K6 + K2 (``raster_kernel``
    in two modes), K12, K11, and the fast path's kernels (not read); a
    third, unprobed frame's kernels after 800."""
    ops = []
    for t in (0.0, 400.0):
        ops += [("void raster_kernel<0, false>(float const*)", t, t + 30),
                ("void raster_kernel<2, false>(float const*)", t + 30,
                 t + 80),
                ("gbuffer_ref_kernel(GbufRefArgs)", t + 80, t + 180),
                ("shade_ref_kernel(ShadeRefArgs)", t + 180, t + 300),
                ("gbuffer_kernel(GbufArgs)", t + 300, t + 310)]
    ops += [("gbuffer_ref_kernel(GbufRefArgs)", 800.0, 900.0)]
    return {"units": 3, "probed_units": 2,
            "host_ranges": [("bench::window", 0.0, 1000.0),
                            ("bench::probe", 0.0, 350.0),
                            ("bench::probe", 400.0, 750.0)],
            "device_ops": ops}


def test_the_four_readers_on_a_synthetic_record():
    run = {"trace": dict(_record(), passes={"vertex stage": 0.042,
                                            "raster": 0.1})}
    assert _reader("vertex_stage_ms.frame")(run) == pytest.approx(0.042)
    assert _reader("ref_raster_ms.frame")(run) == pytest.approx(0.080)
    assert _reader("ref_gbuffer_ms.frame")(run) == pytest.approx(0.100)
    assert _reader("ref_shading_ms.frame")(run) == pytest.approx(0.120)


def test_the_readers_find_nothing_on_the_fast_path_or_an_untraced_run():
    fast = _record()
    fast["device_ops"] = [op for op in fast["device_ops"]
                          if "_ref_" not in op[0]]
    run = {"trace": dict(fast, passes={"vertex stage": 0.0, "raster": 0.1})}
    for name in ("vertex_stage_ms.frame", "ref_gbuffer_ms.frame",
                 "ref_shading_ms.frame"):
        assert _reader(name)(run) is None
        assert _reader(name)({}) is None
    assert _reader("ref_raster_ms.frame")({}) is None
