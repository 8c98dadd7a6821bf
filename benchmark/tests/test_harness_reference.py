"""The plain reference against the port on the CPU, where the port runs
the same plain ops: bit for bit, from the same recipe, also after a
spawn repacked in place (the reference packs the edited world afresh)."""

import numpy as np

import mo_renderer_tpu_torch as P
from mo_renderer_tpu_torch.assets.ibl_resource import IBLResource

from benchmark.harness import traffic, world
from benchmark.reference.render import ReferenceRenderer, ibl_maps
from benchmark.scenes import sponza_grid

from .conftest import TINY_IBL


def _camera(api, orbit, i, cfg):
    cam = api.Camera(position=tuple(float(x) for x in orbit.pose(i)[0]),
                     rotation=orbit.pose(i)[1])
    cam.resize((cfg.width, cfg.height))
    return cam


def test_reference_frames_equal_the_ports_on_the_cpu():
    rec = sponza_grid.recipe(21, n_grid=3)
    papi, rapi = world.port_api(), world.reference_api()
    kw = dict(width=160, height=90, shadow_map_size=256)
    pcfg, rcfg = papi.EngineConfig(**kw), rapi.EngineConfig(**kw)
    st = traffic.Stage(rec, np.pi / 4, 16 / 9, 0.1, 1 / 60)
    orbit = traffic.Orbit({"radius": 10.0, "height": 10.0, "pitch": 1.2,
                           "period_frames": 600, "margin": 0.25}, 21, st)
    edits = traffic.Spawns({"every_frames": 30, "lifetime_frames": 15,
                            "size": 1.0, "base_color": [0.2, 1.0],
                            "metallic": [0.0, 1.0], "roughness": [0.1, 0.9],
                            "offset": [2.0, 1.5], "height": [2.6, 4.0]}, 21,
                           st, orbit)

    pw = world.build_world(papi, rec)
    pw.insert_resource(IBLResource.from_equirect(rec["sky"], device="cpu",
                                                 **TINY_IBL))
    cam = _camera(papi, orbit, 0, pcfg)
    pw.insert_resource(cam)
    r = P.Renderer(pcfg, device="cpu")
    r.prepare(pw)
    maps = ibl_maps(rec["sky"], TINY_IBL, "cpu")

    def reference(live):
        w = world.build_world(rapi, rec)
        for k in live:
            world.spawn_entity(rapi, w, edits.entity(k, orbit.ground_ahead(
                k * edits.every)))
        ref = ReferenceRenderer(rcfg, maps, "cpu")
        ref.prepare(w)
        return ref

    a = r.render(pw)
    b = reference(()).render(_camera(rapi, orbit, 0, rcfg))
    assert np.array_equal(a, b)
    ent = world.spawn_entity(papi, pw, edits.entity(
        0, orbit.ground_ahead(0)))
    prepares = r._prepare_count
    a = r.render(pw)
    assert r._prepare_count == prepares  # repacked in place
    b = reference((0,)).render(_camera(rapi, orbit, 0, rcfg))
    assert np.array_equal(a, b)
    pw.despawn(ent)
    a = r.render(pw)
    b = reference(()).render(_camera(rapi, orbit, 0, rcfg))
    assert np.array_equal(a, b)
