"""The Sponza-scale scene lit by 1024 point lights (the benchmark's
``sponza_many_lights`` recipe) through the port's normal path on the
CPU: ``Renderer.render`` of a light table of 1025 rows, past one chunk of
the shading kernels' shared memory (``shading.LIGHT_CHUNK_ROWS``), against
the benchmark's plain reference render of the same pose, bit for bit (on
the CPU both run the same plain ops), as the benchmark's CPU tests hold
the stock scene.  128x64 frames of ``n_grid=2``; no JAX frame."""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import mo_renderer_tpu_torch as P  # noqa: E402
from mo_renderer_tpu_torch.assets.ibl_resource import IBLResource  # noqa: E402
from mo_renderer_tpu_torch.passes import shading as Sh  # noqa: E402

from benchmark.harness import traffic, world  # noqa: E402
from benchmark.reference.render import ReferenceRenderer, ibl_maps  # noqa: E402
from benchmark.scenes import sponza_many_lights  # noqa: E402

TINY_IBL = {"cubemap_size": 16, "irradiance_size": 8, "specular_mips": 3,
            "specular_samples": 8, "brdf_lut_size": 16}


def _camera(api, orbit, i, cfg):
    """``api``'s camera at frame ``i`` of ``orbit``, frame ``i - 1``'s
    pose its previous view."""
    cam = api.Camera(position=tuple(float(x) for x in orbit.pose(i - 1)[0]),
                     rotation=orbit.pose(i - 1)[1])
    cam.resize((cfg.width, cfg.height))
    cam.refresh_view()
    pos, rot = orbit.pose(i)
    cam.transform.translation = pos
    cam.transform.rotation = rot
    cam.refresh_view()
    return cam


def test_many_lights_frame_equals_the_plain_reference_on_the_cpu():
    rec = sponza_many_lights.recipe(26, n_grid=2, n_points=1024)
    n_rows = 1 + len(rec["points"])
    assert n_rows == 1025 > Sh.LIGHT_CHUNK_ROWS
    papi, rapi = world.port_api(), world.reference_api()
    kw = dict(width=128, height=64, shadow_map_size=256, max_lights=n_rows)
    pcfg, rcfg = papi.EngineConfig(**kw), rapi.EngineConfig(**kw)
    with open(os.path.join(ROOT, "benchmark", "traffic", "walk.json")) as f:
        walk = json.load(f)["camera"]
    st = traffic.Stage(rec, np.pi / 4, kw["width"] / kw["height"], 0.1,
                       1 / 60)
    orbit = traffic.Orbit(walk, 26, st)

    pw = world.build_world(papi, rec)
    pw.insert_resource(IBLResource.from_equirect(rec["sky"], device="cpu",
                                                 **TINY_IBL))
    cam = _camera(papi, orbit, 7, pcfg)
    pw.insert_resource(cam)
    r = P.Renderer(pcfg, device="cpu")
    r.prepare(pw)
    assert r._fast and r._n_lights == n_rows
    assert tuple(r.scene.lights.shape) == (1028, 20)
    a = r.render(pw)

    rw = world.build_world(rapi, rec)
    ref = ReferenceRenderer(rcfg, ibl_maps(rec["sky"], TINY_IBL, "cpu"),
                            "cpu")
    ref.prepare(rw)
    assert ref.fast and ref.n_lights == n_rows
    b = ref.render(_camera(rapi, orbit, 7, rcfg))
    assert a.shape == (64, 128, 4)
    np.testing.assert_array_equal(a, b)
