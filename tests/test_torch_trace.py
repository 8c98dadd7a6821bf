"""The port's tracer (``mo_renderer_tpu_torch/utils/trace.py``): spans off
by default and recorded with their parents and frame ids when on, the
topology layer's repack spans and full-prepare counter, the light rows
a prepare packs (``light_rows``, the ``pack_lights`` span), the count of
frames on the reference sampling path, the marker kernel's count against
the pass list, ``profile_trace`` switching the tracer, and on a card the
pass markers in the captured frame.

CPU frames at 128x32 with one computed IBL for the module; no JAX.  The
card's case (``cuda``) skips here and runs on one with
``python3 -m pytest tests/test_torch_trace.py --noconftest -q``.
"""

import contextlib
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from mo_renderer_tpu_torch import App, Renderer, scenes, utils  # noqa: E402
from mo_renderer_tpu_torch.assets.procedural import procedural_model  # noqa: E402
from mo_renderer_tpu_torch.kernels import _build, mark  # noqa: E402
from mo_renderer_tpu_torch.math.transform import Transform  # noqa: E402
from mo_renderer_tpu_torch.passes.frame_graph import build_camera_params  # noqa: E402
from mo_renderer_tpu_torch.scene.camera import Camera  # noqa: E402
from mo_renderer_tpu_torch.scene.scene_buffers import find_shadow_light  # noqa: E402
from mo_renderer_tpu_torch.scene.components import DirectionalLight  # noqa: E402
from mo_renderer_tpu_torch.scene.world import World  # noqa: E402
from mo_renderer_tpu_torch.utils import trace  # noqa: E402


@pytest.fixture(scope="module")
def ibl():
    res = scenes.tiny_ibl("cpu")
    res.ensure_computed()
    return res


@pytest.fixture
def tracer():
    """The tracer off and empty around the test."""
    trace.disable()
    trace.reset()
    yield trace
    trace.disable()
    trace.reset()


def _world(ibl):
    world = World()
    world.spawn((Transform.from_xyz(0.0, -0.5, 0.0),
                 procedural_model("plane", size=8.0)))
    world.spawn((DirectionalLight(
        Transform.from_xyz(5.0, 8.0, 5.0).looking_at((0.0, 0.0, 0.0)),
        (1.0, 1.0, 1.0), 4.0, True),))
    world.insert_resource(ibl)
    return world


def _app(ibl):
    cfg = scenes.tiny_config(width=128, height=32)
    app = App.new(config=cfg, device="cpu")
    app.world = _world(ibl)
    app.insert_resource(scenes.camera(cfg))
    app.resumed()
    return app


def _children(spans, parent):
    return [s[0] for s in spans if s[1] == parent]


def _descends(spans, s, ancestor):
    while s[1] is not None:
        if s[1] == ancestor:
            return True
        s = spans[s[1]]
    return False


def test_off_span_is_the_shared_noop_and_records_nothing(tracer, ibl):
    assert trace.span("a") is trace.span("b") is mark.pass_span("raster") \
        is trace.NULL
    before = trace.snapshot()["counters"]
    app = _app(ibl)
    app.render_frame()
    snap = trace.snapshot()
    assert snap["spans"] == []
    # the counters stay on: the app's resume prepares the scene
    assert snap["counters"]["prepares"] - before.get("prepares", 0) == 1
    assert "launches.mark" in snap["counters"]


def test_marker_count_follows_the_pass_list():
    """csrc/mark.cu launches one marker a pass of ``PASSES`` and ``END``."""
    with open(os.path.join(_build.CSRC, "mark.cu")) as f:
        (n,) = re.findall(r"constexpr int kMarks = (\d+);", f.read())
    assert int(n) == mark.END + 1 == len(mark.PASSES) + 1


def test_cpu_frame_gives_the_span_tree(tracer, ibl):
    app = _app(ibl)
    app.render_frame()  # the shadow memo's first recompute
    first = app.frame_index
    trace.enable()
    app.render_frame()
    app.render_frame()
    spans = trace.snapshot()["spans"]
    roots = [i for i, s in enumerate(spans) if s[1] is None]
    assert [spans[i][0] for i in roots] == ["frame", "frame"]
    assert [spans[i][2] for i in roots] == [first, first + 1]
    for root in roots:
        frame = spans[root][2]
        mine = [s for s in spans if s[2] == frame]
        assert all(s[3] <= s[4] for s in mine)
        assert _children(spans, root) == ["runtime_systems", "render"]
        render = spans.index(next(s for s in mine if s[0] == "render"))
        assert _children(spans, render) == ["render_device", "fetch",
                                            "check_overflow"]
        device = spans.index(next(s for s in mine
                                  if s[0] == "render_device"))
        assert _children(spans, device) == [
            "sync_topology", "refresh_transforms", "frame_params",
            "shadow_memo", "eager_frame", "note_overflow"]
        eager = spans.index(next(s for s in mine if s[0] == "eager_frame"))
        passes = [n[len("pass::"):] for n in _children(spans, eager)]
        assert passes == ["triangle setup", "binning", "raster", "decimate",
                          "G-buffer", "SSAO", "shading", "present"]
        assert passes == sorted(passes, key=mark.PASSES.index)
        # a child lies inside its parent
        for s in mine:
            if s[1] is not None:
                p = spans[s[1]]
                assert p[3] <= s[3] and s[4] <= p[4]


def test_spawn_despawn_count_repacks_and_a_fallback_counts_a_prepare(
        tracer, ibl):
    world = _world(ibl)
    cfg = scenes.tiny_config(width=128, height=32)
    world.insert_resource(scenes.camera(cfg))
    r = Renderer(cfg, "cpu")
    r.prepare(world)
    r.render(world)
    trace.enable()
    c0 = dict(trace.snapshot()["counters"])
    e = world.spawn((Transform.from_xyz(0.0, 0.5, 0.0),
                     procedural_model("cube")))
    r.render(world)
    world.despawn(e)
    r.render(world)
    c1 = trace.snapshot()["counters"]
    spans = trace.snapshot()["spans"]
    # a repack span each, inside the topology sync, and no prepare
    repacks = [s for s in spans if s[0] == "repack"]
    assert len(repacks) == 2
    assert {spans[s[1]][0] for s in repacks} == {"sync_topology"}
    assert c1["prepares"] == c0["prepares"]
    assert not any(s[0] == "prepare" for s in spans)
    # a second light cannot be repacked in place: a full prepare
    trace.reset()
    world.spawn((DirectionalLight(
        Transform.from_xyz(-5.0, 8.0, -5.0).looking_at((0.0, 0.0, 0.0)),
        (1.0, 0.5, 0.5), 2.0, False),))
    r.render(world)
    c2 = trace.snapshot()["counters"]
    assert c2["prepares"] == 1
    spans = trace.snapshot()["spans"]
    (prep,) = [s for s in spans if s[0] == "prepare"]
    chain = [spans[prep[1]][0], spans[spans[prep[1]][1]][0]]
    assert chain == ["sync_topology", "render_device"]
    assert _children(spans, spans.index(prep)) == ["pack_scene"]


def test_pack_scene_counts_its_light_rows_in_a_pack_lights_span(tracer,
                                                                 ibl):
    """``light_rows`` adds each prepare's packed light rows, as many as the
    world's lights (not the padded table's); with the tracer on the
    packing lies in a ``pack_lights`` span inside ``pack_scene``."""
    from mo_renderer_tpu_torch.scene.components import PointLight

    world = _world(ibl)
    for k in range(6):
        world.spawn((PointLight(Transform.from_xyz(k - 2.5, 1.5, 0.0),
                                color=(1.0, 0.5, 0.25), intensity=0.5),))
    n = sum(1 for t in (DirectionalLight, PointLight)
            for _ in world.query(t))
    cfg = scenes.tiny_config(width=128, height=32, max_lights=n)
    r = Renderer(cfg, "cpu")
    r.prepare(world)
    assert trace.snapshot()["counters"]["light_rows"] == n
    assert trace.snapshot()["spans"] == []
    trace.enable()
    r.prepare(world)
    assert trace.snapshot()["counters"]["light_rows"] == 2 * n
    assert tuple(r.scene.lights.shape) == (8, 20)  # padded to 4 rows
    spans = trace.snapshot()["spans"]
    (pack,) = [s for s in spans if s[0] == "pack_scene"]
    assert _children(spans, spans.index(pack)) == ["pack_lights"]


# (config overrides, a UV-set-1 material, frames counted per frame)
REFERENCE_FRAMES = {
    "fast_sampling_off": ({"fast_sampling": False}, False, 1),
    "uv1_material": ({}, True, 1),
    "fast_path": ({}, False, 0),
}


@pytest.mark.parametrize("case", sorted(REFERENCE_FRAMES))
def test_reference_frames_counts_the_reference_sampling_path(tracer, ibl,
                                                             case):
    """``reference_frames`` counts each frame rendered on the reference
    sampling path, whichever way the scene came to it, a sequence's
    frames one each, and nothing on the fast path; the counters stay on
    with the spans off."""
    overrides, uv1, per_frame = REFERENCE_FRAMES[case]
    world = scenes.tiny_world(uv1=uv1)
    world.insert_resource(ibl)
    cfg = scenes.tiny_config(width=128, height=32, **overrides)
    world.insert_resource(scenes.camera(cfg))
    r = Renderer(cfg, "cpu")
    r.prepare(world)
    assert r._fast == (per_frame == 0)
    r.render(world)
    r.render_device(world)
    light_pv, _ = find_shadow_light(world)
    params = [build_camera_params(world.resource(Camera), light_pv, "cpu")
              for _ in range(3)]
    r.render_sequence_device(world, params)
    assert trace.snapshot()["counters"].get("reference_frames", 0) == \
        5 * per_frame


def test_profile_trace_turns_the_tracer_on_and_off_again(tracer, tmp_path,
                                                         monkeypatch):
    """The switch alone, under a stand-in for torch.profiler.profile (the
    profiler's first start costs seconds; the trace it writes, with the
    spans in it, is test_torch_surface.py's)."""
    seen = []

    @contextlib.contextmanager
    def profile(**kw):
        seen.append(trace.enabled())
        yield

    monkeypatch.setattr(torch.profiler, "profile", profile)
    with utils.profile_trace(str(tmp_path)):
        assert trace.enabled()
    assert seen == [True] and not trace.enabled()
    trace.enable()
    with utils.profile_trace(str(tmp_path)):
        pass
    assert trace.enabled()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


# the card's paths: their passes and the program's own, two markers each
CARD_PATHS = {
    "default": ({}, 9),
    "reference": ({"fast_sampling": False}, 10),
    "megakernel": ({"raster_interp_attrs": True}, 10),
}


@pytest.mark.cuda
@pytest.mark.parametrize("path", sorted(CARD_PATHS))
def test_tracing_keys_the_graph_and_marks_each_pass_on_the_card(tracer,
                                                                cuda, path):
    """Tracing off: no marker in the graph.  On: a new key, a capture
    whose launches are the same plus two markers a pass, and the same
    frame.  Off again: the first graph's launches."""
    overrides, n_marked = CARD_PATHS[path]
    world = scenes.tiny_world()
    cfg = scenes.tiny_config(width=128, height=32, **overrides)
    world.insert_resource(scenes.camera(cfg))
    r = Renderer(cfg, cuda)
    r.prepare(world)
    f_off = r.render(world)
    key_off, launches_off = r._graph.key, dict(r._graph.launches)
    assert "mark" not in launches_off
    if r._shadow_graph is not None:
        assert "mark" not in r._shadow_graph.launches
    captures = r._captures
    trace.enable()
    f_on = r.render(world)
    assert r._captures == captures + 1 and r._graph.key != key_off
    on = dict(r._graph.launches)
    # the warm-up run before the capture opens the same spans unmarked
    spans = trace.snapshot()["spans"]
    (cap,) = [i for i, s in enumerate(spans) if s[0] == "capture"]
    inside = [s for s in spans if s[0].startswith("pass::")
              and _descends(spans, s, cap)]
    assert on.pop("mark") == len(inside) == 2 * n_marked
    assert on == launches_off
    np.testing.assert_array_equal(f_on, f_off)
    marks = _build.LAUNCHES["mark"]
    r.render(world)
    assert _build.LAUNCHES["mark"] == marks + r._graph.launches["mark"]
    trace.disable()
    f_off2 = r.render(world)
    assert r._graph.launches == launches_off
    np.testing.assert_array_equal(f_off2, f_off)
