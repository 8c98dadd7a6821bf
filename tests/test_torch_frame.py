"""The port's whole frame (mo_renderer_tpu_torch.Renderer / App) on its
three paths (default, reference sampling, megakernel) against the
reference's goldens and the JAX frame of the same scene, and the guards
that keep the port runnable where there is no ``jax``, no ``triton`` and
no ``nvcc``.  Each side builds the scene with its own package's builders.

Bar: the golden bar of tests/test_golden.py:99-107 (mean |diff| < 2/255,
fewer than 0.5% of channels above 16/255), against the PNG and against
the JAX frame.  Each test prints its maximum LSB difference.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import __graft_entry__ as graft  # noqa: E402
from mo_renderer_tpu.assets.model import Model as JModel  # noqa: E402
from mo_renderer_tpu.passes.frame_graph import Renderer as JRenderer  # noqa: E402
from mo_renderer_tpu.passes.present import unpack_rgba8 as j_unpack  # noqa: E402
from mo_renderer_tpu_torch import App, Renderer, interop, scenes  # noqa: E402
from mo_renderer_tpu_torch.passes import frame_graph as FG  # noqa: E402

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def _golden(name):
    from PIL import Image

    return np.asarray(
        Image.open(os.path.join(GOLDEN_DIR, name)).convert("RGBA")
    ).astype(np.int32)


def _check(frame, ref, what):
    frame = np.asarray(frame).astype(np.int32)
    ref = np.asarray(ref).astype(np.int32)
    assert frame.shape == ref.shape
    diff = np.abs(frame - ref)[..., :3]
    print(f"{what}: max |diff| {diff.max()} LSB, mean {diff.mean():.4f}, "
          f"{(diff > 16).mean():.4%} > 16")
    assert diff.mean() < 2.0, f"mean |diff| {diff.mean():.3f}"
    assert (diff > 16).mean() < 0.005


def _port_frame(uv1=False, with_renderer=False, all_slots=False,
                **overrides):
    cfg = scenes.tiny_config(**overrides)
    world = scenes.tiny_world(uv1=uv1, all_slots=all_slots)
    world.insert_resource(scenes.camera(cfg))
    r = Renderer(cfg, "cpu")
    r.prepare(world)
    frame = r.render(world)
    return (frame, r) if with_renderer else frame


def _jax_frame(uv1=False, with_renderer=False, all_slots=False,
               **overrides):
    cfg = dataclasses.replace(graft._tiny_config(), **overrides)
    world = graft._tiny_world()
    if uv1:
        # the same change scenes.tiny_world(uv1=True) makes
        scenes.use_uv1(next(iter(world.query(JModel))))
    if all_slots:
        # the same change scenes.tiny_world(all_slots=True) makes
        scenes.use_all_slots(next(iter(world.query(JModel))))
    world.insert_resource(graft._camera(cfg))
    r = JRenderer(cfg)
    r.prepare(world)
    frame = r.render(world)
    return (frame, r) if with_renderer else frame


def test_default_frame_matches_golden_and_reference():
    frame = _port_frame()
    assert frame.shape == (128, 256, 4) and frame.dtype == np.uint8
    _check(frame, _golden("entry_cb_256x128.png"), "vs entry_cb golden")
    fn, args = graft.entry()
    ref = j_unpack(np.asarray(jax.jit(fn)(*args)))
    _check(frame, ref, "vs JAX entry frame")


def test_passes_off_frame_matches_golden_and_reference():
    kw = dict(ssao_enabled=False, shadow_enabled=False)
    frame = _port_frame(**kw)
    _check(frame, _golden("entry_passes_off_256x128.png"),
           "passes off vs golden")
    _check(frame, _jax_frame(**kw), "passes off vs JAX frame")


@pytest.mark.parametrize("overrides,golden", [
    (dict(checkerboard=False, ssao_res_divisor=1),
     "entry_procedural_256x128.png"),
    (dict(ssao_res_divisor=1), "entry_cb_ssao1_256x128.png"),
])
def test_option_frames_match_goldens(overrides, golden):
    _check(_port_frame(**overrides), _golden(golden), f"{overrides}")


def test_reference_path_frame_matches_reference():
    """fast_sampling=False: the per-vertex stage, the full-mode raster
    (K6), gbuffer_pass and shading_pass, against the JAX frame."""
    frame, r = _port_frame(with_renderer=True, fast_sampling=False)
    assert r._fast is False
    _check(frame, _jax_frame(fast_sampling=False),
           "reference path vs JAX frame")


def test_uv1_scene_takes_the_reference_path_in_both():
    """A material sampling UV set 1 sends both renderers, under default
    flags, down the reference sampling path (frame_graph.py:512-524)."""
    frame, r = _port_frame(uv1=True, with_renderer=True)
    ref, jr = _jax_frame(uv1=True, with_renderer=True)
    assert r._fast is False and jr._fast is False
    _check(frame, ref, "UV1 scene vs JAX frame")
    assert np.abs(frame.astype(int) - _port_frame().astype(int)).max() > 16


def test_megakernel_frame_matches_golden_and_reference():
    """raster_interp_attrs=True: the raster megakernel (K8) and
    gbuffer_pass_from_planes, against its golden and the JAX frame."""
    kw = dict(raster_interp_attrs=True, ssao_res_divisor=1)
    frame = _port_frame(**kw)
    _check(frame, _golden("entry_procedural_256x128.png"),
           "megakernel vs golden")
    _check(frame, _jax_frame(**kw), "megakernel vs JAX frame")


def test_frame_from_reference_state_matches_own_state():
    """The reference's packed scene and IBL maps, carried over as numpy,
    render (almost) the same frame as the port's own pack and precompute."""
    cfg = scenes.tiny_config()
    world = scenes.tiny_world()
    cam = scenes.camera(cfg)
    world.insert_resource(cam)
    r = Renderer(cfg, "cpu")
    r.prepare(world)
    own = r.render(world)

    jr = JRenderer(cfg)
    jworld = graft._tiny_world()
    jworld.insert_resource(graft._camera(cfg))
    jr.prepare(jworld)
    r.scene = interop.scene_from_numpy(
        {k: np.asarray(getattr(jr.scene, k))
         for k in jr.scene.__dataclass_fields__}, "cpu",
    )
    m = jr.ibl.maps()

    def chain(c, key):
        return {key: np.asarray(c.data if key == "data" else c.rows),
                "sizes": c.sizes, "offsets": c.offsets}

    maps = interop.ibl_from_numpy({
        "environment_faces": np.asarray(m.environment_faces),
        "irradiance_faces": np.asarray(m.irradiance_faces),
        "specular_mips": chain(m.specular_mips, "data"),
        "brdf_lut": np.asarray(m.brdf_lut),
        "specular_quad": chain(m.specular_quad, "rows"),
        "specular_quad_merged": chain(m.specular_quad_merged, "rows"),
        "irradiance_sh9": np.asarray(m.irradiance_sh9),
    }, "cpu")
    params, has_light = r.frame_params(world)
    rgba, ovf = FG.frame_program(
        r.scene, maps, params, cfg=cfg, pad_w=r.pad_w, pad_h=r.pad_h,
        binned_cap=r._binned_cap, has_shadow_light=has_light,
        slot_map=r._slot_map, n_lights=r._n_lights,
    )
    assert ovf.dtype == torch.int64 and ovf.tolist() == [0, 0]
    carried = FG.unpack_rgba8(rgba)
    diff = np.abs(carried.astype(int) - own.astype(int))
    print(f"carried state vs own state: max |diff| {diff.max()} LSB")
    assert diff.max() <= 2


def test_app_runs_the_port_and_memoizes_the_shadow():
    cfg = scenes.tiny_config()
    app = App.new(config=cfg, device="cpu")
    app.world = scenes.tiny_world()
    app.insert_resource(scenes.camera(cfg))
    app.add_runtime_system(scenes.orbit_system(3))
    frame = app.run(num_frames=3)
    assert isinstance(app.renderer, Renderer)
    assert frame.shape == (128, 256, 4) and frame[..., :3].max() > 0
    quads = app.renderer._shadow_quads
    assert quads is not None
    app.run(num_frames=1)
    assert app.renderer._shadow_quads is quads  # light and scene unchanged
    # the entry points target the card by default: without one they
    # raise, and only device="cpu" runs on the CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            App.new(config=cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Renderer(cfg)


def test_unported_options_raise():
    """Every EngineConfig option is ported, and so are extra render
    passes, which raised until sequences and the RenderPass API were
    ported: a Renderer with the identity pass renders, and its frame
    is the frame with the checkerboard off bit for bit (a pass switches
    the checkerboard off)."""
    for overrides in (dict(stack_plane_kernel=True), dict(ssao_pallas=False),
                      dict(pcf_u16=False), dict(pcf_half_anchor=False),
                      dict(spec_parent_mip_half_res=False),
                      dict(spec_mirror_half_res=False),
                      dict(spec_merged_trilinear=False),
                      dict(attrs_plane_kernel=False)):
        Renderer(scenes.tiny_config(**overrides), "cpu")
    cfg = scenes.tiny_config()
    world = scenes.tiny_world()
    world.insert_resource(scenes.camera(cfg))
    r = Renderer(cfg, "cpu", extra_passes=[FG.RenderPass()])
    r.prepare(world)
    np.testing.assert_array_equal(r.render(world),
                                  _port_frame(checkerboard=False))


def test_extra_passes_and_uv1_raise():
    """Extra render passes no longer raise: one added through
    App.add_render_pass renders end to end and dims the frame.  A UV1
    scene does not raise either: it takes the reference sampling path
    (rendered and held to the JAX frame by
    test_uv1_scene_takes_the_reference_path_in_both)."""
    class Dim(FG.RenderPass):
        def render(self, ctx):
            return dict(ctx, color=ctx["color"] * 0.5)

    cfg = scenes.tiny_config()
    app = App.new(config=cfg, device="cpu")
    app.world = scenes.tiny_world()
    app.insert_resource(scenes.camera(cfg))
    app.add_render_pass(Dim())
    frame = app.run(num_frames=1)
    assert len(app.renderer.extra_passes) == 1
    full = _port_frame(checkerboard=False)
    lit = full[..., :3] > 8
    assert frame.shape == full.shape
    assert (frame[..., :3][lit] < full[..., :3][lit]).mean() > 0.9
    world = scenes.tiny_world(uv1=True)
    world.insert_resource(scenes.camera(scenes.tiny_config()))
    r = Renderer(scenes.tiny_config(), "cpu")
    r.prepare(world)
    assert r._fast is False


def _run_python(code, env=None):
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)], cwd=REPO,
        capture_output=True, text=True, timeout=300, env=env,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def test_port_renders_without_jax():
    """A CUDA machine may have no jax at all: with jax made unimportable,
    the package imports and renders a 256x128 frame on the CPU on each of
    its four paths and under each fast-path option, and no module of the
    JAX package is ever loaded."""
    out = _run_python("""
        import sys
        sys.modules["jax"] = None
        import mo_renderer_tpu_torch as port
        import mo_renderer_tpu_torch.parallel  # the row-sharded frame
        from mo_renderer_tpu_torch import scenes
        stacks = {"attrs_plane_kernel": False, "stack_plane_kernel": True}
        for kw in ({}, {"fast_sampling": False},
                   {"raster_interp_attrs": True, "ssao_res_divisor": 1},
                   stacks, {"pcf_u16": False}, {"pcf_half_anchor": False},
                   {"spec_parent_mip_half_res": False},
                   {"spec_merged_trilinear": False},
                   {"spec_mirror_half_res": False, "checkerboard": False},
                   {"ssao_pallas": False}):
            cfg = scenes.tiny_config(**kw)
            app = port.App.new(config=cfg, device="cpu")
            app.world = scenes.tiny_world(all_slots=kw is stacks)
            app.insert_resource(scenes.camera(cfg))
            frame = app.run(num_frames=1)
            assert frame.shape == (128, 256, 4), frame.shape
            assert frame[..., :3].max() > 0
        loaded = [m for m in sys.modules if sys.modules[m] is not None]
        assert not any(m == "jax" or m.startswith("jax.") for m in loaded)
        assert not any(m == "mo_renderer_tpu"
                       or m.startswith("mo_renderer_tpu.") for m in loaded)
        print("ok", frame.shape)
    """)
    assert "ok (128, 256, 4)" in out


def test_import_needs_no_triton_and_no_nvcc():
    """Importing every module of the package neither imports triton nor
    looks for nvcc (the kernels build at first launch on a card)."""
    env = dict(os.environ, PATH="/nonexistent")
    env.pop("NVCC", None)
    out = _run_python("""
        import importlib, pkgutil, sys
        import mo_renderer_tpu_torch as port
        for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
            importlib.import_module(m.name)
        from mo_renderer_tpu_torch.kernels import _build
        assert "triton" not in sys.modules
        assert _build._lib is None and _build.build_seconds is None
        print("ok")
    """, env=env)
    assert out.strip().endswith("ok")
