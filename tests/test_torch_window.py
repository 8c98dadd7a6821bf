"""The port's window shell (mo_renderer_tpu_torch/app/window.py) on the
CPU: OS events flow through the Input state machine, the descriptor maps
onto display flags, the Windows manager keeps its map, and run_windowed
renders, resizes and decimates port frames.  Mirrors tests/test_window.py
(:40, :56, :82, :96, :114, :136, :167, :192) under SDL's dummy video
driver; those tests skip where pygame is absent.  The OffscreenWindow
loop needs no pygame and runs everywhere.  The app renders the tiny scene
at 128x32 (the reference's tests use 256x128; a CPU frame costs ~8x
less here) and resizes to 160x50.
"""

import importlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("SDL_VIDEODRIVER", "dummy")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from mo_renderer_tpu_torch import scenes  # noqa: E402
from mo_renderer_tpu_torch.app import window as W  # noqa: E402
from mo_renderer_tpu_torch.scene.camera import Camera  # noqa: E402
from mo_renderer_tpu_torch.scene.input import (  # noqa: E402
    EInputButton,
    EInputState,
    Input,
)


@pytest.fixture
def pygame():
    return pytest.importorskip("pygame")


@pytest.fixture
def window(pygame):
    w = W.PygameWindow(64, 32, headless=True)
    yield w
    w.close()


@pytest.fixture(scope="module")
def ibl():
    """One computed IBL for every app of the module."""
    res = scenes.tiny_ibl("cpu")
    res.ensure_computed()
    return res


def _post(pygame, **kw):
    t = kw.pop("type")
    pygame.event.post(pygame.event.Event(t, **kw))


def _tiny_app(ibl):
    from mo_renderer_tpu_torch.app.application import App
    from mo_renderer_tpu_torch.scene.timer import Timer

    cfg = scenes.tiny_config(width=128, height=32)
    app = App(config=cfg, device="cpu")
    app.init_resource(Timer)
    app.init_resource(Input)
    app.add_runtime_system(Timer.update_timer)
    app.add_runtime_system(Camera.update_camera)
    app.insert_resource(scenes.camera(cfg))
    tiny = scenes.tiny_world()
    for comps in tiny._entities.values():
        app.world.spawn(tuple(comps.values()))
    app.world.insert_resource(ibl)
    app.resumed()
    return app


def _recorder(win, seen):
    class Recorder:
        def present(self, frame):
            seen.append(frame.shape)
            win.present(frame)

        def __getattr__(self, name):
            return getattr(win, name)

    return Recorder()


def test_key_and_mouse_events_reach_input(window, pygame):
    inp = Input()
    _post(pygame, type=pygame.KEYDOWN, key=pygame.K_w)
    _post(pygame, type=pygame.MOUSEBUTTONDOWN, button=3, pos=(5, 5))
    _post(pygame, type=pygame.MOUSEMOTION, rel=(7.0, -3.0), pos=(12, 2),
          buttons=(0, 0, 1))
    assert window.pump(inp)
    assert inp.is_activated(EInputButton.key("W"))
    assert inp.button_state(EInputButton.MOUSE_RIGHT) == EInputState.ACTIVATED
    assert inp.mouse_delta() == (7.0, -3.0)

    _post(pygame, type=pygame.KEYUP, key=pygame.K_w)
    _post(pygame, type=pygame.MOUSEBUTTONUP, button=3, pos=(5, 5))
    assert window.pump(inp)
    assert inp.button_state(EInputButton.key("W")) == EInputState.DEACTIVATED


def test_escape_and_quit_end_the_loop(window, pygame):
    inp = Input()
    _post(pygame, type=pygame.KEYDOWN, key=pygame.K_ESCAPE)
    assert not window.pump(inp)
    _post(pygame, type=pygame.QUIT)
    assert not window.pump(inp)


def test_modifiers_reach_input(window, pygame):
    """ModifiersChanged analog (input.rs:331-335)."""
    inp = Input()
    pygame.key.set_mods(pygame.KMOD_LSHIFT | pygame.KMOD_LCTRL)
    _post(pygame, type=pygame.KEYDOWN, key=pygame.K_w)
    assert window.pump(inp)
    assert "Shift" in inp.modifiers and "Ctrl" in inp.modifiers
    pygame.key.set_mods(0)
    _post(pygame, type=pygame.KEYUP, key=pygame.K_w)
    assert window.pump(inp)
    assert inp.modifiers == set()


def test_window_descriptor_modes_and_constraints(pygame):
    """WindowDescriptor -> pygame flags (window.rs:48-105) and resize
    constraint sanitation (window.rs:398-424)."""
    d = W.WindowDescriptor(mode=W.WindowMode.FULLSCREEN)
    assert d.pygame_flags(pygame) & pygame.FULLSCREEN
    d = W.WindowDescriptor(mode=W.WindowMode.BORDERLESS_FULLSCREEN)
    assert d.pygame_flags(pygame) & pygame.NOFRAME
    d = W.WindowDescriptor(decorations=False, resizable=True)
    flags = d.pygame_flags(pygame)
    assert flags & pygame.NOFRAME and flags & pygame.RESIZABLE

    c = W.WindowResizeConstraints(min_width=400, max_width=200,
                                  min_height=-5, max_height=300)
    cc = c.check_constraints()
    assert cc.max_width == 400 and cc.min_height == 1.0
    assert c.clamp(1000, 50) == (400, 50)


def test_windows_manager_map(pygame):
    """VulkanoWindows analog (window.rs:32-160): id -> window map with a
    primary; removal re-elects the primary."""
    mgr = W.Windows()
    w1 = mgr.create_window(
        W.WindowDescriptor(width=64, height=32,
                           resize_constraints=W.WindowResizeConstraints(1, 1)),
        renderer="r1", headless=True)
    w2 = mgr.create_window(W.WindowDescriptor(width=32, height=16),
                           renderer="r2")
    assert len(mgr) == 2
    assert mgr.get_primary_window() is mgr.get_window(w1)
    assert mgr.get_primary_renderer() == "r1"
    assert mgr.get_renderer(w2) == "r2"
    frame = np.zeros((16, 32, 4), np.uint8)
    mgr.get_window(w2).present(frame)
    assert mgr.get_window(w2).frame is frame
    mgr.remove_window(w1)
    assert mgr.get_primary_window() is mgr.get_window(w2)
    mgr.remove_window(w2)
    assert len(mgr) == 0


def test_live_resize_recreates_swapchain(pygame, ibl):
    """A VIDEORESIZE mid-loop runs Camera.resize + Renderer.resize, and
    the next frame renders at the new (constraint-clamped) size."""
    app = _tiny_app(ibl)
    seen = []
    win = W.PygameWindow(app.config.width, app.config.height, headless=True)
    try:
        _post(pygame, type=pygame.VIDEORESIZE, size=(160, 50), w=160, h=50)
        shown = W.run_windowed(app, window=_recorder(win, seen), max_frames=2)
    finally:
        win.close()
    assert shown == 2
    assert app.renderer.config.width == 160
    assert app.renderer.config.height == 50
    assert app.config is app.renderer.config
    cam = app.world.get_resource(Camera)
    assert abs(cam.aspect() - 160.0 / 50.0) < 1e-6
    assert seen[-1][:2] == (50, 160), seen


def test_present_divisor_fetches_downscaled_frames(pygame, ibl):
    """present_divisor=2 presents (H/2, W/2) frames, decimated on the
    device before the fetch, and the blit upscales them."""
    app = _tiny_app(ibl)
    seen = []
    win = W.PygameWindow(app.config.width, app.config.height, headless=True)
    try:
        shown = W.run_windowed(app, window=_recorder(win, seen), max_frames=1,
                               present_divisor=2)
    finally:
        win.close()
    assert shown == 1
    assert seen == [(app.config.height // 2, app.config.width // 2, 4)]


def test_windowed_flight_moves_the_camera(pygame, ibl):
    """Two frames of held-W flight through the real frame loop: the camera
    advances and frames present."""
    app = _tiny_app(ibl)
    cam = app.world.get_resource(Camera)
    p0 = np.array(cam.transform.translation, np.float32).copy()
    win = W.PygameWindow(app.config.width, app.config.height, headless=True)
    try:
        _post(pygame, type=pygame.KEYDOWN, key=pygame.K_w)
        shown = W.run_windowed(app, window=win, max_frames=2)
    finally:
        win.close()
    assert shown == 2
    p1 = np.array(cam.transform.translation, np.float32)
    assert np.linalg.norm(p1 - p0) > 0.0, "held W did not move the camera"


def test_offscreen_loop_resizes_without_pygame(ibl, monkeypatch):
    """The loop through an OffscreenWindow, with pygame unimportable: the
    module imports, a resize pending before frame 2 presents at the new
    size, and present_divisor=2 presents ceil(H/2) x ceil(W/2) frames that
    are the full frame's even rows and columns."""
    monkeypatch.setitem(sys.modules, "pygame", None)  # import raises
    win_mod = importlib.reload(W)
    app = _tiny_app(ibl)

    class Resizing(win_mod.OffscreenWindow):
        shapes = []

        def present(self, frame):
            super().present(frame)
            self.shapes.append(frame.shape)
            if len(self.shapes) == 1:
                self.pending_resize = (160, 50)

    win = Resizing(app.config.width, app.config.height)
    assert win_mod.run_windowed(app, window=win, max_frames=2) == 2
    assert win.shapes == [(32, 128, 4), (50, 160, 4)]
    assert (app.config.width, app.config.height) == (160, 50)
    cam = app.world.get_resource(Camera)
    assert abs(cam.aspect() - 160.0 / 50.0) < 1e-6

    small = win_mod.OffscreenWindow(160, 50)
    win_mod.run_windowed(app, window=small, max_frames=1, present_divisor=2)
    assert small.frame.shape == (25, 80, 4)
    np.testing.assert_array_equal(small.frame, win.frame[::2, ::2])
