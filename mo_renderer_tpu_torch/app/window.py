"""Interactive window shell + windows manager (port of
``mo_renderer_tpu/app/window.py``; optional, headless by default).

The reference is an interactive winit app: windows are created from a
``WindowDescriptor`` (mode, constraints, cursor state —
mo_vk/src/window.rs:288-363) and managed in a WindowId→renderer map
(``VulkanoWindows``, window.rs:32-160); per-frame ``window_event`` /
``device_event`` dispatch feeds Input (mo_core/src/application/
mod.rs:178-283, input.rs:315-350), live resizes recreate the swapchain
(mo_vk/src/lib.rs:352-388), and the camera flies on WASD + right-drag
(README.md:15-24).

This module is the analog: a pygame (SDL) window shell that
- maps ``WindowDescriptor`` modes onto pygame display flags
  (FULLSCREEN / NOFRAME / RESIZABLE) and applies resize constraints,
- translates OS events into the EXISTING Input state machine, including
  keyboard modifiers (the ``ModifiersChanged`` path, input.rs:331-335),
- handles live window resizes by recreating the "swapchain": clamps to
  the descriptor's constraints, then ``Camera.resize`` +
  ``Renderer.resize`` re-jit the frame at the new resolution,
- keeps a ``Windows`` manager (the ``VulkanoWindows`` analog) mapping
  window ids to windows; SDL drives one OS window per process, so
  secondary windows are offscreen surfaces (documented deviation),
- optionally decimates the frame on the device before the host fetch
  (``present_divisor``): point sampling, ``divisor``^2 fewer bytes to
  fetch, for previews where the fetch costs more than the frame.

``pygame`` is imported inside ``PygameWindow`` only: ``OffscreenWindow``
and ``run_windowed(app, window=OffscreenWindow(...))`` need none.

Usage::

    app = build_app()
    from mo_renderer_tpu_torch.app.window import run_windowed
    run_windowed(app)            # blocks until close / Escape
"""

from __future__ import annotations

import dataclasses
import enum
import logging
import math
import os

import numpy as np

from ..scene.input import EInputButton, Input

logger = logging.getLogger("mo_renderer_tpu_torch")


class WindowMode(enum.Enum):
    """How a window is displayed (mo_vk/src/window.rs:288-300)."""

    WINDOWED = "windowed"
    BORDERLESS_FULLSCREEN = "borderless_fullscreen"
    SIZED_FULLSCREEN = "sized_fullscreen"
    FULLSCREEN = "fullscreen"


@dataclasses.dataclass
class WindowResizeConstraints:
    """Min/max resize limits (window.rs:366-424), same defaults."""

    min_width: float = 180.0
    min_height: float = 120.0
    max_width: float = math.inf
    max_height: float = math.inf

    def check_constraints(self) -> "WindowResizeConstraints":
        """Sanitize (window.rs:398-424): floor mins at 1, max >= min."""
        min_w = max(self.min_width, 1.0)
        min_h = max(self.min_height, 1.0)
        max_w = self.max_width
        max_h = self.max_height
        if max_w < min_w:
            logger.warning(
                "maximum width %s is smaller than the minimum width %s",
                max_w, min_w,
            )
            max_w = min_w
        if max_h < min_h:
            logger.warning(
                "maximum height %s is smaller than the minimum height %s",
                max_h, min_h,
            )
            max_h = min_h
        return WindowResizeConstraints(min_w, min_h, max_w, max_h)

    def clamp(self, width: int, height: int) -> tuple[int, int]:
        c = self.check_constraints()
        w = int(min(max(width, c.min_width), c.max_width))
        h = int(min(max(height, c.min_height), c.max_height))
        return w, h


@dataclasses.dataclass
class WindowDescriptor:
    """Creation parameters for a window (window.rs:304-363, same
    defaults: 1280x720, vsync, windowed, resizable, decorated)."""

    width: float = 1280.0
    height: float = 720.0
    position: tuple[float, float] | None = None
    resize_constraints: WindowResizeConstraints = dataclasses.field(
        default_factory=WindowResizeConstraints
    )
    scale_factor_override: float | None = None
    title: str = "mo_renderer_tpu"
    present_vsync: bool = True  # PresentMode::Fifo analog
    resizable: bool = True
    decorations: bool = True
    cursor_visible: bool = True
    cursor_locked: bool = False
    mode: WindowMode = WindowMode.WINDOWED
    transparent: bool = False  # accepted for parity; SDL shell ignores it

    def pygame_flags(self, pg) -> int:
        """WindowMode + decoration/resizable -> pygame display flags
        (the shell's analog of winit window attributes,
        window.rs:48-105)."""
        flags = 0
        if self.mode == WindowMode.BORDERLESS_FULLSCREEN:
            # borderless at desktop resolution: NOFRAME + FULLSCREEN
            flags |= pg.FULLSCREEN | pg.NOFRAME
        elif self.mode in (WindowMode.FULLSCREEN, WindowMode.SIZED_FULLSCREEN):
            # exclusive fullscreen; SIZED keeps the requested size and
            # lets SDL pick the closest mode and scale (SCALED)
            flags |= pg.FULLSCREEN
            if self.mode == WindowMode.SIZED_FULLSCREEN:
                flags |= getattr(pg, "SCALED", 0)
        else:
            if not self.decorations:
                flags |= pg.NOFRAME
            if self.resizable:
                flags |= pg.RESIZABLE
        return flags


# winit ModifiersState names (input.rs:331-335 tracks ModifiersChanged)
_MOD_SHIFT = "Shift"
_MOD_CTRL = "Ctrl"
_MOD_ALT = "Alt"
_MOD_LOGO = "Logo"


class PygameWindow:
    """A pygame window mapped onto the Input state machine.

    Event translation mirrors the reference's dispatch: keyboard and
    mouse-button window events -> ``Input.press``/``release``
    (input.rs:315-341), relative mouse motion -> ``Input.move_mouse``
    (the ``DeviceEvent::MouseMotion`` raw-delta path, input.rs:343-350),
    modifier keys -> ``Input.modifiers`` (input.rs:331-335), wheel ->
    ``Input.scroll``, dropped files -> ``Input.drop_file``, live resizes
    -> ``pending_resize`` (consumed by the frame loop's
    swapchain-recreate analog).
    """

    # pygame button number -> reference button identifier
    _MOUSE = {
        1: EInputButton.MOUSE_LEFT,
        2: EInputButton.MOUSE_MIDDLE,
        3: EInputButton.MOUSE_RIGHT,
    }

    def __init__(self, width: int, height: int,
                 title: str = "mo_renderer_tpu", headless: bool = False,
                 descriptor: WindowDescriptor | None = None):
        if headless and "DISPLAY" not in os.environ:
            os.environ.setdefault("SDL_VIDEODRIVER", "dummy")
        import pygame

        self._pg = pygame
        pygame.display.init()
        # when built from an explicit (width, height) rather than a
        # descriptor, loosen the default minimum constraints to honor the
        # requested size (tests use tiny windows)
        self.descriptor = descriptor or WindowDescriptor(
            width=float(width), height=float(height), title=title,
            resize_constraints=WindowResizeConstraints(
                min_width=min(180.0, float(width)),
                min_height=min(120.0, float(height)),
            ),
        )
        width, height = self.descriptor.resize_constraints.clamp(width, height)
        flags = self.descriptor.pygame_flags(pygame)
        try:
            self.surface = pygame.display.set_mode(
                (width, height), flags,
                vsync=1 if self.descriptor.present_vsync else 0,
            )
        except (TypeError, pygame.error):  # vsync/flags unsupported (dummy)
            self.surface = pygame.display.set_mode((width, height))
        pygame.display.set_caption(self.descriptor.title or title)
        self.width, self.height = self.surface.get_size()
        self._grabbed = False
        self.pending_resize: tuple[int, int] | None = None
        if self.descriptor.cursor_locked:
            self._set_grab(True)
        if not self.descriptor.cursor_visible:
            try:
                pygame.mouse.set_visible(False)
            except pygame.error:
                pass

    # --- event pump ------------------------------------------------------
    def _button_of_key(self, ev) -> str | None:
        name = self._pg.key.name(ev.key)
        if len(name) == 1 and name.isalnum():
            return EInputButton.key(name)
        return {"space": "KeySpace", "left shift": "KeyLShift",
                "left ctrl": "KeyLCtrl"}.get(name)

    def _update_modifiers(self, input_res: Input) -> None:
        """ModifiersChanged analog (input.rs:331-335): mirror the live
        modifier state into Input.modifiers as winit-style names."""
        pg = self._pg
        mods = pg.key.get_mods()
        state = set()
        if mods & pg.KMOD_SHIFT:
            state.add(_MOD_SHIFT)
        if mods & pg.KMOD_CTRL:
            state.add(_MOD_CTRL)
        if mods & pg.KMOD_ALT:
            state.add(_MOD_ALT)
        if mods & getattr(pg, "KMOD_GUI", getattr(pg, "KMOD_META", 0)):
            state.add(_MOD_LOGO)
        input_res.modifiers = state

    def pump(self, input_res: Input) -> bool:
        """Translate pending OS events into input_res.

        Returns False when the user closed the window or hit Escape
        (the reference's ``WindowEvent::CloseRequested`` handling,
        mod.rs:191-196).  Live resizes are clamped to the descriptor's
        constraints and stored in ``pending_resize`` for the frame loop
        (the ``WindowEvent::Resized`` -> recreate-swapchain path)."""
        pg = self._pg
        for ev in pg.event.get():
            if ev.type == pg.QUIT:
                return False
            elif ev.type == pg.KEYDOWN:
                if ev.key == pg.K_ESCAPE:
                    return False
                self._update_modifiers(input_res)
                b = self._button_of_key(ev)
                if b is not None:
                    input_res.press(b)
            elif ev.type == pg.KEYUP:
                self._update_modifiers(input_res)
                b = self._button_of_key(ev)
                if b is not None:
                    input_res.release(b)
            elif ev.type == pg.MOUSEBUTTONDOWN and ev.button in self._MOUSE:
                input_res.press(self._MOUSE[ev.button])
                if ev.button == 3:
                    self._set_grab(True)  # fly mode: capture the cursor
            elif ev.type == pg.MOUSEBUTTONUP and ev.button in self._MOUSE:
                input_res.release(self._MOUSE[ev.button])
                if ev.button == 3:
                    self._set_grab(False)
            elif ev.type == pg.MOUSEMOTION:
                input_res.move_mouse(float(ev.rel[0]), float(ev.rel[1]))
            elif ev.type == pg.MOUSEWHEEL:
                input_res.scroll(float(ev.y))
            elif ev.type == pg.DROPFILE:
                input_res.drop_file(ev.file)
            elif ev.type == pg.VIDEORESIZE and self.descriptor.resizable:
                w, h = self.descriptor.resize_constraints.clamp(ev.w, ev.h)
                if (w, h) != (self.width, self.height):
                    self.pending_resize = (w, h)
        return True

    def apply_resize(self) -> tuple[int, int] | None:
        """Recreate the display surface at the pending size; returns the
        new (w, h) or None.  The caller resizes camera + renderer (the
        swapchain-recreate analog, mo_vk/src/lib.rs:352-388)."""
        if self.pending_resize is None:
            return None
        w, h = self.pending_resize
        self.pending_resize = None
        flags = self.descriptor.pygame_flags(self._pg)
        self.surface = self._pg.display.set_mode((w, h), flags)
        self.width, self.height = self.surface.get_size()
        logger.info("window resized to %dx%d", self.width, self.height)
        return (self.width, self.height)

    def _set_grab(self, grab: bool) -> None:
        """Cursor capture while flying (window.rs cursor_locked mode)."""
        try:
            self._pg.event.set_grab(grab)
            self._pg.mouse.set_visible(not grab)
            self._grabbed = grab
        except self._pg.error:  # dummy driver has no cursor
            pass

    # --- present ---------------------------------------------------------
    def present(self, frame: np.ndarray) -> None:
        """Blit an (h, w, 4) uint8 rgba frame and flip; frames smaller
        than the window (device-side downscaled previews) are scaled up."""
        pg = self._pg
        # surfarray wants (W, H, 3)
        rgb = np.ascontiguousarray(np.transpose(frame[..., :3], (1, 0, 2)))
        fw, fh = rgb.shape[0], rgb.shape[1]
        if (fw, fh) == (self.width, self.height):
            pg.surfarray.blit_array(self.surface, rgb)
        else:
            small = pg.Surface((fw, fh))
            pg.surfarray.blit_array(small, rgb)
            pg.transform.scale(small, (self.width, self.height), self.surface)
        pg.display.flip()

    def set_title(self, title: str) -> None:
        self._pg.display.set_caption(title)

    def close(self) -> None:
        self._pg.display.quit()


class OffscreenWindow:
    """A non-OS-backed window target (plain surface).

    SDL drives at most one display window per process, so the
    ``Windows`` manager backs secondary windows with offscreen surfaces:
    same present/resize surface API, no OS events.  (The reference's
    multi-window map is real OS windows, window.rs:32-160 — documented
    deviation.)"""

    def __init__(self, width: int, height: int,
                 descriptor: WindowDescriptor | None = None):
        self.descriptor = descriptor or WindowDescriptor(
            width=float(width), height=float(height)
        )
        self.width, self.height = self.descriptor.resize_constraints.clamp(
            width, height
        )
        self.frame: np.ndarray | None = None
        self.pending_resize: tuple[int, int] | None = None

    def pump(self, input_res: Input) -> bool:
        return True

    def apply_resize(self):
        if self.pending_resize is None:
            return None
        self.width, self.height = self.pending_resize
        self.pending_resize = None
        return (self.width, self.height)

    def present(self, frame: np.ndarray) -> None:
        self.frame = frame

    def set_title(self, title: str) -> None:
        self.descriptor.title = title

    def close(self) -> None:
        self.frame = None


class Windows:
    """Windows manager — the ``VulkanoWindows`` analog (window.rs:32-160):
    a WindowId -> (window, renderer) map with a primary window.

    ``create_window`` builds the window from a ``WindowDescriptor``; the
    first (or ``primary=True``) window is OS-backed via pygame, the rest
    are offscreen surfaces (SDL single-display limitation, see
    OffscreenWindow)."""

    def __init__(self):
        self._windows: dict[int, object] = {}
        self._renderers: dict[int, object] = {}
        self._primary: int | None = None
        self._next_id = 0

    def create_window(self, descriptor: WindowDescriptor | None = None,
                      renderer=None, headless: bool = False) -> int:
        descriptor = descriptor or WindowDescriptor()
        wid = self._next_id
        self._next_id += 1
        w, h = int(descriptor.width), int(descriptor.height)
        if self._primary is None:
            window = PygameWindow(
                w, h, title=descriptor.title, headless=headless,
                descriptor=descriptor,
            )
            self._primary = wid
        else:
            window = OffscreenWindow(w, h, descriptor=descriptor)
        self._windows[wid] = window
        if renderer is not None:
            self._renderers[wid] = renderer
        return wid

    def get_window(self, wid: int):
        return self._windows.get(wid)

    def get_renderer(self, wid: int):
        return self._renderers.get(wid)

    def get_primary_window(self):
        return self._windows.get(self._primary)

    def get_primary_renderer(self):
        return self._renderers.get(self._primary)

    def remove_window(self, wid: int) -> None:
        win = self._windows.pop(wid, None)
        self._renderers.pop(wid, None)
        if win is not None:
            win.close()
        if wid == self._primary:
            self._primary = next(iter(self._windows), None)

    def __len__(self):
        return len(self._windows)

    def __iter__(self):
        return iter(self._windows.items())


def run_windowed(app, window: PygameWindow | None = None,
                 max_frames: int | None = None,
                 headless: bool = False,
                 present_divisor: int = 1) -> int:
    """The interactive frame loop (mod.rs:178-283): pump OS events into
    Input, run the runtime systems (Timer + update_camera consume Input),
    render, present, repeat until close/Escape.  Returns frames shown.

    present_divisor > 1 keeps every ``divisor``-th row and column of the
    frame on the device (point sampling, ``ceil(H / d)`` rows) before the
    host fetch, and the blit upscales: the fetch moves ``divisor``^2 fewer
    bytes.

    Live resizes (when the window descriptor is resizable) run the
    swapchain-recreate analog: ``Camera.resize`` + ``Renderer.resize``,
    then the next frame renders at the new size."""
    from ..passes.present import unpack_rgba8
    from ..scene.camera import Camera
    from ..scene.timer import Timer

    app.resumed()
    input_res = app.world.get_resource(Input)
    if input_res is None:
        input_res = Input()
        app.world.insert_resource(input_res)
    own_window = window is None
    if own_window:
        window = PygameWindow(
            app.config.width, app.config.height, headless=headless
        )
    frames = 0
    try:
        while max_frames is None or frames < max_frames:
            if not window.pump(input_res):
                break
            new_size = window.apply_resize()
            if new_size is not None:
                # swapchain-recreate analog (mo_vk/src/lib.rs:352-388)
                camera = app.world.get_resource(Camera)
                if camera is not None:
                    camera.resize(new_size)
                app.renderer.resize(*new_size)
                app.config = app.renderer.config
            app.runtime_schedule.run(app.world)
            # a frame of its own (on a card, a clone of the replayed
            # graph's output), so the slice below is a view of it
            rgba_dev = app.renderer.render_device(app.world)
            if present_divisor > 1:
                rgba_dev = rgba_dev[::present_divisor, ::present_divisor]
            app.renderer.stage_overflow()  # as Renderer.render
            frame = unpack_rgba8(rgba_dev)
            app.renderer.check_overflow()
            app.frame_index += 1
            window.present(frame)
            # raw deltas are a per-frame accumulation (input.rs:343-350)
            input_res.clear_mouse_delta()
            input_res.scroll_delta = 0.0
            frames += 1
            if frames % 30 == 0:
                timer = app.world.get_resource(Timer)
                if timer is not None and timer.fps() > 0:
                    window.set_title(
                        f"mo_renderer_tpu — {timer.fps():.1f} fps"
                    )
    finally:
        if own_window:
            window.close()
    logger.info("window loop ended after %d frames", frames)
    return frames
