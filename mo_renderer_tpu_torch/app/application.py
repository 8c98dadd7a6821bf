"""App — the application/frame orchestrator (port of
``mo_renderer_tpu/app/application.py``, after mo_core/src/application/mod.rs).

The same API surface as the reference's ``App``: plugins, resources,
startup/runtime schedules, entities, render passes.  ``resumed()`` builds
the port's ``Renderer`` on the App's device and prepares the world; each
``render_frame()`` runs the runtime systems and renders one frame.

The device is the card (``"cuda"``) unless the caller passes another
(``device="cpu"``, as the tests do); without a CUDA device the default
raises instead of carrying on on the CPU.
"""

from __future__ import annotations

import contextlib
import logging

import numpy as np

from ..config import DEFAULT_CONFIG, EngineConfig
from ..device import resolve_device
from ..scene.world import Schedule, World
from ..utils import trace
from .plugin import FunctionPlugin, PluginState, PluginTrait

logger = logging.getLogger("mo_renderer_tpu_torch")

__all__ = ["App", "AppError", "EventLoop"]


class AppError(Exception):
    """mo_core/src/lib.rs:7."""


class EventLoop:
    """API-parity shim for ``winit::EventLoop``: ``run_app(app)`` resumes
    the app and drives the frame loop headlessly."""

    def __init__(self):
        self.max_frames: int | None = None

    def run_app(self, app: "App", num_frames: int = 1, on_frame=None):
        return app.run(num_frames=num_frames, on_frame=on_frame)


class App:
    def __init__(self, event_loop: EventLoop | None = None,
                 config: EngineConfig | None = None, device="cuda"):
        if not logging.getLogger().handlers:
            logging.basicConfig(level=logging.INFO)
        self.device = resolve_device(device)
        self.config = config or DEFAULT_CONFIG
        self.world = World()
        self.startup_schedule = Schedule()
        self.runtime_schedule = Schedule()
        self.plugins: list[tuple[PluginTrait, PluginState]] = []
        self.render_passes: list = []
        self.renderer = None  # built in resumed()
        self.frame_index = 0
        self._resumed = False
        logger.info("mo_renderer_tpu_torch App created (%dx%d) on %s",
                    self.config.width, self.config.height, self.device)

    # --- builder API (mod.rs:81-126) ------------------------------------
    @staticmethod
    def new(event_loop: EventLoop | None = None,
            config: EngineConfig | None = None, device="cuda") -> "App":
        return App(event_loop, config, device)

    def add_plugin(self, plugin) -> "App":
        if not isinstance(plugin, PluginTrait):
            plugin = FunctionPlugin(plugin)
        if plugin.is_unique() and any(
            p.name() == plugin.name() for p, _ in self.plugins
        ):
            raise AppError(f"plugin {plugin.name()} already added")
        plugin.build(self)
        self.plugins.append((plugin, PluginState.ADDING))
        logger.info("plugin added: %s", plugin.name())
        return self

    def init_resource(self, resource_type: type) -> "App":
        self.world.init_resource(resource_type)
        return self

    def insert_resource(self, resource) -> "App":
        self.world.insert_resource(resource)
        return self

    def add_startup_system(self, system) -> "App":
        self.startup_schedule.add_system(system)
        return self

    def add_runtime_system(self, system) -> "App":
        self.runtime_schedule.add_system(system)
        return self

    def add_render_pass(self, render_pass) -> "App":
        self.render_passes.append(render_pass)
        return self

    def add_entity(self, components) -> "App":
        if not isinstance(components, (tuple, list)):
            components = (components,)
        self.world.spawn(components)
        return self

    # --- lifecycle (mod.rs:130-176) -------------------------------------
    def resumed(self) -> None:
        """Build the Renderer on the App's device and prepare the world;
        then the plugin lifecycle and the startup systems."""
        if self._resumed:
            return
        from ..scene.camera import Camera

        camera = self.world.get_resource(Camera)
        if camera is not None:
            camera.resize((self.config.width, self.config.height))
            # movement constants from EngineConfig (camera.rs:13-15);
            # values the user already set on the camera are preserved
            if camera.rotate_speed is None:
                camera.rotate_speed = self.config.rotate_speed
            if camera.move_speed is None:
                camera.move_speed = self.config.move_speed
            if camera.mouse_sensitivity is None:
                camera.mouse_sensitivity = self.config.mouse_sensitivity

        if self.renderer is None:
            from ..passes.frame_graph import Renderer

            self.renderer = Renderer(
                self.config, self.device, extra_passes=self.render_passes
            )
            self.renderer.prepare(self.world)

        # plugin lifecycle: Adding -> Ready -> Finished
        advanced = []
        for plugin, _state in self.plugins:
            if plugin.ready(self):
                plugin.finish(self)
                advanced.append((plugin, PluginState.FINISHED))
            else:
                advanced.append((plugin, PluginState.READY))
        self.plugins = advanced

        self.startup_schedule.run(self.world)
        self._resumed = True
        logger.info("render stack ready; startup systems done")

    # --- frame loop (mod.rs:197-268) ------------------------------------
    def render_frame(self) -> np.ndarray:
        """Run the runtime systems and one frame; returns (H, W, 4) uint8.
        The tracer's spans of the frame carry ``frame_index``."""
        if not self._resumed:
            self.resumed()
        trace.set_frame(self.frame_index)
        with trace.span("frame"):
            with trace.span("runtime_systems"):
                self.runtime_schedule.run(self.world)
            with trace.span("render"):
                frame = self.renderer.render(self.world)
        self.frame_index += 1
        return frame

    def run(self, num_frames: int = 1, on_frame=None,
            profile_dir: str | None = None) -> np.ndarray:
        """Headless frame loop; returns the last frame.

        profile_dir: capture a torch.profiler trace of the loop there
        (``utils.profile_trace``): a Chrome trace that TensorBoard or
        chrome://tracing opens, with the port's tracer on over the loop,
        so its spans show as ``mo::<name>`` ranges beside the device's
        operations and each replayed pass between its marker kernels
        (``utils/trace.py``)."""
        self.resumed()
        from ..utils import profile_trace

        ctx = (profile_trace(profile_dir) if profile_dir
               else contextlib.nullcontext())
        frame = None
        with ctx:
            for _ in range(num_frames):
                frame = self.render_frame()
                if on_frame is not None:
                    on_frame(self.frame_index - 1, frame)
        return frame

    def save_frame(self, path: str, frame: np.ndarray | None = None) -> None:
        from ..assets.image_io import write_png

        if frame is None:
            frame = self.render_frame()
        write_png(path, np.asarray(frame))

    def cleanup(self) -> None:
        for plugin, _ in self.plugins:
            plugin.cleanup(self)
        self.plugins = [(p, PluginState.CLEANED) for p, _ in self.plugins]
