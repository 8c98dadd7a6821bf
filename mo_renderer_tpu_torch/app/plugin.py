"""Plugin system (mo_core/src/application/plugin.rs).

``PluginTrait`` lifecycle: build -> ready -> finish -> cleanup, tracked by
``PluginState`` (plugin.rs:8-17).  Plain callables are accepted as plugins
(the blanket ``Fn(&mut App)`` impl, plugin.rs:60-64).
"""

from __future__ import annotations

import enum


class PluginState(enum.IntEnum):
    """plugin.rs:8-17."""

    ADDING = 0
    READY = 1
    FINISHED = 2
    CLEANED = 3


class PluginTrait:
    """Override build(); the rest are optional hooks (plugin.rs:22-55)."""

    def build(self, app) -> None:
        raise NotImplementedError

    def ready(self, app) -> bool:
        return True

    def finish(self, app) -> None:
        pass

    def cleanup(self, app) -> None:
        pass

    def name(self) -> str:
        return type(self).__name__

    def is_unique(self) -> bool:
        return True


class FunctionPlugin(PluginTrait):
    """Wraps a callable(app) as a plugin (plugin.rs:60-64)."""

    def __init__(self, fn):
        self._fn = fn

    def build(self, app) -> None:
        self._fn(app)

    def name(self) -> str:
        return getattr(self._fn, "__name__", "FunctionPlugin")
