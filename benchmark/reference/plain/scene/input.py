"""Input resource (mo_ecs/src/resource/input.rs).

Collects button/mouse state with the reference's Activated/Hold/Deactivated
state machine (input.rs:15-47) and exposes the same queries
(``button_state``, ``mouse_delta``) the camera system consumes
(camera.rs:260-341).  Headless runs drive it with the scripted-event API
(``press``/``release``/``move_mouse``) — the analog of winit events feeding
``on_window_event``/``on_device_event`` (input.rs:315-350).

A generic action mapper mirrors ``FActionMapper<T>`` (input.rs:76-148).
"""

from __future__ import annotations

import enum
from typing import Generic, Hashable, TypeVar


class EInputState(enum.IntEnum):
    """input.rs:30-47."""

    ACTIVATED = 0
    HOLD = 1
    DEACTIVATED = 2


class EInputButton:
    """Button identifiers (input.rs:15-28): keys by name, mouse buttons."""

    MOUSE_LEFT = "MouseLeft"
    MOUSE_RIGHT = "MouseRight"
    MOUSE_MIDDLE = "MouseMiddle"

    @staticmethod
    def key(name: str) -> str:
        """Key identifier, e.g. key('W')."""
        return f"Key{name.upper()}"


class Input:
    def __init__(self):
        self._buttons: dict[str, EInputState] = {}
        self.mouse_position = (0.0, 0.0)
        self._mouse_delta = (0.0, 0.0)
        self.scroll_delta = 0.0
        self.modifiers: set[str] = set()
        self.dropped_files: list[str] = []

    # --- event ingestion (scripted or windowing backend) ----------------
    def press(self, button: str) -> None:
        # Note: the reference's per-frame decay (`_reset`, input.rs:296-312)
        # is never called by App — buttons stay Activated while held.  We
        # reproduce that: press -> Activated until release.
        self._buttons[button] = EInputState.ACTIVATED

    def release(self, button: str) -> None:
        self._buttons[button] = EInputState.DEACTIVATED

    def move_mouse(self, dx: float, dy: float) -> None:
        """Accumulate a raw mouse delta (input.rs:343-350)."""
        self._mouse_delta = (self._mouse_delta[0] + dx, self._mouse_delta[1] + dy)
        self.mouse_position = (
            self.mouse_position[0] + dx,
            self.mouse_position[1] + dy,
        )

    def scroll(self, amount: float) -> None:
        self.scroll_delta += amount

    def drop_file(self, path: str) -> None:
        self.dropped_files.append(path)

    # --- queries --------------------------------------------------------
    def button_state(self, button: str) -> EInputState | None:
        return self._buttons.get(button)

    def is_activated(self, button: str) -> bool:
        return self._buttons.get(button) == EInputState.ACTIVATED

    def mouse_delta(self) -> tuple[float, float]:
        return self._mouse_delta

    def clear_mouse_delta(self) -> None:
        self._mouse_delta = (0.0, 0.0)


T = TypeVar("T", bound=Hashable)


class FActionMapper(Generic[T]):
    """Maps buttons to user-defined actions (input.rs:76-148)."""

    def __init__(self):
        self._map: dict[str, T] = {}

    def bind(self, button: str, action: T) -> None:
        self._map[button] = action

    def unbind(self, button: str) -> None:
        self._map.pop(button, None)

    def active_actions(self, input_res: Input) -> set:
        return {
            action
            for button, action in self._map.items()
            if input_res.is_activated(button)
        }
