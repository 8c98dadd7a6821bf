"""Camera resource (mo_ecs/src/resource/camera.rs).

Perspective (fov 45deg, near 0.1, far 1000) or orthographic settings; view =
look_at_rh(pos, pos + direction(), up) where ``direction() = rotation * +Z``
(camera.rs:342-350); proj = perspective_rh then ``proj[1,1] *= -1`` Vulkan
flip (camera.rs:225-240).  ``update_camera`` reproduces the right-mouse-drag
yaw/pitch + WASDEQ movement system (camera.rs:256-351).
"""

from __future__ import annotations

import enum

import numpy as np

from ..math import quat
from ..math.projections import look_at_rh, orthographic_rh, perspective_rh
from ..math.transform import Transform
from .input import EInputButton, EInputState, Input
from .timer import Timer

ROTATE_SPEED = np.pi / 10.0  # camera.rs:13
MOVE_SPEED = 0.01  # camera.rs:14
MOUSE_SENSITIVITY = 0.005  # camera.rs:15


class OrthographicCameraSize(enum.IntEnum):
    """camera.rs:20-27."""

    FIXED_WIDTH = 0
    FIXED_HEIGHT = 1
    MIN_WIDTH_HEIGHT = 2


class CameraSettings:
    """Perspective or orthographic projection settings (camera.rs:53-90)."""

    def __init__(self, kind="perspective", **kw):
        self.kind = kind
        if kind == "perspective":
            self.fov = kw.get("fov", np.radians(45.0))
            self.near = kw.get("near", 0.1)
            self.far = kw.get("far", 1000.0)
        else:
            self.width = kw.get("width", 20.0)
            self.height = kw.get("height", 20.0)
            self.size = kw.get("size", OrthographicCameraSize.FIXED_HEIGHT)
            self.near = kw.get("near", -1e6)
            self.far = kw.get("far", 1e6)

    @staticmethod
    def new_perspective() -> "CameraSettings":
        return CameraSettings("perspective")

    @staticmethod
    def new_orthographic() -> "CameraSettings":
        return CameraSettings("orthographic")


def _euler_yxz(q: np.ndarray) -> tuple[float, float, float]:
    """quat -> (yaw, pitch, roll) in YXZ order (glam EulerRot::YXZ)."""
    m = quat.to_mat3(q)
    pitch = np.arcsin(np.clip(-m[1, 2], -1.0, 1.0))
    yaw = np.arctan2(m[0, 2], m[2, 2])
    roll = np.arctan2(m[1, 0], m[1, 1])
    return float(yaw), float(pitch), float(roll)


def _from_euler_yxz(yaw: float, pitch: float, roll: float) -> np.ndarray:
    return quat.mul(
        quat.mul(quat.from_rotation_y(yaw), quat.from_rotation_x(pitch)),
        quat.from_rotation_z(roll),
    )


class Camera:
    def __init__(self, position=(0.0, 0.0, 0.0), rotation=None):
        self.transform = Transform(translation=position, rotation=rotation)
        self.settings = CameraSettings.new_perspective()
        self._aspect = 1.0
        self._view: np.ndarray | None = None  # built lazily from transform
        self._prev_view: np.ndarray | None = None
        self._proj = np.eye(4, dtype=np.float32)
        self.is_dirty = True
        # movement constants (camera.rs:13-15); None = not explicitly set,
        # App.resumed fills them from EngineConfig (whose defaults are the
        # reference values) — a user-set value always wins.
        self.rotate_speed: float | None = None
        self.move_speed: float | None = None
        self.mouse_sensitivity: float | None = None

    # --- accessors (camera.rs:140-201) ----------------------------------
    def position(self) -> np.ndarray:
        return self.transform.translation

    def direction(self) -> np.ndarray:
        return self.transform.direction()

    def up(self) -> np.ndarray:
        return self.transform.up()

    def right(self) -> np.ndarray:
        return self.transform.right()

    def near_p(self) -> float:
        return self.settings.near

    def fov(self) -> float:
        return self.settings.fov if self.settings.kind == "perspective" else 0.0

    def aspect(self) -> float:
        return self._aspect

    def view(self) -> np.ndarray:
        if self._view is None:
            self.refresh_view()
        return self._view

    def refresh_view(self) -> np.ndarray:
        """Rebuild the view matrix from the transform (camera.rs:342-350):
        prev_view <- view, view <- look_at_rh(pos, pos + direction, up)."""
        direction = self.direction()
        right = np.cross(direction, np.array([0.0, 1.0, 0.0], np.float32))
        right = right / np.linalg.norm(right)
        up = np.cross(right, direction)
        up = up / np.linalg.norm(up)
        pos = self.position()
        prev = self._view
        self._view = look_at_rh(pos, pos + direction, up)
        self._prev_view = prev if prev is not None else self._view
        return self._view

    def view_matrix_static(self) -> np.ndarray:
        """View with zero translation (camera.rs:132-138)."""
        v = self.view().copy()
        v[:3, 3] = 0.0
        return v

    def projection(self) -> np.ndarray:
        return self._proj

    def projection_view(self) -> np.ndarray:
        return (self._proj @ self.view()).astype(np.float32)

    def inverse_projection(self) -> np.ndarray:
        return np.linalg.inv(self._proj.astype(np.float64)).astype(np.float32)

    def inverse_view(self) -> np.ndarray:
        return np.linalg.inv(self.view().astype(np.float64)).astype(np.float32)

    def prev_view(self) -> np.ndarray:
        if self._prev_view is None:
            self.view()
        return self._prev_view

    # --- projection rebuild (camera.rs:203-253) -------------------------
    def resize(self, window_size) -> None:
        w, h = float(window_size[0]), float(window_size[1])
        self._aspect = w / h
        s = self.settings
        if s.kind == "perspective":
            proj = perspective_rh(s.fov, w / h, s.near, s.far)
        else:
            if s.size == OrthographicCameraSize.FIXED_WIDTH:
                hw, hh = _fixed_width(s.width, w, h)
            elif s.size == OrthographicCameraSize.FIXED_HEIGHT:
                hw, hh = _fixed_height(s.height, w, h)
            else:
                if s.width / s.height > w / h:
                    hw, hh = _fixed_width(s.width, w, h)
                else:
                    hw, hh = _fixed_height(s.height, w, h)
            proj = orthographic_rh(-hw, hw, -hh, hh, s.near, s.far)
        proj[1, 1] *= -1.0  # Vulkan Y flip (camera.rs:239)
        self._proj = proj

    # --- the update system (camera.rs:256-351) --------------------------
    @staticmethod
    def update_camera(world) -> None:
        camera: Camera = world.resource(Camera)
        input_res: Input = world.resource(Input)
        timer: Timer = world.resource(Timer)
        dt = timer.delta()
        rot_speed = (
            camera.rotate_speed if camera.rotate_speed is not None else ROTATE_SPEED
        )
        mouse_sens = (
            camera.mouse_sensitivity
            if camera.mouse_sensitivity is not None
            else MOUSE_SENSITIVITY
        )
        move_speed = (
            camera.move_speed if camera.move_speed is not None else MOVE_SPEED
        )

        if input_res.button_state(EInputButton.MOUSE_RIGHT) == EInputState.ACTIVATED:
            dx, dy = input_res.mouse_delta()
            yaw_amount = -dx * rot_speed * dt * mouse_sens
            pitch_amount = dy * rot_speed * dt * mouse_sens
            # yaw about world Y, pitch about local X (camera.rs:270-275)
            camera.transform.rotation = quat.mul(
                quat.mul(quat.from_rotation_y(yaw_amount), camera.transform.rotation),
                quat.from_rotation_x(pitch_amount),
            )
            yaw, pitch, _roll = _euler_yxz(camera.transform.rotation)
            pitch = np.clip(pitch, -np.pi / 2 + 0.001, np.pi / 2 - 0.001)
            # zero roll, renormalize (camera.rs:283-289)
            camera.transform.rotation = quat.normalize(_from_euler_yxz(yaw, pitch, 0.0))
            camera.is_dirty = True

        act = input_res.is_activated
        keys = [act(EInputButton.key(k)) for k in "WASDEQ"]
        if any(keys):
            # movement math only when a key is down: the idle frame loop
            # runs this system every frame (mod.rs:198) and the numpy
            # cross/normalize chain is measurable host time per frame
            kw, ka, ks, kd, ke, kq = keys
            direction = camera.direction()
            right = np.cross(direction, np.array([0.0, 1.0, 0.0], np.float32))
            right = right / np.linalg.norm(right)

            movement = np.zeros(3, np.float32)
            if kw:
                movement += direction * dt
            if ka:
                movement -= right * dt
            if ks:
                movement -= direction * dt
            if kd:
                movement += right * dt
            if ke:
                movement += np.array([0.0, dt, 0.0], np.float32)
            if kq:
                movement -= np.array([0.0, dt, 0.0], np.float32)

            n = np.linalg.norm(movement)
            if n > 0.0:
                camera.transform.translation = (
                    camera.transform.translation + movement / n * move_speed
                )
                camera.is_dirty = True

        if not camera.is_dirty:
            return
        # NOTE: the reference never clears is_dirty (camera.rs:342-350), so
        # the view/prev_view pair is refreshed every frame.  Reproduced.
        camera.refresh_view()


def _fixed_width(width: float, w: float, h: float) -> tuple[float, float]:
    hw = width / 2.0
    return hw, hw * h / w


def _fixed_height(height: float, w: float, h: float) -> tuple[float, float]:
    hh = height / 2.0
    return hh * h / w, hh
