"""Projection / view matrices with glam + Vulkan conventions.

Matrices are (4, 4) numpy float32 in standard ``m[row, col]`` form so that a
point transforms as ``m @ [x, y, z, 1]``.  Depth range is Vulkan [0, 1];
NDC y points down after the engine's explicit Y flip.

Conventions mirrored from the reference:
- ``perspective_rh`` + y-flip: mo_ecs/src/resource/camera.rs:225-240
  (``projection.y_axis.y *= -1``).
- ``look_at_rh``: glam, used by camera.rs:347 and directional_light.rs:45-49.
- ``orthographic_rh`` with swapped bottom/top for the light:
  mo_ecs/src/component/directional_light.rs:52-59.
"""

from __future__ import annotations

import numpy as np


def perspective_rh(fov_y: float, aspect: float, near: float, far: float) -> np.ndarray:
    """glam Mat4::perspective_rh — right-handed, depth [0, 1]."""
    f = 1.0 / np.tan(0.5 * fov_y)
    r = far / (near - far)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = r
    m[2, 3] = r * near
    m[3, 2] = -1.0
    return m


def perspective_rh_vulkan(fov_y: float, aspect: float, near: float, far: float) -> np.ndarray:
    """perspective_rh followed by the engine's Y flip (camera.rs:239)."""
    m = perspective_rh(fov_y, aspect, near, far)
    m[1, 1] *= -1.0
    return m


def orthographic_rh(
    left: float, right: float, bottom: float, top: float, near: float, far: float
) -> np.ndarray:
    """glam Mat4::orthographic_rh — right-handed, depth [0, 1]."""
    rw = 1.0 / (right - left)
    rh = 1.0 / (top - bottom)
    r = 1.0 / (near - far)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = 2.0 * rw
    m[1, 1] = 2.0 * rh
    m[2, 2] = r
    m[0, 3] = -(left + right) * rw
    m[1, 3] = -(top + bottom) * rh
    m[2, 3] = r * near
    m[3, 3] = 1.0
    return m


def look_at_rh(eye, center, up) -> np.ndarray:
    """glam Mat4::look_at_rh."""
    eye = np.asarray(eye, dtype=np.float32)
    center = np.asarray(center, dtype=np.float32)
    up = np.asarray(up, dtype=np.float32)
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def from_scale_rotation_translation(scale, rotation_mat3, translation) -> np.ndarray:
    """Compose M = T * R * S (glam Mat4::from_scale_rotation_translation)."""
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = np.asarray(rotation_mat3, dtype=np.float32) * np.asarray(
        scale, dtype=np.float32
    )[None, :]
    m[:3, 3] = np.asarray(translation, dtype=np.float32)
    return m


def inverse(m: np.ndarray) -> np.ndarray:
    return np.linalg.inv(np.asarray(m, dtype=np.float64)).astype(np.float32)


def normal_matrix(world: np.ndarray) -> np.ndarray:
    """(world^-1)^T upper 3x3 — the per-mesh normal matrix the reference
    pushes per draw (gbuffer_pass.rs:516-548, gbuffer.vert:40)."""
    inv = np.linalg.inv(np.asarray(world, dtype=np.float64))
    return inv.T[:3, :3].astype(np.float32)
