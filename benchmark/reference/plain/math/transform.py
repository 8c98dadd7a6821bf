"""TRS Transform component mirroring the reference's bevy-style Transform
(mo_ecs/src/component/transform.rs).

Sign conventions preserved exactly:
- ``direction() = rotation * +Z`` (transform.rs:161-163) — note this points
  *backwards* relative to bevy's ``forward() = -local_z``.
- ``look_to(direction, up)`` builds rotation columns (right, up, back) with
  ``back = -direction`` (transform.rs:349-358), so after ``looking_at(t)``
  the ``direction()`` vector points *away* from ``t``.  Downstream code
  (DirectionalLight::proj_view, GpuLight packing + shader sign flips) relies
  on this; we reproduce it bit-for-bit.
"""

from __future__ import annotations

import numpy as np

from . import quat
from .projections import from_scale_rotation_translation


def _as_vec3(v) -> np.ndarray:
    a = np.asarray(v, dtype=np.float32).reshape(3)
    return a.copy()


class Transform:
    """Mutable TRS transform: translation Vec3, rotation quat, scale Vec3."""

    __slots__ = ("translation", "rotation", "scale")

    def __init__(self, translation=None, rotation=None, scale=None):
        self.translation = (
            _as_vec3(translation) if translation is not None else np.zeros(3, np.float32)
        )
        self.rotation = (
            np.asarray(rotation, dtype=np.float32).reshape(4).copy()
            if rotation is not None
            else quat.IDENTITY.copy()
        )
        self.scale = _as_vec3(scale) if scale is not None else np.ones(3, np.float32)

    # --- constructors (transform.rs from_xyz / from_matrix / from_translation)
    @staticmethod
    def from_xyz(x: float, y: float, z: float) -> "Transform":
        return Transform(translation=[x, y, z])

    @staticmethod
    def from_translation(t) -> "Transform":
        return Transform(translation=t)

    @staticmethod
    def from_rotation(r) -> "Transform":
        return Transform(rotation=r)

    @staticmethod
    def from_scale(s) -> "Transform":
        return Transform(scale=s)

    @staticmethod
    def from_matrix(m: np.ndarray) -> "Transform":
        """Decompose a TRS matrix (glam to_scale_rotation_translation)."""
        m = np.asarray(m, dtype=np.float32)
        t = m[:3, 3].copy()
        basis = m[:3, :3].astype(np.float64)
        scale = np.linalg.norm(basis, axis=0)
        det = np.linalg.det(basis)
        if det < 0:
            scale[0] = -scale[0]
        rot3 = basis / scale[None, :]
        return Transform(
            translation=t, rotation=quat.from_mat3(rot3), scale=scale.astype(np.float32)
        )

    # --- builder-style API
    def with_translation(self, t) -> "Transform":
        self.translation = _as_vec3(t)
        return self

    def with_rotation(self, r) -> "Transform":
        self.rotation = np.asarray(r, dtype=np.float32).reshape(4).copy()
        return self

    def with_scale(self, s) -> "Transform":
        self.scale = _as_vec3(s)
        return self

    def looking_at(self, target, up=(0.0, 1.0, 0.0)) -> "Transform":
        self.look_at(target, up)
        return self

    def looking_to(self, direction, up=(0.0, 1.0, 0.0)) -> "Transform":
        self.look_to(direction, up)
        return self

    # --- direction basis (transform.rs:160-233)
    def direction(self) -> np.ndarray:
        """rotation * +Z (transform.rs:161-163)."""
        return quat.rotate(self.rotation, np.array([0.0, 0.0, 1.0], np.float32))

    def local_x(self) -> np.ndarray:
        return quat.rotate(self.rotation, np.array([1.0, 0.0, 0.0], np.float32))

    def local_y(self) -> np.ndarray:
        return quat.rotate(self.rotation, np.array([0.0, 1.0, 0.0], np.float32))

    def local_z(self) -> np.ndarray:
        return quat.rotate(self.rotation, np.array([0.0, 0.0, 1.0], np.float32))

    def right(self) -> np.ndarray:
        return self.local_x()

    def left(self) -> np.ndarray:
        return -self.local_x()

    def up(self) -> np.ndarray:
        return self.local_y()

    def down(self) -> np.ndarray:
        return -self.local_y()

    def forward(self) -> np.ndarray:
        return -self.local_z()

    def back(self) -> np.ndarray:
        return self.local_z()

    # --- matrices
    def model_matrix(self) -> np.ndarray:
        """M = T * R * S (transform.rs:167)."""
        return from_scale_rotation_translation(
            self.scale, quat.to_mat3(self.rotation), self.translation
        )

    def model_matrix_without_scale(self) -> np.ndarray:
        return from_scale_rotation_translation(
            np.ones(3, np.float32), quat.to_mat3(self.rotation), self.translation
        )

    # --- look / align (transform.rs:337-362)
    def look_at(self, target, up=(0.0, 1.0, 0.0)):
        self.look_to(_as_vec3(target) - self.translation, up)

    def look_to(self, direction, up=(0.0, 1.0, 0.0)):
        d = _as_vec3(direction)
        n = np.linalg.norm(d)
        back = -(d / n) if n > 0 else np.array([0.0, 0.0, 1.0], np.float32)
        upv = _as_vec3(up)
        un = np.linalg.norm(upv)
        upv = upv / un if un > 0 else np.array([0.0, 1.0, 0.0], np.float32)
        right = np.cross(upv, back)
        rn = np.linalg.norm(right)
        if rn < 1e-8:
            # up parallel to back: any orthonormal vector
            right = np.cross(np.array([1.0, 0.0, 0.0], np.float32), back)
            rn = np.linalg.norm(right)
            if rn < 1e-8:
                right = np.cross(np.array([0.0, 1.0, 0.0], np.float32), back)
                rn = np.linalg.norm(right)
        right = right / rn
        upv = np.cross(back, right)
        m = np.stack([right, upv, back], axis=1)  # columns
        self.rotation = quat.from_mat3(m)

    # --- rotation helpers (transform.rs rotate_* family)
    def rotate(self, q):
        self.rotation = quat.mul(np.asarray(q, np.float32), self.rotation)

    def rotate_axis(self, axis, angle: float):
        self.rotate(quat.from_axis_angle(axis, angle))

    def rotate_x(self, angle: float):
        self.rotate(quat.from_rotation_x(angle))

    def rotate_y(self, angle: float):
        self.rotate(quat.from_rotation_y(angle))

    def rotate_z(self, angle: float):
        self.rotate(quat.from_rotation_z(angle))

    def rotate_local(self, q):
        self.rotation = quat.mul(self.rotation, np.asarray(q, np.float32))

    def rotate_local_x(self, angle: float):
        self.rotate_local(quat.from_rotation_x(angle))

    def rotate_local_y(self, angle: float):
        self.rotate_local(quat.from_rotation_y(angle))

    def rotate_local_z(self, angle: float):
        self.rotate_local(quat.from_rotation_z(angle))

    # --- point transforms (transform.rs:445-470)
    def transform_point(self, p) -> np.ndarray:
        p = _as_vec3(p)
        return quat.rotate(self.rotation, self.scale * p) + self.translation

    def mul_transform(self, other: "Transform") -> "Transform":
        return Transform(
            translation=self.transform_point(other.translation),
            rotation=quat.mul(self.rotation, other.rotation),
            scale=self.scale * other.scale,
        )

    def __repr__(self):
        return (
            f"Transform(t={self.translation.tolist()}, "
            f"r={self.rotation.tolist()}, s={self.scale.tolist()})"
        )
