"""Quaternion math (glam conventions: [x, y, z, w], unit quats, RH).

Pure numpy float32 functions.  These back the host-side ``Transform``
component; device-side kernels use jnp equivalents where needed.
"""

from __future__ import annotations

import numpy as np

IDENTITY = np.array([0.0, 0.0, 0.0, 1.0], dtype=np.float32)


def normalize(q: np.ndarray) -> np.ndarray:
    q = np.asarray(q, dtype=np.float32)
    return q / np.linalg.norm(q)


def from_axis_angle(axis, angle: float) -> np.ndarray:
    axis = np.asarray(axis, dtype=np.float32)
    axis = axis / np.linalg.norm(axis)
    half = 0.5 * float(angle)
    s = np.sin(half)
    return np.array(
        [axis[0] * s, axis[1] * s, axis[2] * s, np.cos(half)], dtype=np.float32
    )


def from_rotation_x(angle: float) -> np.ndarray:
    return from_axis_angle([1.0, 0.0, 0.0], angle)


def from_rotation_y(angle: float) -> np.ndarray:
    return from_axis_angle([0.0, 1.0, 0.0], angle)


def from_rotation_z(angle: float) -> np.ndarray:
    return from_axis_angle([0.0, 0.0, 1.0], angle)


def mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Hamilton product a * b (apply b first, then a)."""
    ax, ay, az, aw = np.asarray(a, dtype=np.float32)
    bx, by, bz, bw = np.asarray(b, dtype=np.float32)
    return np.array(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dtype=np.float32,
    )


def conjugate(q: np.ndarray) -> np.ndarray:
    x, y, z, w = np.asarray(q, dtype=np.float32)
    return np.array([-x, -y, -z, w], dtype=np.float32)


def rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate vector v by unit quaternion q."""
    q = np.asarray(q, dtype=np.float32)
    v = np.asarray(v, dtype=np.float32)
    u = q[:3]
    w = q[3]
    # v' = v + 2*w*(u x v) + 2*(u x (u x v))
    uv = np.cross(u, v)
    uuv = np.cross(u, uv)
    return (v + 2.0 * (w * uv + uuv)).astype(np.float32)


def to_mat3(q: np.ndarray) -> np.ndarray:
    """3x3 rotation matrix (m[row, col]; columns are rotated basis vectors)."""
    x, y, z, w = np.asarray(q, dtype=np.float32)
    x2, y2, z2 = x + x, y + y, z + z
    xx, xy, xz = x * x2, x * y2, x * z2
    yy, yz, zz = y * y2, y * z2, z * z2
    wx, wy, wz = w * x2, w * y2, w * z2
    return np.array(
        [
            [1.0 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1.0 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1.0 - (xx + yy)],
        ],
        dtype=np.float32,
    )


def from_mat3(m: np.ndarray) -> np.ndarray:
    """Quaternion from a 3x3 rotation matrix m[row, col] (glam from_mat3)."""
    m = np.asarray(m, dtype=np.float64)
    t = m[0, 0] + m[1, 1] + m[2, 2]
    if t > 0.0:
        s = np.sqrt(t + 1.0) * 2.0
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2.0
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2.0
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2.0
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    return normalize(np.array([x, y, z, w], dtype=np.float32))


def to_euler_yxz(q: np.ndarray):
    """Decompose into (yaw, pitch, roll) with EulerRot::YXZ semantics:
    rotation = Ry(yaw) * Rx(pitch) * Rz(roll).  Matches bevy_math's
    ``Quat::to_euler(EulerRot::YXZ)`` used by Camera::update_camera
    (mo_ecs/src/resource/camera.rs:278)."""
    m = to_mat3(q).astype(np.float64)
    # R = Ry(a) Rx(b) Rz(c).
    # m[1,2] = -sin(b)
    sb = -m[1, 2]
    sb = np.clip(sb, -1.0, 1.0)
    b = np.arcsin(sb)
    if abs(sb) < 0.9999999:
        a = np.arctan2(m[0, 2], m[2, 2])
        c = np.arctan2(m[1, 0], m[1, 1])
    else:  # gimbal lock
        a = np.arctan2(-m[2, 0], m[0, 0])
        c = 0.0
    return float(a), float(b), float(c)


def from_euler_yxz(yaw: float, pitch: float, roll: float) -> np.ndarray:
    """rotation = Ry(yaw) * Rx(pitch) * Rz(roll)."""
    return mul(from_rotation_y(yaw), mul(from_rotation_x(pitch), from_rotation_z(roll)))
