"""Light components (mo_ecs/src/component/directional_light.rs + the
point/spot light types the reference's GpuLight struct supports,
resources/shaders/include/pbr.glsl:172-181, :200-217).
"""

from __future__ import annotations

import numpy as np

from ..math.projections import look_at_rh, orthographic_rh
from ..math.transform import Transform

# GpuLight type codes (pbr.glsl surfaceShading branches :200-217).
LIGHT_DIRECTIONAL = 0.0
LIGHT_POINT = 1.0
LIGHT_SPOT = 2.0


class DirectionalLight:
    """directional_light.rs:6-37. Defaults: white, intensity 1, no shadow,
    shadow half-extents 8.0."""

    def __init__(
        self,
        transform: Transform | None = None,
        color=(1.0, 1.0, 1.0),
        intensity: float = 1.0,
        is_shadow_caster: bool = False,
        shadow_width: float = 8.0,
        shadow_height: float = 8.0,
    ):
        self.transform = transform if transform is not None else Transform()
        self.color = np.asarray(color, dtype=np.float32).reshape(3).copy()
        self.intensity = float(intensity)
        self.is_shadow_caster = bool(is_shadow_caster)
        self.shadow_width = float(shadow_width)
        self.shadow_height = float(shadow_height)

    def proj_view(self) -> np.ndarray:
        """Light projection-view (directional_light.rs:39-62).

        direction = -transform.direction(); look_at_rh from the light
        position along it; orthographic_rh with **bottom/top swapped**
        (+h, -h) for the Vulkan Y flip; near 0.1, far 100.

        Memoized on the raw bytes of the translation and rotation and on
        the extents: the per-frame host loop calls this every frame
        (find_shadow_light) and the matrix math is ~0.1ms of numpy for a
        light that almost never moves.
        """
        key = (
            np.asarray(self.transform.translation).tobytes(),
            np.asarray(self.transform.rotation).tobytes(),
            self.shadow_width, self.shadow_height,
        )
        cached = getattr(self, "_pv_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        direction = -self.transform.direction()
        right = np.cross(direction, np.array([0.0, 1.0, 0.0], np.float32))
        right = right / np.linalg.norm(right)
        up = np.cross(right, direction)
        up = up / np.linalg.norm(up)
        eye = self.transform.translation
        view = look_at_rh(eye, eye + direction, up)
        proj = orthographic_rh(
            -self.shadow_width,
            self.shadow_width,
            self.shadow_height,   # bottom = +h (swapped on purpose)
            -self.shadow_height,  # top = -h
            0.1,
            100.0,
        )
        pv = (proj @ view).astype(np.float32)
        self._pv_cache = (key, pv)
        return pv

    def gpu_light(self) -> np.ndarray:
        """Pack into the 20-float GpuLight record exactly as
        shading_pass.rs:653-719: position=translation, direction =
        transform.direction() (NOT the propagation direction — the shader's
        double sign-flip makes L = this vector), attenuation = intensity x4.
        """
        row = np.zeros(20, dtype=np.float32)
        row[0] = LIGHT_DIRECTIONAL  # type_range_spot_id.x
        row[4:7] = self.transform.translation
        row[8:11] = self.color
        row[12:15] = self.transform.direction()
        row[16:20] = self.intensity
        return row


class PointLight:
    """Point light — engine extension backed by the reference's GpuLight
    point branch (pbr.glsl:206-211): attenuation = 1 / (Kc + Kl*d + Kq*d^2).
    """

    def __init__(
        self,
        transform: Transform | None = None,
        color=(1.0, 1.0, 1.0),
        intensity: float = 1.0,
        attenuation=(1.0, 0.09, 0.032),
    ):
        self.transform = transform if transform is not None else Transform()
        self.color = np.asarray(color, dtype=np.float32).reshape(3).copy()
        self.intensity = float(intensity)
        self.attenuation = np.asarray(attenuation, dtype=np.float32).reshape(3).copy()

    def gpu_light(self) -> np.ndarray:
        row = np.zeros(20, dtype=np.float32)
        row[0] = LIGHT_POINT
        row[4:7] = self.transform.translation
        # color scaled by intensity (point branch has no intensity slot;
        # attenuation.xyz holds the Kc/Kl/Kq coefficients).
        row[8:11] = self.color * self.intensity
        row[16:19] = self.attenuation
        return row


class SpotLight:
    """Spot light — engine extension backed by the reference's GpuLight spot
    branch (pbr.glsl:212-217): spot = max(dot(L, dir), 0)^exponent."""

    def __init__(
        self,
        transform: Transform | None = None,
        color=(1.0, 1.0, 1.0),
        intensity: float = 1.0,
        attenuation=(1.0, 0.09, 0.032),
        exponent: float = 8.0,
    ):
        self.transform = transform if transform is not None else Transform()
        self.color = np.asarray(color, dtype=np.float32).reshape(3).copy()
        self.intensity = float(intensity)
        self.attenuation = np.asarray(attenuation, dtype=np.float32).reshape(3).copy()
        self.exponent = float(exponent)

    def gpu_light(self) -> np.ndarray:
        row = np.zeros(20, dtype=np.float32)
        row[0] = LIGHT_SPOT
        row[2] = self.exponent
        row[4:7] = self.transform.translation
        row[8:11] = self.color * self.intensity
        row[12:15] = self.transform.direction()
        row[16:19] = self.attenuation
        return row
