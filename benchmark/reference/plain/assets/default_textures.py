"""DefaultTextures: the port's built-in fallback textures (white,
flat normal, default metallic-roughness, checker, black), without the
resource files the port would load in their place where they exist."""

from __future__ import annotations

import numpy as np


def _flat(size: int, rgba) -> np.ndarray:
    return np.tile(np.array(rgba, dtype=np.uint8), (size, size, 1))


class DefaultTextures:
    def __init__(self, resource_root: str | None = None):
        self.white = _flat(4, [255, 255, 255, 255])
        self.flat_normal = _flat(4, [128, 128, 255, 255])
        self.metallic_roughness = _flat(4, [255, 255, 0, 255])
        self.checker = _flat(4, [200, 200, 200, 255])
        self.black = _flat(4, [0, 0, 0, 255])
        self.occlusion = self.white
