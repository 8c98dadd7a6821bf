"""DefaultTextures resource (mo_ecs/src/resource/default_tex.rs:16-40).

Loads the 6 fallback textures from ``resources/tex/``; if an asset file is
missing, synthesizes the canonical constant-color fallback so the engine
works without the asset tree.
"""

from __future__ import annotations

import os

import numpy as np

from . import image_io


def _flat(size: int, rgba) -> np.ndarray:
    return np.tile(np.array(rgba, dtype=np.uint8), (size, size, 1))


class DefaultTextures:
    """white (diffuse+occlusion), flat normal, default MR, checker, black."""

    def __init__(self, resource_root: str | None = None):
        from ..config import DEFAULT_CONFIG

        root = resource_root or DEFAULT_CONFIG.resource_root
        tex = os.path.join(root, "tex")

        def load(name: str, fallback_rgba) -> np.ndarray:
            p = os.path.join(tex, name)
            if os.path.exists(p):
                return image_io.load_ldr(p)
            return _flat(4, fallback_rgba)

        self.white = load("white_texture.png", [255, 255, 255, 255])
        self.flat_normal = load("flat_normal_map.png", [128, 128, 255, 255])
        self.metallic_roughness = load(
            "default_metallic_roughness.png", [255, 255, 0, 255]
        )
        self.checker = load("checker.jpg", [200, 200, 200, 255])
        self.black = load("default_black.png", [0, 0, 0, 255])
        # Occlusion default shares the white texture (default_tex.rs:19-27).
        self.occlusion = self.white
