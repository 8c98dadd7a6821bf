"""Model / Mesh / MeshPrimitive: numpy-backed scene geometry (the
port's assets/model.py without its glTF loader)."""

from __future__ import annotations

import dataclasses

import numpy as np

from .materials import GltfMaterialCPU


@dataclasses.dataclass
class MeshPrimitive:
    """Vertex/index arrays for one primitive (primitives.rs:38-92).

    position/normal are stored as (N, 4) with w=0 to mirror StaticVertex
    (primitives.rs:10-23); uv as (N, 2); tangent/color as (N, 4).
    """

    indices: np.ndarray  # (T*3,) uint32
    position: np.ndarray  # (N, 4) f32, w=0
    normal: np.ndarray  # (N, 4) f32, w=0
    color: np.ndarray  # (N, 4) f32
    uv0: np.ndarray  # (N, 2) f32
    uv1: np.ndarray  # (N, 2) f32
    tangent: np.ndarray  # (N, 4) f32 (w = handedness; all-zero = none)

    @property
    def num_vertices(self) -> int:
        return self.position.shape[0]

    @property
    def num_triangles(self) -> int:
        return self.indices.shape[0] // 3


@dataclasses.dataclass
class Mesh:
    """primitive + material + baked node world matrix (primitives.rs:45-50)."""

    primitive: MeshPrimitive
    material: GltfMaterialCPU
    gpu_mat_index: int = 0
    world: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float32)
    )


class Model:
    """Meshes and decoded (H, W, 4) uint8 textures."""

    def __init__(self, meshes=None, textures=None):
        self.meshes: list[Mesh] = meshes or []
        self.textures: list[np.ndarray] = textures or []
