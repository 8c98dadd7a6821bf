"""Procedural geometry — asset-free models for tests, benchmarks, demos.

The reference ships only .glb files (resources/gltf); these generators
produce the same ``Model``/``Mesh``/``MeshPrimitive`` records
(assets/model.py) from pure math so the engine can run without any asset
tree (driver compile checks, synthetic Sponza-scale scenes).
"""

from __future__ import annotations

import numpy as np

from .materials import GltfMaterialCPU
from .model import Mesh, MeshPrimitive, Model


def _primitive(position3, normal3, uv0, indices) -> MeshPrimitive:
    n = position3.shape[0]
    pad = lambda a: np.concatenate(
        [a.astype(np.float32), np.zeros((n, 1), np.float32)], axis=1
    )
    return MeshPrimitive(
        indices=np.asarray(indices, np.uint32).reshape(-1),
        position=pad(position3),
        normal=pad(normal3),
        color=np.ones((n, 4), np.float32),
        uv0=np.asarray(uv0, np.float32),
        uv1=np.asarray(uv0, np.float32).copy(),
        tangent=np.zeros((n, 4), np.float32),
    )


def cube_primitive(size: float = 1.0) -> MeshPrimitive:
    """Axis-aligned cube, 24 verts / 12 tris, per-face normals + UVs."""
    h = size / 2.0
    faces = [
        # (normal, u-axis, v-axis)
        ((0, 0, 1), (1, 0, 0), (0, 1, 0)),
        ((0, 0, -1), (-1, 0, 0), (0, 1, 0)),
        ((1, 0, 0), (0, 0, -1), (0, 1, 0)),
        ((-1, 0, 0), (0, 0, 1), (0, 1, 0)),
        ((0, 1, 0), (1, 0, 0), (0, 0, -1)),
        ((0, -1, 0), (1, 0, 0), (0, 0, 1)),
    ]
    pos, nrm, uv, idx = [], [], [], []
    for f, (n, u, v) in enumerate(faces):
        n, u, v = map(np.asarray, (n, u, v))
        for su, sv in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
            pos.append(h * (n + su * u + sv * v))
            nrm.append(n)
            uv.append(((su + 1) / 2, (sv + 1) / 2))
        b = 4 * f
        idx += [b, b + 1, b + 2, b, b + 2, b + 3]
    return _primitive(np.array(pos), np.array(nrm, np.float32),
                      np.array(uv), idx)


def plane_primitive(size: float = 10.0) -> MeshPrimitive:
    """XZ ground plane facing +Y."""
    h = size / 2.0
    pos = np.array(
        [[-h, 0, -h], [h, 0, -h], [h, 0, h], [-h, 0, h]], np.float32
    )
    nrm = np.tile(np.array([0, 1, 0], np.float32), (4, 1))
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    return _primitive(pos, nrm, uv, [0, 2, 1, 0, 3, 2])


def uv_sphere_primitive(radius: float = 0.5, rings: int = 16,
                        sectors: int = 32) -> MeshPrimitive:
    """Latitude/longitude sphere with smooth normals."""
    phi = np.linspace(0.0, np.pi, rings + 1)
    theta = np.linspace(0.0, 2.0 * np.pi, sectors + 1)
    pp, tt = np.meshgrid(phi, theta, indexing="ij")
    x = np.sin(pp) * np.cos(tt)
    y = np.cos(pp)
    z = np.sin(pp) * np.sin(tt)
    nrm = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    pos = radius * nrm
    uv = np.stack(
        [tt / (2.0 * np.pi), pp / np.pi], axis=-1
    ).reshape(-1, 2)
    idx = []
    for r in range(rings):
        for s in range(sectors):
            a = r * (sectors + 1) + s
            b = a + sectors + 1
            idx += [a, a + 1, b, b, a + 1, b + 1]
    return _primitive(pos.astype(np.float32), nrm.astype(np.float32),
                      uv.astype(np.float32), idx)


def _checker_texture(size: int = 64, cells: int = 8,
                     c0=(220, 220, 220, 255), c1=(60, 60, 60, 255)):
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    mask = ((yy * cells // size + xx * cells // size) % 2).astype(bool)
    img = np.where(mask[..., None], np.array(c1, np.uint8),
                   np.array(c0, np.uint8))
    return img.astype(np.uint8)


def _mr_gradient_texture(size: int = 64):
    """Metallic-roughness map with roughness (G) ramping 0->1 across u —
    drives the full specular mip chain across one surface (stress case
    for the half-res specular taps)."""
    img = np.zeros((size, size, 4), np.uint8)
    img[..., 1] = (np.arange(size) * 255 // (size - 1))[None, :]
    img[..., 0] = 255  # occlusion
    img[..., 3] = 255
    return img


def procedural_model(kind: str = "cube", *, base_color=(1.0, 1.0, 1.0, 1.0),
                     metallic: float = 0.0, roughness: float = 0.5,
                     textured: bool = False, mr_gradient: bool = False,
                     **kw) -> Model:
    """One-mesh Model with a metallic-roughness material."""
    prim = {
        "cube": cube_primitive,
        "plane": plane_primitive,
        "sphere": uv_sphere_primitive,
    }[kind](**kw)
    mat = GltfMaterialCPU(
        base_color_factor=np.asarray(base_color, np.float32),
    )
    mat.ormn = np.array([1.0, roughness, metallic, 1.0], np.float32)
    textures = []
    if textured:
        mat.base_color_texture = len(textures)
        textures.append(_checker_texture())
    if mr_gradient:
        mat.surface_properties_texture = len(textures)
        textures.append(_mr_gradient_texture())
    return Model(meshes=[Mesh(primitive=prim, material=mat)],
                 textures=textures)


def synthetic_sky(h: int = 16, w: int = 32) -> np.ndarray:
    """Blue-to-warm gradient equirect panorama, (h, w, 3) float32: the
    asset-free stand-in for ``resources/tex/env/default_sky.hdr``."""
    y = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None, None]
    top = np.array([0.3, 0.5, 1.2], np.float32)
    bottom = np.array([1.0, 0.8, 0.6], np.float32)
    sky = top * (1.0 - y) + bottom * y
    return np.broadcast_to(sky, (h, w, 3)).copy()
