"""Model / Mesh / MeshPrimitive — numpy-backed scene geometry.

Mirrors mo_ecs/src/model/{mod.rs, primitives.rs}: ``Model.load_gltf`` walks
the node hierarchy accumulating parent transforms (mod.rs:96-108), reads
indices/positions/normals/uv0/uv1/tangents/colors with the same defaults
(mod.rs:116-141), and extracts the PBR metallic-roughness material per
primitive (mod.rs:159-266).  Vertices are stored struct-of-arrays (the
TPU-native layout) instead of interleaved ``StaticVertex``.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from .gltf import GltfDocument
from .materials import DEFAULT_TEXTURE_MAP, AlphaMode, GltfMaterialCPU, MaterialType


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
    """A loaded glTF model: meshes + decoded textures (mod.rs:14-18)."""

    def __init__(self, meshes=None, textures=None):
        self.meshes: list[Mesh] = meshes or []
        self.textures: list[np.ndarray] = textures or []  # (H, W, 4) uint8

    @staticmethod
    def load_gltf(path: str, resource_root: str | None = None) -> "Model":
        """Load ``resources/gltf/<path>`` (mod.rs:21-27 path resolution)."""
        from ..config import DEFAULT_CONFIG

        root = resource_root or DEFAULT_CONFIG.resource_root
        full = path if os.path.isabs(path) else os.path.join(root, "gltf", path)
        if not os.path.exists(full):
            raise FileNotFoundError(f"Loading model {path} failed: {full} not found")
        doc = GltfDocument.load(full)
        model = Model()

        # Decode all images up front (mod.rs:35-78).
        for i in range(len(doc.json.get("images", []))):
            model.textures.append(doc.image_rgba8(i))

        scenes = doc.json.get("scenes", [])
        nodes = doc.json.get("nodes", [])
        for scene in scenes:
            for node_idx in scene.get("nodes", []):
                _load_node(
                    doc, nodes[node_idx], nodes, model, np.eye(4, dtype=np.float32)
                )
        return model


def _load_node(doc, node, nodes, model, parent_transform):
    node_transform = parent_transform @ doc.node_matrix(node)

    for child_idx in node.get("children", []):
        _load_node(doc, nodes[child_idx], nodes, model, node_transform)

    if "mesh" not in node:
        return
    mesh_json = doc.json["meshes"][node["mesh"]]
    for prim in mesh_json.get("primitives", []):
        if prim.get("mode", 4) != 4:  # triangles only
            continue
        attrs = prim["attributes"]
        positions = doc.accessor_f32(attrs["POSITION"])
        n = positions.shape[0]
        if "indices" in prim:
            indices = doc.accessor(prim["indices"]).astype(np.uint32)
        else:
            indices = np.arange(n, dtype=np.uint32)
        normals = (
            doc.accessor_f32(attrs["NORMAL"])
            if "NORMAL" in attrs
            else _flat_normals(positions, indices)
        )
        uv0 = (
            doc.accessor_f32(attrs["TEXCOORD_0"])
            if "TEXCOORD_0" in attrs
            else np.zeros((n, 2), np.float32)
        )
        uv1 = (
            doc.accessor_f32(attrs["TEXCOORD_1"])
            if "TEXCOORD_1" in attrs
            else np.zeros((n, 2), np.float32)
        )
        tangents = (
            doc.accessor_f32(attrs["TANGENT"])
            if "TANGENT" in attrs
            else np.zeros((n, 4), np.float32)  # all-zero = no normal mapping
        )
        colors = (
            _as_rgba(doc.accessor_f32(attrs["COLOR_0"]))
            if "COLOR_0" in attrs
            else np.ones((n, 4), np.float32)
        )

        primitive = MeshPrimitive(
            indices=indices,
            position=_pad4(positions, 0.0),
            normal=_pad4(normals, 0.0),
            color=colors,
            uv0=uv0,
            uv1=uv1,
            tangent=tangents,
        )

        material = _extract_material(doc, prim.get("material"))
        model.meshes.append(
            Mesh(primitive=primitive, material=material, world=node_transform.copy())
        )


def _pad4(a: np.ndarray, w: float) -> np.ndarray:
    if a.shape[1] == 4:
        return a.astype(np.float32)
    out = np.full((a.shape[0], 4), w, dtype=np.float32)
    out[:, : a.shape[1]] = a
    return out


def _as_rgba(a: np.ndarray) -> np.ndarray:
    return _pad4(a, 1.0)


def _flat_normals(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    tri = indices.reshape(-1, 3)
    p = positions[:, :3]
    fn = np.cross(p[tri[:, 1]] - p[tri[:, 0]], p[tri[:, 2]] - p[tri[:, 0]])
    normals = np.zeros_like(p)
    for k in range(3):
        np.add.at(normals, tri[:, k], fn)
    norm = np.linalg.norm(normals, axis=1, keepdims=True)
    return normals / np.maximum(norm, 1e-20)


def _tex_image_or_default(doc, tex_info) -> tuple[int, int]:
    """(image_index_or_DEFAULT, uv_set) from a textureInfo dict."""
    if not tex_info:
        return DEFAULT_TEXTURE_MAP, 0
    src = doc.texture_image_index(tex_info.get("index"))
    uv = tex_info.get("texCoord", 0)
    return (src if src is not None else DEFAULT_TEXTURE_MAP), uv


def _extract_material(doc, mat_idx) -> GltfMaterialCPU:
    if mat_idx is None:
        return GltfMaterialCPU(material_type=MaterialType.METALLIC_ROUGHNESS)
    mat = doc.json["materials"][mat_idx]
    pbr = mat.get("pbrMetallicRoughness", {})

    base_idx, base_uv = _tex_image_or_default(doc, pbr.get("baseColorTexture"))
    mr_idx, mr_uv = _tex_image_or_default(doc, pbr.get("metallicRoughnessTexture"))
    normal_idx, normal_uv = _tex_image_or_default(doc, mat.get("normalTexture"))
    occ_idx, occ_uv = _tex_image_or_default(doc, mat.get("occlusionTexture"))
    emis_idx, emis_uv = _tex_image_or_default(doc, mat.get("emissiveTexture"))

    base_color_factor = np.array(
        pbr.get("baseColorFactor", [1, 1, 1, 1]), dtype=np.float32
    )
    metallic_factor = float(pbr.get("metallicFactor", 1.0))
    roughness_factor = float(pbr.get("roughnessFactor", 1.0))
    emissive_factor = np.array(mat.get("emissiveFactor", [0, 0, 0]), dtype=np.float32)

    alpha_cutoff = 0.0
    mode = mat.get("alphaMode", "OPAQUE")
    if mode == "MASK":
        alpha_mode = AlphaMode.MASK
        alpha_cutoff = float(mat.get("alphaCutoff", 0.5))
    elif mode == "BLEND":
        alpha_mode = AlphaMode.BLEND
    else:
        alpha_mode = AlphaMode.OPAQUE

    return GltfMaterialCPU(
        base_color_texture=base_idx,
        normal_texture=normal_idx,
        surface_properties_texture=mr_idx,
        occlusion_texture=occ_idx,
        emissive_texture=emis_idx,
        base_color_uv=base_uv,
        normal_uv=normal_uv,
        surface_properties_uv=mr_uv,
        occlusion_uv=occ_uv,
        emissive_uv=emis_uv,
        base_color_factor=base_color_factor,
        ormn=np.array([1.0, roughness_factor, metallic_factor, 1.0], np.float32),
        emissive_factor_alpha_cutoff=np.array(
            [*emissive_factor, alpha_cutoff], np.float32
        ),
        alpha_mode=alpha_mode,
        material_type=MaterialType.METALLIC_ROUGHNESS,
    )
