"""Material model mirroring mo_ecs/src/model/material.rs.

``GltfMaterialCPU`` carries the full glTF PBR superset the reference declares
(material.rs:27-190); only the metallic-roughness core is consumed by the
G-buffer stage, exactly as in the reference (gbuffer_pass.rs:720-750).
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

# Sentinel for "no texture bound" (model/mod.rs:12).
DEFAULT_TEXTURE_MAP = 0xFFFFFFFF


class MaterialType(enum.IntFlag):
    """Bitmask material type (material.rs:3-15)."""

    NONE = 0
    UNLIT = 1 << 0
    METALLIC_ROUGHNESS = 1 << 1
    SPECULAR_GLOSSINESS = 1 << 2
    SHEEN = 1 << 3
    CLEARCOAT = 1 << 4
    SPECULAR = 1 << 5
    TRANSPARENT = 1 << 6
    VOLUME = 1 << 7


class AlphaMode(enum.IntEnum):
    """material.rs:17-23."""

    OPAQUE = 0
    MASK = 1
    BLEND = 2


def _vec4(x, y, z, w):
    return np.array([x, y, z, w], dtype=np.float32)


@dataclasses.dataclass
class GltfMaterialCPU:
    """CPU-side material record (material.rs:27-190 defaults)."""

    # Texture indices into Model.textures (DEFAULT_TEXTURE_MAP = unbound)
    base_color_texture: int = DEFAULT_TEXTURE_MAP
    normal_texture: int = DEFAULT_TEXTURE_MAP
    surface_properties_texture: int = DEFAULT_TEXTURE_MAP  # metallic-roughness
    occlusion_texture: int = DEFAULT_TEXTURE_MAP
    emissive_texture: int = DEFAULT_TEXTURE_MAP
    # UV set selectors (0 or 1)
    base_color_uv: int = 0
    normal_uv: int = 0
    surface_properties_uv: int = 0
    occlusion_uv: int = 0
    emissive_uv: int = 0
    # Factors
    base_color_factor: np.ndarray = dataclasses.field(
        default_factory=lambda: _vec4(1, 1, 1, 1)
    )
    # ormn = (occlusion_strength, roughness_factor, metallic_factor, normal_scale)
    ormn: np.ndarray = dataclasses.field(default_factory=lambda: _vec4(1, 1, 1, 1))
    emissive_factor_alpha_cutoff: np.ndarray = dataclasses.field(
        default_factory=lambda: _vec4(0, 0, 0, 0.5)
    )
    alpha_mode: AlphaMode = AlphaMode.OPAQUE
    material_type: MaterialType = MaterialType.METALLIC_ROUGHNESS

    # Extended glTF PBR slots declared by the reference but unused downstream
    # (material.rs:27-107); kept for API parity.
    specular_glossiness_texture: int = DEFAULT_TEXTURE_MAP
    sheen_texture: int = DEFAULT_TEXTURE_MAP
    clearcoat_texture: int = DEFAULT_TEXTURE_MAP
    transmission_texture: int = DEFAULT_TEXTURE_MAP
    iridescence_texture: int = DEFAULT_TEXTURE_MAP
    anisotropy_texture: int = DEFAULT_TEXTURE_MAP
    specular_glossiness_factor: np.ndarray = dataclasses.field(
        default_factory=lambda: _vec4(1, 1, 1, 1)
    )
    sheen_factor: np.ndarray = dataclasses.field(
        default_factory=lambda: _vec4(0, 0, 0, 0)
    )
    clearcoat_factor: np.ndarray = dataclasses.field(
        default_factory=lambda: _vec4(0, 0, 0, 0)
    )
    transmission_ior: np.ndarray = dataclasses.field(
        default_factory=lambda: _vec4(0, 1.5, 0, 0)
    )
    iridescence_factor: np.ndarray = dataclasses.field(
        default_factory=lambda: _vec4(0, 1.3, 100.0, 400.0)
    )
    anisotropy_factor: np.ndarray = dataclasses.field(
        default_factory=lambda: _vec4(0, 0, 0, 0)
    )


# GPU material table layout: one fixed-width float32 row per material so the
# whole table is a single (max_materials, MATERIAL_STRIDE) device array — the
# TPU-native analogue of the bindless materials SSBO (bindless.glsl:4-29).
MAT_BASE_COLOR_MAP = 0
MAT_NORMAL_MAP = 1
MAT_MR_MAP = 2
MAT_OCCLUSION_MAP = 3
MAT_EMISSIVE_MAP = 4
MAT_BASE_COLOR_UV = 5
MAT_NORMAL_UV = 6
MAT_MR_UV = 7
MAT_OCCLUSION_UV = 8
MAT_EMISSIVE_UV = 9
MAT_BASE_COLOR_FACTOR = 10  # ..14
MAT_EMISSIVE_FACTOR = 14  # ..18
MAT_METALLIC_FACTOR = 18
MAT_ROUGHNESS_FACTOR = 19
MAT_ALPHA_MODE = 20
MAT_ALPHA_CUTOFF = 21
# This material's quad-packed texture stack entry: starting row offset
# and side length (scene packing dedupes materials that share all five
# texture layers; entries keep their NATIVE pow2 resolution — the
# reference binds textures at native size via the bindless array,
# mo_vk/src/texture.rs:74-102, gbuffer_pass.rs:756-768)
MAT_STACK_BASE = 22
MAT_STACK_SIZE = 23
# Per-slot constant RGBA (cols 24..43): when a slot's texture layer is a
# uniform color for EVERY material in the scene, scene packing marks the
# slot constant and the G-buffer pass reads this value instead of
# gathering from the texture stack (slot order: base, normal, mr,
# occlusion, emissive).
MAT_CONST_BASE = 24  # + 4 * slot
MATERIAL_STRIDE = 48  # padded


def fast_used_cols(slot_map) -> tuple:
    """Static column set the fast G-buffer path reads from the material
    table, in fetch order.  Scene packing appends these per-triangle
    (already resolved through the mesh->material indirection) to the
    tri_attrs rows: the per-pixel one-hot material matmul disappears —
    the attrs row gather is index-count-bound, so the extra columns are
    nearly free, while the (H*W, n_mats) einsum costs ~1ms/frame at
    100+ materials."""
    used = [MAT_STACK_BASE, MAT_STACK_SIZE]
    used += list(range(MAT_BASE_COLOR_FACTOR, MAT_BASE_COLOR_FACTOR + 4))
    used += list(range(MAT_EMISSIVE_FACTOR, MAT_EMISSIVE_FACTOR + 3))
    used += [MAT_METALLIC_FACTOR, MAT_ROUGHNESS_FACTOR]
    for k, p in enumerate(slot_map):
        if p < 0:  # constant slot: per-material color lives in the table
            used += list(range(MAT_CONST_BASE + 4 * k,
                               MAT_CONST_BASE + 4 * k + 4))
    return tuple(used)


def pack_material_gpu(
    mat: GltfMaterialCPU,
    base_color_idx: int,
    normal_idx: int,
    mr_idx: int,
    occlusion_idx: int,
    emissive_idx: int,
) -> np.ndarray:
    """Pack one material into its GPU table row.

    Mirrors gbuffer_pass.rs add_model (:720-750): texture indices already
    resolved against the bindless array (here: the texture-array layer ids).
    """
    row = np.zeros(MATERIAL_STRIDE, dtype=np.float32)
    row[MAT_BASE_COLOR_MAP] = base_color_idx
    row[MAT_NORMAL_MAP] = normal_idx
    row[MAT_MR_MAP] = mr_idx
    row[MAT_OCCLUSION_MAP] = occlusion_idx
    row[MAT_EMISSIVE_MAP] = emissive_idx
    row[MAT_BASE_COLOR_UV] = mat.base_color_uv
    row[MAT_NORMAL_UV] = mat.normal_uv
    row[MAT_MR_UV] = mat.surface_properties_uv
    row[MAT_OCCLUSION_UV] = mat.occlusion_uv
    row[MAT_EMISSIVE_UV] = mat.emissive_uv
    row[MAT_BASE_COLOR_FACTOR : MAT_BASE_COLOR_FACTOR + 4] = mat.base_color_factor
    # emissive_factor packed with w=1.0 (gbuffer_pass.rs:735-741)
    row[MAT_EMISSIVE_FACTOR : MAT_EMISSIVE_FACTOR + 3] = mat.emissive_factor_alpha_cutoff[:3]
    row[MAT_EMISSIVE_FACTOR + 3] = 1.0
    row[MAT_METALLIC_FACTOR] = mat.ormn[2]
    row[MAT_ROUGHNESS_FACTOR] = mat.ormn[1]
    row[MAT_ALPHA_MODE] = float(int(mat.alpha_mode))
    row[MAT_ALPHA_CUTOFF] = mat.emissive_factor_alpha_cutoff[3]
    return row
