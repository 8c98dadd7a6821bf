"""Vertex stage, the packed per-triangle attribute rows and the raster
megakernel's channel-major columns (port of
``mo_renderer_tpu/passes/vertex_stage.py``).

``run_vertex_stage`` transforms every vertex of the scene at once: world
position, normal, tangent and bitangent, and the camera, previous-camera
and light clip positions.  The default frame needs only the world-space
half (``world_vertex_stage``): it projects the packed per-triangle
corners itself (``triangle_setup_from_attrs``).  The reference sampling
path and the megakernel path run the whole stage.

Rounding follows the reference's CPU evaluation so that rasterized ids
match it exactly: the per-vertex mesh matrix product is XLA's chain of
fused multiply-adds, and the clip products use ``project``'s pairwise
order (see ``kernels/raster_setup.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from ..kernels.raster_setup import project

# Packed per-triangle corner attributes: one (T, 35 + n_mat) row per
# triangle (the reference's layout, vertex_stage.py:102-108).
TRI_WP0 = 0          # 3 x world_pos (9)
TRI_N0 = 9           # 3 x world_normal (9)
TRI_T0 = 18          # 3 x world_tangent (9)
TRI_UV0 = 27         # 3 x uv0 (6)
TRI_MAT = 33         # material id (1)
TRI_HANDED = 34      # 0 = no tangent; +-1 = tangent.w handedness sign
TRI_STRIDE = 35      # geometry columns; materials.fast_used_cols follow

# Channel-major attribute columns the megakernel
# (kernels/rasterizer.rasterize_attrs) reads beside the 16 raster-setup
# columns; the reference appends them to those, the port keeps them in rows
# of their own, padded to RA_ROW floats (16-byte aligned):
#   0..2   per-corner 1/clip_w (perspective correction)
#   3..44  14 interpolated channels x 3 corners (a0, a1, a2 adjacent):
#          wp.xyz, n.xyz, t.xyz, bt.xyz, uv0.uv
#   45     material id (flat per triangle)
#   46     has_tangent (flat)
RA_N_INTERP = 14
RA_EXTRA_COLS = 3 + 3 * RA_N_INTERP + 2  # 47
RA_ROW = 48


@dataclasses.dataclass
class WorldVertices:
    world_pos: torch.Tensor  # (V, 3)
    world_normal: torch.Tensor  # (V, 3)
    world_tangent: torch.Tensor  # (V, 3)
    has_tangent: torch.Tensor  # (V,) bool


@dataclasses.dataclass
class VertexOutputs:
    world_pos: torch.Tensor  # (V, 3)
    clip: torch.Tensor  # (V, 4) camera clip space
    prev_clip: torch.Tensor  # (V, 4) previous-view clip space (velocity)
    shadow_clip: torch.Tensor  # (V, 4) light clip space
    inv_w: torch.Tensor  # (V,) 1/clip.w
    world_normal: torch.Tensor  # (V, 3)
    world_tangent: torch.Tensor  # (V, 3)
    world_bitangent: torch.Tensor  # (V, 3)
    has_tangent: torch.Tensor  # (V,) bool


def _normalize(v, eps=1e-20):
    return v * torch.rsqrt(torch.clamp((v * v).sum(-1, keepdim=True), min=eps))


def _matvec(mats, vecs):
    """einsum("vij,vj->vi") as XLA evaluates it on the CPU: a chain of
    fused multiply-adds over j (each fma computed in float64, where the
    product is exact, and rounded once)."""
    acc = mats[..., 0] * vecs[:, None, 0]
    for j in range(1, vecs.shape[-1]):
        acc = (
            mats[..., j].double() * vecs[:, None, j].double() + acc.double()
        ).float()
    return acc


def _world_transforms(scene):
    """(world position [x, y, z, w] (V, 4), normal matrix (V, 3, 3))."""
    vm = scene.vertex_mesh.to(torch.int64)
    pos1 = torch.cat(
        [scene.position, torch.ones_like(scene.position[:, :1])], dim=-1
    )
    return _matvec(scene.mesh_world[vm], pos1), scene.mesh_normal_mat[vm]


def world_vertex_stage(scene) -> WorldVertices:
    """The world-space half of ``run_vertex_stage``: per-vertex mesh
    matrices applied to positions, normals and tangents."""
    world_pos4, nmat = _world_transforms(scene)
    return WorldVertices(
        world_pos=world_pos4[:, :3],
        world_normal=_normalize(_matvec(nmat, scene.normal)),
        world_tangent=_normalize(_matvec(nmat, scene.tangent[:, :3])),
        has_tangent=(scene.tangent[:, :3] != 0.0).any(-1),
    )


def run_vertex_stage(scene, proj_view, prev_proj_view,
                     light_proj_view) -> VertexOutputs:
    """Every vertex through its mesh matrix and the three view matrices
    (vertex_stage.py:45); matrices are (4, 4) m[row, col]."""
    world_pos4, nmat = _world_transforms(scene)
    clip = project(world_pos4, proj_view)
    w = clip[:, 3]
    # TBN (gbuffer.vert:37-44): bitangent = cross(n, t.xyz) * t.w in model
    # space, each normalized after the normal-matrix transform
    t_model = scene.tangent[:, :3]
    bit_model = torch.cross(scene.normal, t_model, dim=-1) * (
        scene.tangent[:, 3:4]
    )
    return VertexOutputs(
        world_pos=world_pos4[:, :3],
        clip=clip,
        prev_clip=project(world_pos4, prev_proj_view),
        shadow_clip=project(world_pos4, light_proj_view),
        inv_w=1.0 / torch.where(w.abs() > 1e-20, w, 1.0),
        world_normal=_normalize(_matvec(nmat, scene.normal)),
        world_tangent=_normalize(_matvec(nmat, t_model)),
        world_bitangent=_normalize(_matvec(nmat, bit_model)),
        has_tangent=(t_model != 0.0).any(-1),
    )


def pack_raster_attr_rows(tri_attrs, proj_view) -> torch.Tensor:
    """(T, 35+) tri_attrs + proj_view -> the (T, 48) rows the megakernel
    reads 16 bytes at a time: the reference's 47 extra raster columns
    (``pack_raster_attr_columns``, vertex_stage.py:132) and one of zeros.
    The columns are the per-corner 1/w, then the corner-major rows
    reordered into channel-major triplets, with corner bitangents
    synthesized as cross(N, T) * handed."""
    cols = _raster_attr_columns(tri_attrs, proj_view)
    cols += [torch.zeros_like(cols[0])] * (RA_ROW - RA_EXTRA_COLS)
    return torch.stack(cols, dim=-1)


def _raster_attr_columns(tri_attrs, proj_view) -> list:
    pv3 = proj_view[3]

    def corner_iw(k):
        wp = tri_attrs[:, TRI_WP0 + 3 * k : TRI_WP0 + 3 * (k + 1)]
        w = wp[:, 0] * pv3[0] + wp[:, 1] * pv3[1] + wp[:, 2] * pv3[2] + pv3[3]
        return 1.0 / torch.where(w.abs() > 1e-20, w, 1.0)

    handed = tri_attrs[:, TRI_HANDED]
    corner_bt = [
        torch.cross(
            tri_attrs[:, TRI_N0 + 3 * k : TRI_N0 + 3 * (k + 1)],
            tri_attrs[:, TRI_T0 + 3 * k : TRI_T0 + 3 * (k + 1)],
            dim=-1,
        ) * handed[:, None]
        for k in range(3)
    ]
    cols = [corner_iw(k) for k in range(3)]
    for base in (TRI_WP0, TRI_N0, TRI_T0):
        for j in range(3):
            cols += [tri_attrs[:, base + 3 * k + j] for k in range(3)]
    for j in range(3):
        cols += [corner_bt[k][:, j] for k in range(3)]
    for j in range(2):
        cols += [tri_attrs[:, TRI_UV0 + 2 * k + j] for k in range(3)]
    cols += [tri_attrs[:, TRI_MAT], handed.abs()]
    return cols


def pack_triangle_attributes(scene, vs, used_cols: tuple = ()) -> torch.Tensor:
    """(T, 35 + len(used_cols)) f32 corner-attribute rows; ``vs`` is a
    WorldVertices or VertexOutputs; ``used_cols``
    (materials.fast_used_cols) appends that material-table column subset
    per triangle."""
    idx = scene.indices.to(torch.int64)
    i0, i1, i2 = idx[:, 0], idx[:, 1], idx[:, 2]

    def corners(attr):  # (V, C) -> (T, 3*C)
        return torch.cat([attr[i0], attr[i1], attr[i2]], dim=-1)

    mat_idx = scene.mesh_material[scene.tri_mesh.to(torch.int64)].to(
        torch.int64
    )
    has_t = vs.has_tangent[i0].to(torch.float32)
    tw = scene.tangent[:, 3][i0]
    handed = has_t * torch.where(tw < 0.0, -1.0, 1.0)
    parts = [
        corners(vs.world_pos),
        corners(vs.world_normal),
        corners(vs.world_tangent),
        corners(scene.uv0),
        mat_idx.to(torch.float32)[:, None],
        handed[:, None],
    ]
    if used_cols:
        sel = scene.materials[:, list(used_cols)]
        parts.append(sel[mat_idx])
    return torch.cat(parts, dim=-1)
