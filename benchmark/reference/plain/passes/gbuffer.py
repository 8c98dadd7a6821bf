"""G-buffer pass (port of ``mo_renderer_tpu/passes/gbuffer.py``): the
reference sampling path's ``gbuffer_pass``, the fast path's
``gbuffer_pass_fast`` with ``_texture_and_assemble``, and the megakernel's
``gbuffer_pass_from_planes``.

- ``gbuffer_pass`` interpolates the per-vertex stage outputs with the
  rasterizer's screen-space barycentrics (perspective-corrected by 1/w)
  and samples every material slot from the texture array with the slot's
  own UV set (0 or 1).
- ``gbuffer_pass_fast``: the visibility buffer's triangle ids go through
  the ``attr_planes`` kernel (row gather + perspective-correct
  interpolation) or, with ``attrs_plane_kernel`` off, through the same
  math as torch ops (the reference's non-kernel branch, which takes the
  bitangent as cross(n, t) * handedness); then ``gbuffer_tail``: the
  velocity, the material columns that ride the attribute rows driving the
  texture-stack sampling of the sampled slots (the sampled channels from
  the ``stack_planes`` kernel with ``stack_plane_kernel`` on), factor
  application, TBN normal mapping and assembly.
- ``gbuffer_pass_from_planes`` takes the planes the raster megakernel
  already interpolated and runs the same tail, the material row fetched
  by the material-id plane (the reference passes it no stack kernel).

On a card the tail is one hand kernel, K10 (``csrc/gbuffer.cu``), for
every input source; its plain version, ``_gbuffer_tail_plain`` with
``_texture_and_assemble``, is what the CPU runs.  The reference sampling
path's ``gbuffer_pass`` is one hand kernel on a card too, K12
(``csrc/gbuffer_ref.cu``); its plain version, ``_gbuffer_ref_plain``, is
what the CPU runs.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..assets import materials as M
from ..device import sampling
from ..kernels.attr_planes import attr_planes, pixel_ndc
from ..kernels.stack_planes import out_spec, stack_planes
from ..kernels.tonemap import srgb_to_linear
from .vertex_stage import (
    TRI_HANDED,
    TRI_N0,
    TRI_STRIDE,
    TRI_T0,
    TRI_UV0,
    TRI_WP0,
)


@dataclasses.dataclass
class GBuffer:
    base_color: torch.Tensor  # (H, W, 3) linear
    position: torch.Tensor  # (H, W, 3) world space
    normal: torch.Tensor  # (H, W, 3)
    emissive: torch.Tensor  # (H, W, 3)
    orm: torch.Tensor  # (H, W, 3) occlusion, roughness, metallic
    velocity: torch.Tensor  # (H, W, 2)
    depth: torch.Tensor  # (H, W)
    mask: torch.Tensor  # (H, W) bool: covered pixels


@dataclasses.dataclass
class TailInputs:
    """What the fast path's G-buffer tail reads per pixel, as the caller
    has it: ``world_pos``, ``n_in``, ``t_in``, ``bt_in`` (3 channels) and
    ``uv0`` (2), each an (H, W, k) tensor or a tuple of k (H, W) planes;
    ``handed``, the (H, W) handedness (has_tangent is |handed| > 0.5), or
    with ``handed_abs`` off the megakernel's has-tangent plane (> 0.5);
    the material columns as ``mat_cols`` (H, W, n) in
    ``materials.fast_used_cols`` order, or as the megakernel's
    ``mat_plane`` of material ids, whose rows the tail fetches from
    ``scene.materials``."""

    world_pos: object
    n_in: object
    t_in: object
    bt_in: object
    uv0: object
    handed: torch.Tensor
    handed_abs: bool = True
    mat_cols: torch.Tensor | None = None
    mat_plane: torch.Tensor | None = None


def _vec(x):
    """An (H, W, k) tensor of a TailInputs field."""
    return torch.stack(x, dim=-1) if isinstance(x, tuple) else x


def _normalize(v, eps=1e-20):
    return v * torch.rsqrt(torch.clamp((v * v).sum(-1, keepdim=True), min=eps))


def _ndc01(c):
    """Clip -> [0,1]^2 NDC with the Vulkan y flip (gbuffer.frag:71-79)."""
    wc = torch.where(c[..., 3].abs() > 1e-20, c[..., 3], 1.0)
    a = (c[..., :2] / wc[..., None] + 1.0) * 0.5
    return torch.stack([a[..., 0], 1.0 - a[..., 1]], dim=-1)


def _interp(attr, i0, i1, i2, bb0, bb1, bb2):
    """Perspective-correct interpolation of a (V, C) attribute."""
    return (
        attr[i0] * bb0[..., None] + attr[i1] * bb1[..., None]
        + attr[i2] * bb2[..., None]
    )


def gbuffer_pass(tri, z, b0, b1, scene, vs) -> GBuffer:
    """tri/z/b0/b1: the full-mode visibility buffer (H, W); vs: the
    per-vertex stage's VertexOutputs (gbuffer.py:71).

    On a CUDA ``tri`` this is the kernel of ``csrc/gbuffer_ref.cu`` (K12),
    one launch; on the CPU it is the PyTorch ops of
    ``_gbuffer_ref_plain``, the kernel's plain version."""
    return _gbuffer_ref_plain(tri, z, b0, b1, scene, vs)


def _gbuffer_ref_plain(tri, z, b0, b1, scene, vs) -> GBuffer:
    """gbuffer_pass in PyTorch ops: the CPU's path, and the plain version
    the kernel is held to on the card."""
    covered = tri >= 0
    t = torch.clamp(tri, min=0).to(torch.int64)
    idx = scene.indices.to(torch.int64)[t]  # (H, W, 3)
    i0, i1, i2 = idx[..., 0], idx[..., 1], idx[..., 2]

    # perspective correction: q_i = b_i / w_i; B_i = q_i / sum(q)
    b2 = 1.0 - b0 - b1
    q0 = b0 * vs.inv_w[i0]
    q1 = b1 * vs.inv_w[i1]
    q2 = b2 * vs.inv_w[i2]
    qs = q0 + q1 + q2
    qs = torch.where(qs.abs() > 1e-20, qs, 1.0)
    bb = (q0 / qs, q1 / qs, q2 / qs)

    def interp(attr):
        return _interp(attr, i0, i1, i2, *bb)

    world_pos = interp(vs.world_pos)
    uv0 = interp(scene.uv0)
    uv1 = interp(scene.uv1)
    n_in = interp(vs.world_normal)
    t_in = interp(vs.world_tangent)
    bt_in = interp(vs.world_bitangent)
    clip = interp(vs.clip)
    prev_clip = interp(vs.prev_clip)
    has_tangent = vs.has_tangent[i0]  # uniform per mesh

    mesh_id = scene.tri_mesh.to(torch.int64)[t]
    mat_id = scene.mesh_material.to(torch.int64)[mesh_id]
    mat = scene.materials[mat_id]  # (H, W, MATERIAL_STRIDE)

    def sample_slot(map_col, uv_col):
        uv = torch.where((mat[..., uv_col] == 0.0)[..., None], uv0, uv1)
        return sampling.sample_array_bilinear(
            scene.textures, mat[..., map_col].to(torch.int32), uv,
            sampling.REPEAT,
        )

    base_rgba = sample_slot(M.MAT_BASE_COLOR_MAP, M.MAT_BASE_COLOR_UV)
    normal_map = sample_slot(M.MAT_NORMAL_MAP, M.MAT_NORMAL_UV)
    mr = sample_slot(M.MAT_MR_MAP, M.MAT_MR_UV)
    occ = sample_slot(M.MAT_OCCLUSION_MAP, M.MAT_OCCLUSION_UV)
    emis = sample_slot(M.MAT_EMISSIVE_MAP, M.MAT_EMISSIVE_UV)

    base_factor = mat[..., M.MAT_BASE_COLOR_FACTOR : M.MAT_BASE_COLOR_FACTOR + 4]
    base_color = srgb_to_linear(base_rgba[..., :3] * base_factor[..., :3])
    metallic = mr[..., 2] * mat[..., M.MAT_METALLIC_FACTOR]
    roughness = mr[..., 1] * mat[..., M.MAT_ROUGHNESS_FACTOR]
    occlusion = occ[..., 0]
    emissive = emis[..., :3] * mat[
        ..., M.MAT_EMISSIVE_FACTOR : M.MAT_EMISSIVE_FACTOR + 3
    ]

    # normal mapping (gbuffer.frag:55-60): TBN only when tangents exist
    n_geo = _normalize(n_in)
    n_tex = _normalize(normal_map[..., :3] * 2.0 - 1.0)
    n_mapped = _normalize(
        t_in * n_tex[..., 0:1] + bt_in * n_tex[..., 1:2]
        + n_geo * n_tex[..., 2:3]
    )
    normal = torch.where(has_tangent[..., None], n_mapped, n_geo)
    velocity = _ndc01(clip) - _ndc01(prev_clip)
    return _assemble(covered, z, base_color, world_pos, normal, emissive,
                     occlusion, roughness, metallic, velocity)


def gbuffer_pass_fast(tri, z, scene, tri_attrs, params, slot_map: tuple,
                      cb: bool = False, full_wh=None,
                      plane_kernel: bool = True,
                      stack_kernel: bool = False, y0: int = 0) -> GBuffer:
    """tri/z: visibility planes (H, W), or the (H, W/2) checkerboard
    domain when ``cb``; ``full_wh`` is the raster target size and ``y0``
    the planes' first row in it (a band of a row-sharded frame).

    ``plane_kernel`` (``EngineConfig.attrs_plane_kernel``): the attribute
    planes come from the ``attr_planes`` kernel; off, the reference's
    non-kernel branch runs as torch ops (gbuffer.py:295-358): the row
    gather, homogeneous barycentrics, the corner interpolation and the
    bitangent as cross(n, t) * handedness.  ``stack_kernel``
    (``EngineConfig.stack_plane_kernel``): the sampled slots' channels
    come from the ``stack_planes`` kernel."""
    pv = params["proj_view"]
    used_cols = M.fast_used_cols(slot_map)
    if full_wh is None:
        full_wh = (tri.shape[1] * (2 if cb else 1), tri.shape[0])
    if plane_kernel:
        planes = attr_planes(
            tri, tri_attrs, pv, n_mat=len(used_cols), full_wh=full_wh, cb=cb,
            y0=y0,
        )

        def vec(a, b):
            return planes[a:b].permute(1, 2, 0)

        src = TailInputs(vec(0, 3), vec(3, 6), vec(6, 9), vec(9, 12),
                         vec(12, 14), planes[15],
                         mat_cols=vec(16, planes.shape[0]))
    else:
        row = sampling.take_rows(tri_attrs, torch.clamp(tri, min=0))

        def corner(base, width, k):
            return row[..., base + width * k : base + width * (k + 1)]

        nx, ny = pixel_ndc(tri.shape, full_wh, cb=cb, y0=y0,
                           device=tri.device)
        bb = _homogeneous_barycentrics(
            [corner(TRI_WP0, 3, k) for k in range(3)], pv, nx, ny
        )

        def interp(base, width):
            return (corner(base, width, 0) * bb[0][..., None]
                    + corner(base, width, 1) * bb[1][..., None]
                    + corner(base, width, 2) * bb[2][..., None])

        world_pos = interp(TRI_WP0, 3)
        n_in = interp(TRI_N0, 3)
        t_in = interp(TRI_T0, 3)
        uv0 = interp(TRI_UV0, 2)
        handed = row[..., TRI_HANDED]
        # the rows carry no corner bitangents: B = cross(N, T) * tangent.w
        bt_in = torch.linalg.cross(n_in, t_in, dim=-1) * handed[..., None]
        src = TailInputs(world_pos, n_in, t_in, bt_in, uv0, handed,
                         mat_cols=row[..., TRI_STRIDE:
                                      TRI_STRIDE + len(used_cols)])
    return gbuffer_tail(tri, z, src, params, scene, slot_map,
                        stack_kernel=stack_kernel)


def gbuffer_tail(tri, z, src: TailInputs, params, scene, slot_map: tuple,
                 stack_kernel: bool = False) -> GBuffer:
    """The fast path's tail after the attribute planes: velocity, material
    columns, texture-stack sampling (the sampled channels from the
    ``stack_planes`` kernel when ``stack_kernel``), factors, TBN normal
    mapping and assembly, on the domain of ``tri`` (its mask: tri >= 0).

    On a CUDA ``tri`` this is the kernel of ``csrc/gbuffer.cu`` (K10), on
    every input source; on the CPU it is the PyTorch ops of
    ``_gbuffer_tail_plain``, the kernel's plain version."""
    args = (tri, z, src, params["proj_view"], params["prev_proj_view"],
            scene, slot_map, stack_kernel)
    return _gbuffer_tail_plain(*args)


def _gbuffer_tail_plain(tri, z, src, pv, prev_pv, scene, slot_map,
                        stack_kernel):
    """gbuffer_tail in PyTorch ops: the CPU's path, and the plain version
    the kernel is held to on the card."""
    covered = tri >= 0
    world_pos = _vec(src.world_pos)
    # clip positions are linear in world pos: interpolate-then-project
    wp1 = torch.cat([world_pos, torch.ones_like(world_pos[..., :1])], -1)
    velocity = _ndc01(wp1 @ pv.t()) - _ndc01(wp1 @ prev_pv.t())
    handed = src.handed.abs() if src.handed_abs else src.handed
    mat_cols = src.mat_cols
    if mat_cols is None:
        mat_id = torch.round(src.mat_plane).to(torch.int64)
        used = _column_index(M.fast_used_cols(slot_map),
                             scene.materials.device)
        mat_cols = scene.materials.index_select(1, used)[mat_id]
    return _texture_and_assemble(
        covered, z, world_pos, _vec(src.n_in), _vec(src.t_in),
        _vec(src.bt_in), _vec(src.uv0), handed > 0.5, velocity, scene,
        slot_map, mat_cols=mat_cols, stack_kernel=stack_kernel,
    )


def _homogeneous_barycentrics(wp, pv, nx, ny):
    """Perspective-correct barycentrics of the pixel at NDC (nx, ny) from
    the three world-space corners ``wp`` (gbuffer.py:168): bb is
    proportional to the cross product of u = x - nx*w and v = y - ny*w
    over the corners' clip coordinates."""
    def clip_row(p, r):
        return (p[..., 0] * pv[r, 0] + p[..., 1] * pv[r, 1]
                + p[..., 2] * pv[r, 2] + pv[r, 3])

    u, v = [], []
    for k in range(3):
        wk = clip_row(wp[k], 3)
        u.append(clip_row(wp[k], 0) - nx * wk)
        v.append(clip_row(wp[k], 1) - ny * wk)
    q0 = u[1] * v[2] - u[2] * v[1]
    q1 = u[2] * v[0] - u[0] * v[2]
    q2 = u[0] * v[1] - u[1] * v[0]
    qs = q0 + q1 + q2
    qs = torch.where(qs.abs() > 1e-30, qs, 1.0)
    return q0 / qs, q1 / qs, q2 / qs


def _texture_and_assemble(covered, z, world_pos, n_in, t_in, bt_in, uv0,
                          has_tangent, velocity, scene, slot_map, mat_cols,
                          stack_kernel=False):
    """Material constants from ``mat_cols`` (the materials.fast_used_cols
    values per pixel), texture-stack sampling (by the ``stack_planes``
    kernel when ``stack_kernel``), factors, TBN normal mapping and
    G-buffer assembly."""
    used_cols = M.fast_used_cols(slot_map)
    col_pos = {c: i for i, c in enumerate(used_cols)}

    def col(c):
        return mat_cols[..., col_pos[c]]

    def cols(c, n):
        p = col_pos[c]
        return mat_cols[..., p : p + n]

    n_sampled = sum(1 for p in slot_map if p >= 0)
    if n_sampled > 0:
        idx, fx, fy = _stack_anchor(uv0, col(M.MAT_STACK_BASE),
                                    col(M.MAT_STACK_SIZE))
        groups = _stack_groups(scene, slot_map)
        if stack_kernel:
            spec, plane_of = out_spec(slot_map, [g.shape[1] for g in groups])
            sk_planes = stack_planes(idx, fx, fy, groups, spec)
        else:
            stack_row = torch.cat(
                [sampling.take_rows(g, idx) for g in groups], dim=-1
            )  # (H, W, 4 * n_sampled) packed RGBA8 quads
            w00 = (1 - fx) * (1 - fy)
            w10 = fx * (1 - fy)
            w01 = (1 - fx) * fy
            w11 = fx * fy

    def chan(k, c):
        """Channel c of slot k, bilinearly filtered, as (H, W)."""
        if slot_map[k] < 0:  # constant layer: per-material table value
            return cols(M.MAT_CONST_BASE + 4 * k, 4)[..., c]
        if stack_kernel:
            return sk_planes[plane_of[(k, c)]]
        quad = stack_row[..., 4 * slot_map[k] : 4 * slot_map[k] + 4]
        v = ((quad >> (8 * c)) & 0xFF).to(torch.float32) * (1.0 / 255.0)
        return (
            v[..., 0] * w00 + v[..., 1] * w10 + v[..., 2] * w01
            + v[..., 3] * w11
        )

    def slot3(k):
        return torch.stack([chan(k, c) for c in range(3)], dim=-1)

    base_factor = cols(M.MAT_BASE_COLOR_FACTOR, 4)
    base_color = srgb_to_linear(slot3(0) * base_factor[..., :3])
    metallic = chan(2, 2) * col(M.MAT_METALLIC_FACTOR)
    roughness = chan(2, 1) * col(M.MAT_ROUGHNESS_FACTOR)
    occlusion = chan(3, 0)
    emissive = slot3(4) * cols(M.MAT_EMISSIVE_FACTOR, 3)

    n_geo = _normalize(n_in)
    n_tex = _normalize(slot3(1) * 2.0 - 1.0)
    n_mapped = _normalize(
        t_in * n_tex[..., 0:1] + bt_in * n_tex[..., 1:2]
        + n_geo * n_tex[..., 2:3]
    )
    normal = torch.where(has_tangent[..., None], n_mapped, n_geo)

    return _assemble(covered, z, base_color, world_pos, normal, emissive,
                     occlusion, roughness, metallic, velocity)


def _assemble(covered, z, base_color, world_pos, normal, emissive,
              occlusion, roughness, metallic, velocity) -> GBuffer:
    """Clear values (gbuffer_pass.rs:482-499): zeros where uncovered."""
    m3 = covered[..., None]
    return GBuffer(
        base_color=torch.where(m3, base_color, 0.0),
        position=torch.where(m3, world_pos, 0.0),
        normal=torch.where(m3, normal, 0.0),
        emissive=torch.where(m3, emissive, 0.0),
        orm=torch.where(
            m3, torch.stack([occlusion, roughness, metallic], dim=-1), 0.0
        ),
        velocity=torch.where(m3, velocity, 0.0),
        depth=z,
        mask=covered,
    )


def gbuffer_pass_from_planes(tri, z, attrs, mat_plane, ht_plane, scene,
                             params, slot_map: tuple) -> GBuffer:
    """G-buffer from the megakernel's planes (gbuffer.py:518): the row
    gather and the interpolation happened inside the raster kernel; the
    material columns are fetched by the material-id plane, then the fast
    path's texturing tail runs.  ``attrs``: 14 (H, W) planes ordered
    wp.xyz, n.xyz, t.xyz, bt.xyz, uv0.uv."""
    src = TailInputs(tuple(attrs[0:3]), tuple(attrs[3:6]),
                     tuple(attrs[6:9]), tuple(attrs[9:12]),
                     tuple(attrs[12:14]), ht_plane, handed_abs=False,
                     mat_plane=mat_plane)
    return gbuffer_tail(tri, z, src, params, scene, slot_map)


def _stack_anchor(uv0, stack_base, stack_size):
    """The texture-stack row of each pixel's bilinear anchor texel and its
    fractions (fx, fy): per-material native sizes, REPEAT wrap."""
    base = stack_base.to(torch.int32)
    se_f = stack_size
    se_i = se_f.to(torch.int32)
    x = uv0[..., 0] * se_f - 0.5
    y = uv0[..., 1] * se_f - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    # REPEAT wrap: stack sizes are powers of two
    x0i = x0.to(torch.int32) & (se_i - 1)
    y0i = y0.to(torch.int32) & (se_i - 1)
    return base + y0i * se_i + x0i, fx, fy


def _stack_groups(scene, slot_map):
    """The texture-stack group tables the sampled slots of ``slot_map``
    read (two slots a group)."""
    n_sampled = sum(1 for p in slot_map if p >= 0)
    groups = [scene.texture_stack_a]
    if n_sampled > 2:
        groups.append(scene.texture_stack_b)
    if n_sampled > 4:
        groups.append(scene.texture_stack_c)
    return groups


@functools.lru_cache(maxsize=16)
def _column_index(cols: tuple, device):
    """The material-table columns ``cols`` as an index tensor on
    ``device``, made once: indexing with a Python list would copy it to
    the device on every frame, which a CUDA graph cannot capture."""
    return torch.tensor(cols, dtype=torch.int64, device=device)
