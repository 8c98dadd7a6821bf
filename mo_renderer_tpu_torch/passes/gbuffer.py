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

import ctypes
import dataclasses
import functools

import torch

from ..assets import materials as M
from ..device import sampling
from ..kernels import _build
from ..kernels.attr_planes import attr_planes, pixel_ndc
from ..kernels.stack_planes import SLOT_CHANNELS, _INV255, out_spec, \
    stack_planes
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
    if tri.is_cuda:
        return _gbuffer_ref_cuda(tri, z, b0, b1, scene, vs)
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
    if tri.is_cuda:
        return _gbuffer_tail_cuda(*args)
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


# --- K10: the kernel of csrc/gbuffer.cu --------------------------------------

N_GEO = 15  # kGeo: wp 0-2, n 3-5, t 6-8, bt 9-11, uv0 12-13, handedness 14
MAX_MAT = 31  # kMaxMat: fast_used_cols with every slot constant
SLOT_CONST, SLOT_GATHER, SLOT_PLANES = 0, 1, 2  # GbufArgs.slot_kind
GBUFFER_OUT = ("base_color", "position", "normal", "emissive", "orm",
               "velocity")


class GbufArgs(ctypes.Structure):
    """csrc/gbuffer.cu's GbufArgs, field for field."""

    _fields_ = [
        ("ch", ctypes.c_void_p * (N_GEO + MAX_MAT)),
        ("st", ctypes.c_int * (2 * (N_GEO + MAX_MAT))),
        ("tri", ctypes.c_void_p),
        ("tri_st", ctypes.c_int * 2),
        ("mat_id", ctypes.c_void_p),
        ("mat_id_st", ctypes.c_int * 2),
        ("materials", ctypes.c_void_p),
        ("mat_stride", ctypes.c_int),
        ("n_materials", ctypes.c_int),
        ("mat_col", ctypes.c_int * MAX_MAT),
        ("groups", ctypes.c_void_p * 3),
        ("group_words", ctypes.c_int * 3),
        ("group_rows", ctypes.c_int * 3),
        ("sk", ctypes.c_void_p),
        ("slot_kind", ctypes.c_int * 5),
        ("slot_group", ctypes.c_int * 5),
        ("slot_word", ctypes.c_int * 5),
        ("slot_plane", ctypes.c_int * 15),
        *[(name, ctypes.c_int) for name in (
            "col_stack_base", "col_stack_size", "col_base_factor",
            "col_emissive_factor", "col_metallic", "col_roughness")],
        ("col_const", ctypes.c_int * 5),
        ("pv", ctypes.c_void_p),
        ("prev_pv", ctypes.c_void_p),
        ("inv255", ctypes.c_float),
        ("ht_abs", ctypes.c_int),
        ("h", ctypes.c_int),
        ("w", ctypes.c_int),
        ("out", ctypes.c_void_p * 6),
        ("mask", ctypes.c_void_p),
        ("row_out", ctypes.c_void_p),
    ]


def _channels(x, k):
    """The k (H, W) channel planes of a TailInputs field, as views."""
    return list(x) if isinstance(x, tuple) else [x[..., c] for c in range(k)]


def tail_args(tri, src, pv, prev_pv, scene, slot_map, sk=None,
              plane_of=None, debug=False):
    """What K10 reads: (GbufArgs, the tensors it writes and keeps alive).
    ``sk``/``plane_of``: the stack_planes kernel's planes and their
    (slot, channel) index, on the stacks path.  ``debug``: also keep
    ``row_out``, each pixel's texture-stack row (-1 where none is
    gathered).  Pure Python over the tensors' pointers, shapes and
    strides: nothing is read from the device, and the outputs come from
    the caching allocator, so a CUDA graph captures the call."""
    h, w = tri.shape
    dev = tri.device
    used = M.fast_used_cols(slot_map)
    col_pos = {c: i for i, c in enumerate(used)}
    geo = (_channels(src.world_pos, 3) + _channels(src.n_in, 3)
           + _channels(src.t_in, 3) + _channels(src.bt_in, 3)
           + _channels(src.uv0, 2) + [src.handed])
    mat = [] if src.mat_cols is None else _channels(src.mat_cols,
                                                   src.mat_cols.shape[-1])
    if src.mat_cols is None and src.mat_plane is None:
        raise ValueError("gbuffer: no material columns and no material ids")
    if src.mat_cols is not None and len(mat) != len(used):
        raise ValueError(f"gbuffer: {len(mat)} material columns, expected "
                         f"{len(used)} for slot map {slot_map}")
    if len(used) > MAX_MAT:
        raise ValueError(f"gbuffer: {len(used)} material columns, the "
                         f"kernel takes {MAX_MAT}")
    planes = geo + mat + ([src.mat_plane] if src.mat_cols is None else [])
    for i, t in enumerate(planes):
        if (tuple(t.shape) != (h, w) or t.dtype != torch.float32
                or t.device != dev):
            raise ValueError(f"gbuffer: input plane {i} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}, expected "
                             f"float32 {(h, w)} on {dev}")
    if tri.dtype != torch.int32:
        raise TypeError(f"gbuffer: tri is {tri.dtype}, expected int32")
    # the kernel's offsets are 32-bit: every table and plane it indexes
    indexed = planes + [tri] + _stack_groups(scene, slot_map)
    if src.mat_cols is None:
        indexed.append(scene.materials)
    if sk is not None:
        indexed.append(sk)
    if (max(map(_build.max_offset, indexed)) > _build.INT32_MAX
            or h * w * 3 > _build.INT32_MAX):
        raise ValueError("gbuffer: an input spans more than the kernel's "
                         "32-bit offsets reach")

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    keep = {k: empty(h, w, 2 if k == "velocity" else 3)
            for k in GBUFFER_OUT}
    keep["mask"] = empty(h, w, dtype=torch.bool)
    if debug:
        keep["row_out"] = empty(h, w, dtype=torch.int32)
    small = {"pv": pv.contiguous(), "prev_pv": prev_pv.contiguous()}
    keep.update(small)
    a = GbufArgs()
    a.ch[:len(geo) + len(mat)] = [t.data_ptr() for t in geo + mat]
    a.st[:2 * (len(geo) + len(mat))] = [s for t in geo + mat
                                        for s in t.stride()]
    a.tri, a.tri_st[:] = tri.data_ptr(), tri.stride()
    if src.mat_cols is None:
        mats = scene.materials
        if mats.dtype != torch.float32 or mats.stride(-1) != 1 \
                or mats.device != dev:
            raise ValueError("gbuffer: scene.materials must be float32 "
                             f"rows on {dev}")
        a.mat_id, a.mat_id_st[:] = src.mat_plane.data_ptr(), \
            src.mat_plane.stride()
        a.materials, a.mat_stride = mats.data_ptr(), mats.stride(0)
        a.n_materials = mats.shape[0]
        a.mat_col[:len(used)] = used
    groups = _stack_groups(scene, slot_map)
    if sk is None and any(p >= 0 for p in slot_map):
        for g in groups:
            if (g.dtype != torch.int32 or g.dim() != 2 or g.shape[1] % 4
                    or not g.is_contiguous() or g.data_ptr() % 16
                    or g.device != dev):
                raise ValueError(
                    f"gbuffer: stack group {tuple(g.shape)} {g.dtype} must "
                    f"be (rows, 4k) int32, contiguous, 16-byte aligned")
        a.groups[:len(groups)] = [g.data_ptr() for g in groups]
        a.group_words[:len(groups)] = [g.shape[1] for g in groups]
        a.group_rows[:len(groups)] = [g.shape[0] for g in groups]
        spec, plane_of_gather = out_spec(slot_map,
                                         [g.shape[1] for g in groups])
    elif sk is not None:
        if (tuple(sk.shape[1:]) != (h, w) or not sk.is_contiguous()
                or sk.dtype != torch.float32 or sk.device != dev):
            raise ValueError(f"gbuffer: stack planes {tuple(sk.shape)} "
                             f"must be contiguous float32 (n, {h}, {w})")
        a.sk = sk.data_ptr()
    for k, p in enumerate(slot_map):
        if p < 0:
            a.slot_kind[k] = SLOT_CONST
            a.col_const[k] = col_pos[M.MAT_CONST_BASE + 4 * k]
        elif sk is None:
            g, word, _ = spec[plane_of_gather[(k, SLOT_CHANNELS[k][0])]]
            a.slot_kind[k], a.slot_group[k], a.slot_word[k] = (
                SLOT_GATHER, g, word)
        else:
            a.slot_kind[k] = SLOT_PLANES
            for c in range(3):
                a.slot_plane[3 * k + c] = plane_of.get((k, c), -1)
    a.col_stack_base = col_pos[M.MAT_STACK_BASE]
    a.col_stack_size = col_pos[M.MAT_STACK_SIZE]
    a.col_base_factor = col_pos[M.MAT_BASE_COLOR_FACTOR]
    a.col_emissive_factor = col_pos[M.MAT_EMISSIVE_FACTOR]
    a.col_metallic = col_pos[M.MAT_METALLIC_FACTOR]
    a.col_roughness = col_pos[M.MAT_ROUGHNESS_FACTOR]
    a.pv, a.prev_pv = small["pv"].data_ptr(), small["prev_pv"].data_ptr()
    a.inv255 = _INV255
    a.ht_abs = src.handed_abs
    a.h, a.w = h, w
    a.out[:] = [keep[k].data_ptr() for k in GBUFFER_OUT]
    a.mask = keep["mask"].data_ptr()
    a.row_out = keep["row_out"].data_ptr() if debug else None
    return a, keep


def _gbuffer_tail_cuda(tri, z, src, pv, prev_pv, scene, slot_map,
                       stack_kernel, debug=False):
    """K10 on the current stream, behind the stack_planes kernel on the
    stacks path (it reads that kernel's planes).  ``debug``: return
    (GBuffer, the kept tensors of ``tail_args``)."""
    sk = plane_of = None
    if stack_kernel and any(p >= 0 for p in slot_map):
        if src.mat_cols is None:
            raise ValueError("gbuffer: the stack kernel needs the material "
                             "columns as planes")
        col_pos = {c: i for i, c in enumerate(M.fast_used_cols(slot_map))}
        idx, fx, fy = _stack_anchor(
            _vec(src.uv0), src.mat_cols[..., col_pos[M.MAT_STACK_BASE]],
            src.mat_cols[..., col_pos[M.MAT_STACK_SIZE]])
        groups = _stack_groups(scene, slot_map)
        spec, plane_of = out_spec(slot_map, [g.shape[1] for g in groups])
        sk = stack_planes(idx, fx, fy, groups, spec)
    a, keep = tail_args(tri, src, pv, prev_pv, scene, slot_map, sk,
                        plane_of, debug)
    launch_gbuffer(a, keep["mask"])
    gbuf = GBuffer(**{k: keep[k] for k in GBUFFER_OUT}, depth=z,
                   mask=keep["mask"])
    return (gbuf, keep) if debug else gbuf


def launch_gbuffer(a, like):
    """The C entry of csrc/gbuffer.cu on ``like``'s stream; one count."""
    lib = _build.library()
    if lib.mo_gbuffer_args_size() != ctypes.sizeof(GbufArgs):
        raise RuntimeError("gbuffer: GbufArgs does not match csrc/gbuffer.cu")
    fn = _build.function("mo_gbuffer", [ctypes.POINTER(GbufArgs), _build.P])
    _build.check("gbuffer", fn(ctypes.byref(a), _build.stream_of(like)))
    _build.count("gbuffer")


# --- K12: the kernel of csrc/gbuffer_ref.cu ----------------------------------

# the per-vertex attributes K12 interpolates, in GbufRefArgs.attr order
# (csrc/gbuffer_ref.cu kAttr*): (VertexOutputs or SceneBuffers field,
# channels)
REF_ATTRS = (("world_pos", 3), ("world_normal", 3), ("world_tangent", 3),
             ("world_bitangent", 3), ("clip", 4), ("prev_clip", 4),
             ("uv0", 2), ("uv1", 2))
# the debug output's int32 channels per pixel (-1 where uncovered): each
# slot's flat texel anchor (layer * S * S + y0 * S + x0 after the wrap),
# then the UV sets (bit k: slot k sampled UV set 1)
REF_DEBUG = ("base_color", "normal", "mr", "occlusion", "emissive",
             "uv_sets")
# the material columns K12 reads (csrc/gbuffer_ref.cu kMat*)
REF_MAT_COLS = M.MAT_ROUGHNESS_FACTOR + 1


class GbufRefArgs(ctypes.Structure):
    """csrc/gbuffer_ref.cu's GbufRefArgs, field for field."""

    _fields_ = [
        ("tri", ctypes.c_void_p),
        ("tri_st", ctypes.c_int * 2),
        ("b0", ctypes.c_void_p),
        ("b0_st", ctypes.c_int * 2),
        ("b1", ctypes.c_void_p),
        ("b1_st", ctypes.c_int * 2),
        ("indices", ctypes.c_void_p),
        ("indices_st", ctypes.c_int * 2),
        ("n_tris", ctypes.c_int),
        ("inv_w", ctypes.c_void_p),
        ("inv_w_st", ctypes.c_int),
        ("attr", ctypes.c_void_p * len(REF_ATTRS)),
        ("attr_st", ctypes.c_int * (2 * len(REF_ATTRS))),
        ("n_verts", ctypes.c_int),
        ("has_tangent", ctypes.c_void_p),
        ("has_tangent_st", ctypes.c_int),
        ("tri_mesh", ctypes.c_void_p),
        ("tri_mesh_st", ctypes.c_int),
        ("mesh_material", ctypes.c_void_p),
        ("mesh_material_st", ctypes.c_int),
        ("n_meshes", ctypes.c_int),
        ("materials", ctypes.c_void_p),
        ("mat_st", ctypes.c_int * 2),
        ("n_materials", ctypes.c_int),
        ("textures", ctypes.c_void_p),
        ("n_texels", ctypes.c_int),
        ("tex_size", ctypes.c_int),
        ("inv255", ctypes.c_float),
        ("h", ctypes.c_int),
        ("w", ctypes.c_int),
        ("out", ctypes.c_void_p * 6),
        ("mask", ctypes.c_void_p),
        ("dbg", ctypes.c_void_p),
    ]


def gbuffer_ref_args(tri, b0, b1, scene, vs, debug=False):
    """What K12 reads: (GbufRefArgs, the tensors it writes and keeps
    alive: the GBUFFER_OUT planes, ``mask`` and, with ``debug``, ``dbg``,
    each pixel's REF_DEBUG channels).  Every input is read where it lies,
    through its strides; the texture array must be a contiguous (L, S, S,
    4) uint8 array (the kernel reads a texel as one 32-bit word).  Pure
    Python over the tensors' pointers, shapes and strides: nothing is read
    from the device, and the outputs come from the caching allocator, so a
    CUDA graph captures the call."""
    h, w = tri.shape
    dev = tri.device

    def need(name, t, dtype, shape):
        if t.dtype != dtype or t.device != dev or tuple(t.shape) != shape:
            raise ValueError(f"gbuffer_ref: {name} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}, expected "
                             f"{dtype} {shape} on {dev}")

    n_tris = scene.indices.shape[0]
    n_verts = vs.inv_w.shape[0]
    attrs = [getattr(scene if name.startswith("uv") else vs, name)
             for name, _ in REF_ATTRS]
    tables = {"tri": (tri, torch.int32, (h, w)),
              "b0": (b0, torch.float32, (h, w)),
              "b1": (b1, torch.float32, (h, w)),
              "scene.indices": (scene.indices, torch.int32, (n_tris, 3)),
              "vs.inv_w": (vs.inv_w, torch.float32, (n_verts,)),
              "vs.has_tangent": (vs.has_tangent, torch.bool, (n_verts,)),
              "scene.tri_mesh": (scene.tri_mesh, torch.int32, (n_tris,)),
              "scene.mesh_material": (scene.mesh_material, torch.int32,
                                      tuple(scene.mesh_material.shape[:1]))}
    for (name, k), t in zip(REF_ATTRS, attrs):
        tables[name] = (t, torch.float32, (n_verts, k))
    for name, (t, dtype, shape) in tables.items():
        need(name, t, dtype, shape)
    mats = scene.materials
    if (mats.dtype != torch.float32 or mats.device != dev or mats.dim() != 2
            or mats.shape[1] < REF_MAT_COLS):
        raise ValueError(f"gbuffer_ref: scene.materials is {mats.dtype} "
                         f"{tuple(mats.shape)} on {mats.device}, expected "
                         f"float32 rows of {REF_MAT_COLS}+ columns on {dev}")
    tex = scene.textures
    if (tex.dtype != torch.uint8 or tex.device != dev or tex.dim() != 4
            or tex.shape[1] != tex.shape[2] or tex.shape[3] != 4
            or not tex.is_contiguous() or tex.data_ptr() % 4):
        raise ValueError(f"gbuffer_ref: scene.textures is {tex.dtype} "
                         f"{tuple(tex.shape)} on {tex.device}, expected a "
                         f"contiguous, 4-byte aligned (L, S, S, 4) uint8 "
                         f"array on {dev}")
    # the kernel's offsets are 32-bit: every table and plane it indexes
    indexed = [t for t, _, _ in tables.values()] + [mats, tex]
    if (max(map(_build.max_offset, indexed)) > _build.INT32_MAX
            or h * w * len(REF_DEBUG) > _build.INT32_MAX):
        raise ValueError("gbuffer_ref: an input spans more than the "
                         "kernel's 32-bit offsets reach")

    keep = {k: torch.empty((h, w, 2 if k == "velocity" else 3),
                           dtype=torch.float32, device=dev)
            for k in GBUFFER_OUT}
    keep["mask"] = torch.empty((h, w), dtype=torch.bool, device=dev)
    if debug:
        keep["dbg"] = torch.empty((h, w, len(REF_DEBUG)), dtype=torch.int32,
                                  device=dev)
    a = GbufRefArgs()
    a.tri, a.tri_st[:] = tri.data_ptr(), tri.stride()
    a.b0, a.b0_st[:] = b0.data_ptr(), b0.stride()
    a.b1, a.b1_st[:] = b1.data_ptr(), b1.stride()
    a.indices, a.indices_st[:] = scene.indices.data_ptr(), \
        scene.indices.stride()
    a.n_tris = n_tris
    a.inv_w, a.inv_w_st = vs.inv_w.data_ptr(), vs.inv_w.stride(0)
    a.attr[:] = [t.data_ptr() for t in attrs]
    a.attr_st[:] = [s for t in attrs for s in t.stride()]
    a.n_verts = n_verts
    a.has_tangent = vs.has_tangent.data_ptr()
    a.has_tangent_st = vs.has_tangent.stride(0)
    a.tri_mesh = scene.tri_mesh.data_ptr()
    a.tri_mesh_st = scene.tri_mesh.stride(0)
    a.mesh_material = scene.mesh_material.data_ptr()
    a.mesh_material_st = scene.mesh_material.stride(0)
    a.n_meshes = scene.mesh_material.shape[0]
    a.materials, a.mat_st[:] = mats.data_ptr(), mats.stride()
    a.n_materials = mats.shape[0]
    a.textures = tex.data_ptr()
    a.n_texels = tex.shape[0] * tex.shape[1] * tex.shape[2]
    a.tex_size = tex.shape[1]
    a.inv255 = _INV255
    a.h, a.w = h, w
    a.out[:] = [keep[k].data_ptr() for k in GBUFFER_OUT]
    a.mask = keep["mask"].data_ptr()
    a.dbg = keep["dbg"].data_ptr() if debug else None
    return a, keep


def _gbuffer_ref_cuda(tri, z, b0, b1, scene, vs, debug=False):
    """K12: one launch on the current stream.  ``debug``: also write the
    REF_DEBUG channels and return (GBuffer, the kept tensors)."""
    a, keep = gbuffer_ref_args(tri, b0, b1, scene, vs, debug=debug)
    launch_gbuffer_ref(a, keep["mask"])
    gbuf = GBuffer(**{k: keep[k] for k in GBUFFER_OUT}, depth=z,
                   mask=keep["mask"])
    return (gbuf, keep) if debug else gbuf


def launch_gbuffer_ref(a, like):
    """The C entry of csrc/gbuffer_ref.cu on ``like``'s stream; one
    count."""
    lib = _build.library()
    if lib.mo_gbuffer_ref_args_size() != ctypes.sizeof(GbufRefArgs):
        raise RuntimeError("gbuffer_ref: GbufRefArgs does not match "
                           "csrc/gbuffer_ref.cu")
    fn = _build.function("mo_gbuffer_ref",
                         [ctypes.POINTER(GbufRefArgs), _build.P])
    _build.check("gbuffer_ref", fn(ctypes.byref(a), _build.stream_of(like)))
    _build.count("gbuffer_ref")
