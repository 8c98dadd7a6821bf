"""frame_program: the deferred frame, op by op (copied out of the
port's passes/frame_graph.py)."""

from __future__ import annotations
import numpy as np
import torch
from ..device.sampling import (
    build_pcf_window_u16,
    build_pcf_window_u16_half,
    build_window_rows_2x4,
)
from ..kernels.decimate import decimate_cols
from ..kernels.raster_setup import (
    bin_triangles,
    triangle_setup,
    triangle_setup_from_attrs,
)
from ..kernels.rasterizer import BIN_H, BIN_W, rasterize, rasterize_attrs
from .checkerboard import reconstruct_present
from .gbuffer import gbuffer_pass, gbuffer_pass_fast, gbuffer_pass_from_planes
from .present import present_pass
from .shading import _even_grid, _upsample_pow2, _upsample_to_cb
from .shading import shading_pass, shading_pass_fast
from .ssao import ssao_pass, ssao_pass_tiles
from .vertex_stage import pack_raster_attr_rows, run_vertex_stage


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def _pcf_build(cfg):
    """Shadow map -> PCF table builder for the configured layout
    (frame_graph.py:50); shading.calculate_shadow_fast reads the layout
    off the table."""
    if not cfg.pcf_u16:
        return build_window_rows_2x4
    if cfg.pcf_half_anchor:
        return build_pcf_window_u16_half
    return build_pcf_window_u16


class CameraParams:
    """Per-frame camera/light block as ONE (64,) f32 device vector plus
    its host copy (the reference's CameraParams layout); ``stack_params``
    stacks several into (V, 64), whose fields keep the leading axis."""

    _LAYOUT = {
        "proj_view": (0, 16, (4, 4)),
        "prev_proj_view": (16, 32, (4, 4)),
        "light_proj_view": (32, 48, (4, 4)),
        "eye_pos": (48, 51, (3,)),
        "direction": (51, 54, (3,)),
        "right": (54, 57, (3,)),
        "up": (57, 60, (3,)),
        "near": (60, 61, ()),
        "near_wh": (61, 63, (2,)),
    }
    SIZE = 64

    def __init__(self, vec, host=None):
        self.vec = vec
        self.host = host

    def __getitem__(self, key):
        a, b, shape = self._LAYOUT[key]
        return self.vec[..., a:b].reshape(self.vec.shape[:-1] + shape)

    def host_field(self, key) -> np.ndarray:
        a, b, shape = self._LAYOUT[key]
        host = np.asarray(self.host)
        return host[..., a:b].reshape(host.shape[:-1] + shape)


def build_camera_params(camera: Camera, light_proj_view, device,
                        prev: CameraParams | None = None) -> CameraParams:
    """Pack one camera (and the shadow light) into CameraParams on
    ``device``; reuses ``prev`` when the packed bytes are identical."""
    proj = camera.projection()
    near = camera.near_p()
    near_h = 2.0 * near * np.tan(camera.fov() / 2.0)
    near_w = camera.aspect() * near_h
    buf = np.zeros(CameraParams.SIZE, np.float32)
    buf[0:16] = np.asarray(proj @ camera.view(), np.float32).reshape(-1)
    buf[16:32] = np.asarray(proj @ camera.prev_view(), np.float32).reshape(-1)
    buf[32:48] = np.asarray(light_proj_view, np.float32).reshape(-1)
    buf[48:51] = camera.position()
    buf[51:54] = camera.direction()
    buf[54:57] = camera.right()
    buf[57:60] = camera.up()
    buf[60] = near
    buf[61:63] = (near_w, near_h)
    if prev is not None and prev.host is not None and np.array_equal(
        prev.host, buf
    ):
        return prev
    return CameraParams(torch.from_numpy(buf).to(device), host=buf)


def _bin(setup, width, height, binned_cap, static=False):
    return bin_triangles(
        setup, tile_h=BIN_H, tile_w=BIN_W,
        n_tiles_x=-(-width // BIN_W), n_tiles_y=-(-height // BIN_H),
        binned_cap=binned_cap, static=static,
    )


def shadow_map_from_clip(scene, *, cfg, binned_cap, shadow_clip=None,
                         light_pv=None, static_bins=False):
    """Depth-only raster from the light (no culling, depth bias 2/2,
    shadow_pass.rs:132-140): from per-vertex light clip positions, or,
    when ``shadow_clip`` is None, from the packed per-triangle corners
    projected by ``light_pv``.  Returns (shadow map (S, S), dropped pair
    count); ``static_bins`` bins with no host read."""
    smap = cfg.shadow_map_size
    bias = dict(
        cull_backface=False,
        depth_bias_const=cfg.shadow_depth_bias_const,
        depth_bias_slope=cfg.shadow_depth_bias_slope,
    )
    if shadow_clip is None:
        setup = triangle_setup_from_attrs(
            scene.tri_attrs, scene.tri_valid, light_pv, smap, smap, **bias
        )
    else:
        setup = triangle_setup(
            shadow_clip, scene.indices, scene.tri_valid, smap, smap, **bias
        )
    binned = _bin(setup, smap, smap, binned_cap, static_bins)
    _, shadow_map, _, _ = rasterize(binned, width=smap, height=smap,
                                    depth_only=True)
    return shadow_map, binned.overflow


def shadow_program(scene, light_proj_view, *, cfg, binned_cap,
                   static_bins=False):
    """The fast path's memoizable shadow: the map from the packed corners
    -> the configured PCF window table.  Returns (table, dropped pair
    count); ``static_bins`` bins with no host read."""
    shadow_map, overflow = shadow_map_from_clip(
        scene, cfg=cfg, binned_cap=binned_cap, light_pv=light_proj_view,
        static_bins=static_bins,
    )
    return _pcf_build(cfg)(shadow_map), overflow


def _pad_edge(a, ph, pw):
    if pw:
        a = torch.cat([a, a[:, -1:].expand(-1, pw)], dim=1)
    if ph:
        a = torch.cat([a, a[-1:].expand(ph, -1)], dim=0)
    return a


def frame_program(scene, ibl, params, *, cfg, pad_w, pad_h, binned_cap,
                  has_shadow_light, slot_map, n_lights, fast=True,
                  shadow_quads=None, extra_passes=(), static_bins=False):
    """One deferred frame on the path ``fast`` and the config choose (see
    the module docstring).  ``extra_passes`` run on the full-resolution
    context between shading and present; ``static_bins`` bins under
    ``binned_cap`` with no host read (what a CUDA graph can capture).
    Returns (rgba (H, W) int32 packed rgba8 bits, (G-buffer, shadow)
    dropped-pair counts)."""
    use_shadow = cfg.shadow_enabled and has_shadow_light
    megakernel = fast and cfg.raster_interp_attrs
    attrs_setup = fast and not megakernel
    # a pass sees full-resolution arrays (RenderPass): no checkerboard
    use_cb = attrs_setup and cfg.checkerboard and not extra_passes
    vs = None if attrs_setup else run_vertex_stage(
        scene, params["proj_view"], params["prev_proj_view"],
        params["light_proj_view"],
    )

    shadow_map, shadow_overflow = None, 0
    if use_shadow and not (fast and shadow_quads is not None):
        shadow_map, shadow_overflow = shadow_map_from_clip(
            scene, cfg=cfg, binned_cap=binned_cap,
            shadow_clip=None if attrs_setup else vs.shadow_clip,
            light_pv=params["light_proj_view"], static_bins=static_bins,
        )

    if attrs_setup:
        setup = triangle_setup_from_attrs(
            scene.tri_attrs, scene.tri_valid, params["proj_view"], pad_w,
            pad_h, cull_backface=True,  # gbuffer_pass.rs:350
        )
    else:
        setup = triangle_setup(
            vs.clip, scene.indices, scene.tri_valid, pad_w, pad_h,
            cull_backface=True,
        )
    binned = _bin(setup, pad_w, pad_h, binned_cap, static_bins)
    if megakernel:
        tri, z, attrs, mat_plane, ht_plane = rasterize_attrs(
            binned, width=pad_w, height=pad_h,
            attr_rows=pack_raster_attr_rows(scene.tri_attrs,
                                            params["proj_view"]),
        )
        gbuf = gbuffer_pass_from_planes(tri, z, attrs, mat_plane, ht_plane,
                                        scene, params, slot_map)
    elif not fast:
        tri, z, b0, b1 = rasterize(binned, width=pad_w, height=pad_h)
        gbuf = gbuffer_pass(tri, z, b0, b1, scene, vs)
    else:
        tri, z, _, _ = rasterize(binned, width=pad_w, height=pad_h,
                                 slim=True)
        tri_g, z_g = tri, z
        if use_cb:
            tri_g, z_g = decimate_cols(tri, "cb"), decimate_cols(z, "cb")
        gbuf = gbuffer_pass_fast(tri_g, z_g, scene, scene.tri_attrs, params,
                                 slot_map, cb=use_cb, full_wh=(pad_w, pad_h),
                                 plane_kernel=cfg.attrs_plane_kernel,
                                 stack_kernel=cfg.stack_plane_kernel)

    # SSAO on the full-resolution depth; ssao_res_divisor > 1 evaluates it
    # on the even grid, edge-padded to tile multiples exactly as the
    # reference does (the padded width enters the radius formula)
    half_ssao = cfg.ssao_enabled and cfg.ssao_res_divisor > 1
    if cfg.ssao_enabled:
        d_in = _even_grid(z) if half_ssao else z
        d_pad = _pad_edge(
            d_in,
            _round_up(d_in.shape[0], cfg.tile_h) - d_in.shape[0],
            _round_up(d_in.shape[1], cfg.tile_w) - d_in.shape[1],
        ).contiguous()
        ssao = (ssao_pass_tiles if cfg.ssao_pallas else ssao_pass)(
            d_pad, near=cfg.ssao_near, far=cfg.ssao_far
        )
        ssao = ssao[: d_in.shape[0], : d_in.shape[1]]
        if half_ssao and use_cb:
            ssao = _upsample_to_cb(ssao, *gbuf.depth.shape, 2, 1)
        elif half_ssao:
            ssao = _upsample_pow2(ssao, *gbuf.depth.shape, 2)
        elif use_cb:
            ssao = decimate_cols(ssao, "cb")
    else:
        ssao = torch.ones_like(gbuf.depth)

    if fast:
        if use_shadow and shadow_quads is None:
            shadow_quads = _pcf_build(cfg)(shadow_map)
        color = shading_pass_fast(
            gbuf, ssao, shadow_quads if use_shadow else None,
            cfg.shadow_map_size, scene.lights, n_lights, params, ibl=ibl,
            shadow_res_divisor=cfg.pcf_res_divisor,
            parent_mip_half_res=cfg.spec_parent_mip_half_res,
            mirror_half_res=cfg.spec_mirror_half_res,
            merged_trilinear=cfg.spec_merged_trilinear, cb=use_cb,
        )
    else:
        color = shading_pass(gbuf, ssao, shadow_map, scene.lights, n_lights,
                             params, ibl=ibl)
    ctx = {"color": color, "gbuffer": gbuf, "ssao": ssao}
    for p in extra_passes:
        ctx = p.render(ctx)
    if use_cb:  # never with extra passes
        rgba = reconstruct_present(ctx["color"], tri)
    else:
        rgba = present_pass(ctx["color"])
    return rgba[: cfg.height, : cfg.width], (binned.overflow, shadow_overflow)

