"""Renderer — the deferred frame (port of
``mo_renderer_tpu/passes/frame_graph.py``) on its three paths.

- Default (fast sampling, checkerboard): shadow raster (memoized while the
  light and the scene stay the same) -> visibility raster from the packed
  per-triangle corners -> checkerboard decimation -> G-buffer
  (attr_planes) -> half-rate SSAO -> fast shading + skybox -> present and
  checkerboard reconstruction in one kernel -> crop.  Its options all run
  as in the reference: the attribute planes as torch ops
  (``attrs_plane_kernel`` off), the texture stacks through the
  ``stack_planes`` kernel (``stack_plane_kernel``), the three PCF table
  layouts, the specular branches (``spec_*``) and SSAO as whole-image
  torch ops (``ssao_pallas`` off).
- Reference sampling path (``fast_sampling=False``, or any material that
  samples UV set 1): the per-vertex stage, the shadow map re-rasterized
  from its light clip positions every frame, the full-mode raster with
  barycentrics, ``gbuffer_pass`` and ``shading_pass`` sampling the maps
  directly, at full rate (no checkerboard); on a card ``shading_pass`` is
  one kernel, K11.
- Megakernel (``raster_interp_attrs=True``): the per-vertex stage, the
  raster that interpolates the attributes (``rasterize_attrs``), then the
  fast path's texturing, shading and memoized shadow, without the
  checkerboard.

Extra render passes (``RenderPass``) run between shading and present and
switch the checkerboard off, so they see full-resolution arrays.

On a card the frame runs as one compiled program, as the reference's
``jax.jit`` runs it: ``render_device``, ``render_sequence_device`` and
``MultiViewRenderer`` replay one ``torch.cuda.CUDAGraph`` of the frame
(``bin_triangles`` bins under the static pair capacity, so nothing reads
the device on the host), and the memoized shadow is a second graph (the
reference's ``_shadow_fn``).  A graph is keyed on the layout, not on
objects: the prepare, the pad size, the config, the light, the shadow
mode, the IBL maps, the extra passes and the shape of every scene
field.  Its inputs are buffers it owns, which each call fills
by copies that do not block (``_Staged``, ``_StagedScene``; the camera
block from page-locked host memory), so a camera, entity or light move,
a spawn and a despawn replay the same graph.  The host side before a
replay checks what each step saw last and rebuilds only what changed
(the camera block, the transforms, the key).  On the CPU the frame runs
eagerly, op by op, binned the same way.  Nothing falls back to another
path: a capture that fails raises.

Each pass of ``frame_program`` runs in ``kernels/mark.py``'s
``pass_span``, the tracer's span of the pass (``utils/trace.py``): with
the tracer on, a captured program holds a marker kernel at each pass
boundary, and its key says so.
"""

from __future__ import annotations

import dataclasses
import gc
import logging

import numpy as np
import torch

from ..assets.ibl_resource import IBLResource
from ..config import EngineConfig
from ..device import resolve_device
from ..device.sampling import (
    build_pcf_window_u16,
    build_pcf_window_u16_half,
    build_window_rows_2x4,
)
from ..kernels import _build, mark
from ..kernels.decimate import decimate_cols
from ..kernels.raster_setup import (
    bin_triangles,
    pair_capacity,
    triangle_setup,
    triangle_setup_from_attrs,
)
from ..kernels.rasterizer import BIN_H, BIN_W, rasterize, rasterize_attrs
from ..scene.camera import Camera
from ..scene.scene_buffers import (
    find_shadow_light,
    incremental_repack,
    pack_scene,
    refresh_lights,
    refresh_transforms,
)
from ..utils import trace
from .checkerboard import reconstruct_present
from .gbuffer import gbuffer_pass, gbuffer_pass_fast, gbuffer_pass_from_planes
from .present import present_pass, unpack_rgba8
from .shading import _even_grid, _upsample_pow2, _upsample_to_cb
from .shading import shading_pass, shading_pass_fast
from .ssao import ssao_pass, ssao_pass_tiles
from .vertex_stage import pack_raster_attr_rows, run_vertex_stage

logger = logging.getLogger("mo_renderer_tpu_torch")


class RenderPass:
    """API-parity base for custom passes (RenderPassTrait,
    mo_renderpass/src/lib.rs:25-48).  Custom passes are pure functions over
    the frame context dict; they slot in after shading, before present.

    Context domain: ctx['color'] / ctx['gbuffer'] / ctx['ssao'] are always
    FULL-RESOLUTION (H, W[, C]) tensors at the padded frame size — matching
    the reference's RenderPassTrait, whose passes see full-res attachments.
    Checkerboard shading (cfg.checkerboard) is therefore disabled
    automatically whenever extra passes are present: a custom pass must
    never silently receive the (H, W/2) parity-shuffled cb domain.

    On a card, the Renderer captures the frame, the passes included, in a
    CUDA graph: ``render`` runs while the frame is captured (once on a
    side stream to warm up, once into the graph), not at each replay, as
    a pass in the reference's ``jit`` is traced, not called per frame.  A
    pass that reads a tensor on the host (``.item()``, ``int(t)``,
    boolean-mask indexing, a host-to-device copy) makes the capture
    raise, and the error is not caught."""

    def render(self, ctx: dict) -> dict:
        return ctx

    def on_swapchain_recreate(self, window_size) -> None:
        pass


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
    stacks several into (V, 64), whose fields keep the leading axis.

    ``src`` is the tensor a captured program's input is filled from:
    ``vec`` itself, or, for ``Renderer.frame_params``'s block, the host
    vector the block was written into (page-locked for a card), which
    ``host`` views.  Such a block copies ``vec`` to ``device`` on its
    first use only; a replayed frame reads ``src`` and never asks."""

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

    def __init__(self, vec, host=None, src=None, device=None):
        self._vec = vec
        self.host = host
        self.src = vec if src is None else src
        self._device = device

    @property
    def vec(self):
        if self._vec is None:
            self._vec = self.src.to(self._device, non_blocking=True)
        return self._vec

    @classmethod
    def _field(cls, t, key):
        a, b, shape = cls._LAYOUT[key]
        return t[..., a:b].reshape(t.shape[:-1] + shape)

    def __getitem__(self, key):
        return self._field(self.vec, key)

    def host_field(self, key) -> np.ndarray:
        return self._field(np.asarray(self.host), key)

    def src_field(self, key):
        return self._field(self.src, key)


def stack_params(param_list) -> CameraParams:
    """CameraParams (``build_camera_params``) stacked into one with a
    leading (N, ...) axis, on the device and on the host
    (multi_view.py:42)."""
    return CameraParams(torch.stack([p.vec for p in param_list]),
                        host=np.stack([p.host for p in param_list]))


_ZERO, _ONE, _TWO = np.float32(0.0), np.float32(1.0), np.float32(2.0)


def _rotate(ux, uy, uz, w, vx, vy, vz):
    """``quat.rotate`` of (vx, vy, vz) by the unit quaternion (u, w) in
    float32 scalars, operation for operation: ``np.cross`` takes each
    component as a product minus a product, and the result is
    ``v + 2 * (w * uv + uuv)``, so every rounding is the same."""
    ax = uy * vz - uz * vy
    ay = uz * vx - ux * vz
    az = ux * vy - uy * vx
    bx = uy * az - uz * ay
    by = uz * ax - ux * az
    bz = ux * ay - uy * ax
    return (vx + _TWO * (w * ax + bx), vy + _TWO * (w * ay + by),
            vz + _TWO * (w * az + bz))


def _camera_basis(rotation):
    """``Transform.direction()``, ``right()`` and ``up()`` (the rotation
    applied to +Z, +X and +Y) as 9 float32 scalars, the bytes numpy
    gives, without numpy's per-call cost."""
    ux, uy, uz, w = np.asarray(rotation, np.float32)
    return (_rotate(ux, uy, uz, w, _ZERO, _ZERO, _ONE)
            + _rotate(ux, uy, uz, w, _ONE, _ZERO, _ZERO)
            + _rotate(ux, uy, uz, w, _ZERO, _ONE, _ZERO))


def _write_camera_block(out, camera: Camera, light_proj_view) -> None:
    """The 64 floats of one camera (and the shadow light) into the
    float32 array ``out``."""
    proj = camera.projection()
    near = camera.near_p()
    near_h = 2.0 * near * np.tan(camera.fov() / 2.0)
    near_w = camera.aspect() * near_h
    out[0:16] = np.asarray(proj @ camera.view(), np.float32).reshape(-1)
    out[16:32] = np.asarray(proj @ camera.prev_view(), np.float32).reshape(-1)
    out[32:48] = np.asarray(light_proj_view, np.float32).reshape(-1)
    out[48:51] = camera.position()
    out[51:60] = _camera_basis(camera.transform.rotation)
    out[60:64] = (near, near_w, near_h, 0.0)


def build_camera_params(camera: Camera, light_proj_view, device,
                        prev: CameraParams | None = None) -> CameraParams:
    """Pack one camera (and the shadow light) into CameraParams on
    ``device``; reuses ``prev`` when the packed bytes are identical."""
    buf = np.empty(CameraParams.SIZE, np.float32)
    _write_camera_block(buf, camera, light_proj_view)
    if prev is not None and prev.host is not None and np.array_equal(
        prev.host, buf
    ):
        return prev
    return CameraParams(torch.from_numpy(buf).to(device), host=buf)


def _bin(setup, width, height, binned_cap):
    return bin_triangles(
        setup, tile_h=BIN_H, tile_w=BIN_W,
        n_tiles_x=-(-width // BIN_W), n_tiles_y=-(-height // BIN_H),
        binned_cap=binned_cap,
    )


def shadow_map_from_clip(scene, *, cfg, binned_cap, shadow_clip=None,
                         light_pv=None):
    """Depth-only raster from the light (no culling, depth bias 2/2,
    shadow_pass.rs:132-140): from per-vertex light clip positions, or,
    when ``shadow_clip`` is None, from the packed per-triangle corners
    projected by ``light_pv``.  Returns (shadow map (S, S), dropped pair
    count, a 0-d device tensor)."""
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
    binned = _bin(setup, smap, smap, binned_cap)
    _, shadow_map, _, _ = rasterize(binned, width=smap, height=smap,
                                    depth_only=True)
    return shadow_map, binned.overflow


def shadow_program(scene, light_proj_view, *, cfg, binned_cap):
    """The fast path's memoizable shadow: the map from the packed corners
    -> the configured PCF window table.  Returns (table, dropped pair
    count, a 0-d device tensor)."""
    shadow_map, overflow = shadow_map_from_clip(
        scene, cfg=cfg, binned_cap=binned_cap, light_pv=light_proj_view,
    )
    return _pcf_build(cfg)(shadow_map), overflow


def overflow_counts(gbuffer=None, shadow=None):
    """(G-buffer, shadow) dropped pairs as one (2,) int64 tensor: each a
    binning's 0-d device count, or None (zero) for a pass not binned."""
    zero = torch.zeros_like(shadow if gbuffer is None else gbuffer)
    return torch.stack([zero if gbuffer is None else gbuffer,
                        zero if shadow is None else shadow])


def _pad_edge(a, ph, pw):
    if pw:
        a = torch.cat([a, a[:, -1:].expand(-1, pw)], dim=1)
    if ph:
        a = torch.cat([a, a[-1:].expand(ph, -1)], dim=0)
    return a


def frame_program(scene, ibl, params, *, cfg, pad_w, pad_h, binned_cap,
                  has_shadow_light, slot_map, n_lights, fast=True,
                  shadow_quads=None, extra_passes=()):
    """One deferred frame on the path ``fast`` and the config choose (see
    the module docstring).  ``extra_passes`` run on the full-resolution
    context between shading and present.  Returns (rgba (H, W) int32
    packed rgba8 bits, (G-buffer, shadow) dropped-pair counts as a (2,)
    int64 tensor on the frame's device)."""
    use_shadow = cfg.shadow_enabled and has_shadow_light
    megakernel = fast and cfg.raster_interp_attrs
    attrs_setup = fast and not megakernel
    # a pass sees full-resolution arrays (RenderPass): no checkerboard
    use_cb = attrs_setup and cfg.checkerboard and not extra_passes
    vs = None
    if not attrs_setup:
        with mark.pass_span("vertex stage"):
            vs = run_vertex_stage(
                scene, params["proj_view"], params["prev_proj_view"],
                params["light_proj_view"],
            )

    shadow_map, shadow_overflow = None, None
    if use_shadow and not (fast and shadow_quads is not None):
        with mark.pass_span("shadow"):
            shadow_map, shadow_overflow = shadow_map_from_clip(
                scene, cfg=cfg, binned_cap=binned_cap,
                shadow_clip=None if attrs_setup else vs.shadow_clip,
                light_pv=params["light_proj_view"],
            )

    with mark.pass_span("triangle setup"):
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
    with mark.pass_span("binning"):
        binned = _bin(setup, pad_w, pad_h, binned_cap)
    if megakernel:
        with mark.pass_span("vertex stage"):
            attr_rows = pack_raster_attr_rows(scene.tri_attrs,
                                              params["proj_view"])
        with mark.pass_span("raster"):
            tri, z, attrs, mat_plane, ht_plane = rasterize_attrs(
                binned, width=pad_w, height=pad_h, attr_rows=attr_rows)
        with mark.pass_span("G-buffer"):
            gbuf = gbuffer_pass_from_planes(tri, z, attrs, mat_plane,
                                            ht_plane, scene, params, slot_map)
    elif not fast:
        with mark.pass_span("raster"):
            tri, z, b0, b1 = rasterize(binned, width=pad_w, height=pad_h)
        with mark.pass_span("G-buffer"):
            gbuf = gbuffer_pass(tri, z, b0, b1, scene, vs)
    else:
        with mark.pass_span("raster"):
            tri, z, _, _ = rasterize(binned, width=pad_w, height=pad_h,
                                     slim=True)
        tri_g, z_g = tri, z
        if use_cb:
            with mark.pass_span("decimate"):
                tri_g, z_g = decimate_cols(tri, "cb"), decimate_cols(z, "cb")
        with mark.pass_span("G-buffer"):
            gbuf = gbuffer_pass_fast(tri_g, z_g, scene, scene.tri_attrs,
                                     params, slot_map, cb=use_cb,
                                     full_wh=(pad_w, pad_h),
                                     plane_kernel=cfg.attrs_plane_kernel,
                                     stack_kernel=cfg.stack_plane_kernel)

    # SSAO on the full-resolution depth; ssao_res_divisor > 1 evaluates it
    # on the even grid, edge-padded to tile multiples exactly as the
    # reference does (the padded width enters the radius formula)
    half_ssao = cfg.ssao_enabled and cfg.ssao_res_divisor > 1
    with mark.pass_span("SSAO"):
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
            with mark.pass_span("shadow"):
                shadow_quads = _pcf_build(cfg)(shadow_map)
        with mark.pass_span("shading"):
            color = shading_pass_fast(
                gbuf, ssao, shadow_quads if use_shadow else None,
                cfg.shadow_map_size, scene.lights, n_lights, params, ibl=ibl,
                shadow_res_divisor=cfg.pcf_res_divisor,
                parent_mip_half_res=cfg.spec_parent_mip_half_res,
                mirror_half_res=cfg.spec_mirror_half_res,
                merged_trilinear=cfg.spec_merged_trilinear, cb=use_cb,
            )
    else:
        with mark.pass_span("shading"):
            color = shading_pass(gbuf, ssao, shadow_map, scene.lights,
                                 n_lights, params, ibl=ibl)
    ctx = {"color": color, "gbuffer": gbuf, "ssao": ssao}
    if extra_passes:
        with mark.pass_span("render passes"):
            for p in extra_passes:
                ctx = p.render(ctx)
    with mark.pass_span("present"):
        if use_cb:  # never with extra passes
            rgba = reconstruct_present(ctx["color"], tri)
        else:
            rgba = present_pass(ctx["color"])
    return (rgba[: cfg.height, : cfg.width],
            overflow_counts(binned.overflow, shadow_overflow))


class Renderer(torch.nn.Module):
    """Owns the packed scene and the IBL maps on ``device`` (the card
    unless the caller passes another) and renders the deferred frame.
    ``forward(world)`` is ``render_device``."""

    _OVERFLOW_LAG = 64

    def __init__(self, config: EngineConfig, device="cuda", extra_passes=()):
        super().__init__()
        # the shading path has small float32 products (the velocity and
        # shadow projections, SH9); TF32 would move them by far more than
        # an 8-bit LSB
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.config = config
        self.device = resolve_device(device)
        self.extra_passes = list(extra_passes)
        self.scene = None
        self.ibl = None
        self._pending_overflow = []
        # on a card: the captured frame and memoized shadow (_FrameGraph)
        # and the scene as they read it (_StagedScene)
        self._graph = None
        self._shadow_graph = None
        self._staged = None
        self._captures = 0  # frame graphs captured so far
        self._shadow_captures = 0  # shadow graphs captured so far
        # the frame graph's key (_graph_key), and the layout (_layout)
        # with the scene it was taken on
        self._key = None
        self._layout_value = self._layout_scene = None
        # the last camera block (_frame_params), its inputs' snapshot and
        # its light's bytes
        self._params_prev = self._params_fp = self._light_key = None
        # bumped by every full prepare: wrappers that bind what prepare
        # derives (TileShardedRenderer's band program) rebuild on a change
        self._prepare_count = 0
        self.pad_w = _round_up(config.width, config.tile_w)
        self.pad_h = _round_up(config.height, config.tile_h)

    # --- scene preparation ------------------------------------------------
    def prepare(self, world) -> None:
        with trace.span("prepare"):
            self._prepare(world)
        trace.count("prepares")

    def _prepare(self, world) -> None:
        self._world_generation = getattr(world, "generation", None)
        self._prepare_count += 1
        # the old scene's graphs and staged buffers go before the new pack
        self._graph = self._shadow_graph = self._staged = None
        self._layout_scene = None
        cfg = self.config
        with trace.span("pack_scene"):
            self.scene = pack_scene(world, cfg, self.device)
        ibl_res = world.get_resource(IBLResource)
        if ibl_res is not None:
            ibl_res.to(self.device)  # raises if computed on another device
            ibl_res.ensure_computed()
        self.ibl = ibl_res
        if cfg.binned_cap is not None:
            self._binned_cap = _round_up(cfg.binned_cap, 8)
        else:
            # the reference's static capacity (frame_graph.py:481-511),
            # over the larger of the frame's and the shadow map's tilings
            # in the port's own bins
            smap = cfg.shadow_map_size
            n_tiles = max(
                -(-self.pad_w // BIN_W) * -(-self.pad_h // BIN_H),
                -(-smap // BIN_W) * -(-smap // BIN_H),
            )
            self._binned_cap = pair_capacity(
                int(self.scene.indices.shape[0]), n_tiles)
        # the texture-stack fast path samples every slot with UV set 0;
        # a scene whose materials sample UV set 1 takes the reference
        # sampling path (frame_graph.py:512-524)
        uses_uv1 = bool(self.scene.materials[:, 5:10].any())
        self._fast = cfg.fast_sampling and not uses_uv1
        if cfg.fast_sampling and uses_uv1:
            logger.info("scene uses UV set 1: reference sampling path")
        self._n_lights = int(self.scene.num_lights)
        self._slot_map = tuple(int(x) for x in self.scene.stack_slots.tolist())
        self._shadow_key = None
        self._shadow_scene = None
        self._shadow_quads = None
        self._params_prev = None
        self._params_fp = None
        self._pending_overflow = []
        logger.info(
            "renderer prepared on %s: %d tris, fb %dx%d (pad %dx%d)",
            self.device, int(self.scene.indices.shape[0]), cfg.width,
            cfg.height, self.pad_w, self.pad_h,
        )

    def resize(self, width: int, height: int) -> None:
        """A new framebuffer size (frame_graph.py:636).  The packed scene,
        the IBL maps and the memoized shadow table do not depend on it and
        are kept; ``frame_program`` reads the size on every call, and the
        captured frame keys on it (the next frame captures once; the
        shadow graph is kept).  Each extra pass hears of the new size
        (``on_swapchain_recreate``)."""
        self.config = dataclasses.replace(self.config, width=width,
                                          height=height)
        self.pad_w = _round_up(width, self.config.tile_w)
        self.pad_h = _round_up(height, self.config.tile_h)
        for p in self.extra_passes:
            p.on_swapchain_recreate((width, height))
        logger.info("renderer resized: fb %dx%d (pad %dx%d)", width, height,
                    self.pad_w, self.pad_h)

    # --- overflow surfacing -------------------------------------------------
    def _note_overflow(self, ovf) -> None:
        self._pending_overflow.append(ovf)
        if len(self._pending_overflow) > self._OVERFLOW_LAG:
            self._drain_lagging()

    def _drain_lagging(self) -> None:
        """Past the lag window: read the oldest counts (a frame that has
        long finished, so no stall) and raise if it dropped geometry."""
        while len(self._pending_overflow) > self._OVERFLOW_LAG:
            self._raise_if_overflow(self._pending_overflow.pop(0))

    @staticmethod
    def _counts(ovf) -> list:
        """[G-buffer, shadow] of one pending (2,) counts tensor (one
        read), or of the drained host array."""
        return ovf.tolist()

    def _raise_if_overflow(self, ovf) -> None:
        g, s = self._counts(ovf)
        if g or s:
            raise RuntimeError(
                f"rasterizer bin overflow: {g} G-buffer and {s} shadow "
                f"(tile, triangle) pairs dropped — geometry is missing from "
                f"the frame.  Raise EngineConfig.binned_cap (current "
                f"{self._binned_cap}) and re-prepare."
            )

    def stage_overflow(self) -> None:
        """Non-blocking copies of the pending device counts into
        page-locked host memory, in place of them in the pending list, on
        the current stream.  Call it just before the frame's fetch
        (``unpack_rgba8`` of a card's frame), whose one wait on that stream
        covers these copies too; the drain after the fetch then reads host
        integers.  Drain only after such a wait."""
        pending = self._pending_overflow
        for i, v in enumerate(pending):
            if v.is_cuda:
                host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                pending[i] = host.copy_(v, non_blocking=True)

    def drain_overflow(self) -> np.ndarray:
        """Every pending overflow count summed and emptied: (G-buffer,
        shadow) dropped pairs as a (2,) int64 host array."""
        total = np.zeros(2, np.int64)
        while self._pending_overflow:
            total += self._counts(self._pending_overflow.pop(0))
        return total

    def check_overflow(self) -> None:
        """Drain all pending overflow counts; raises if any frame dropped
        geometry."""
        self._raise_if_overflow(self.drain_overflow())

    # --- per-frame host side ------------------------------------------------
    def _cached_shadow_quads(self, key_pv, light_pv, has_light):
        """Shadow table memoized on (light matrix bytes, scene object):
        the scene half is an identity check against a STRONG reference,
        so a recycled address can never match a stale table.  On a card
        a recompute replays the shadow graph (``_capture_shadow``) into
        the table the frame graph reads; elsewhere it runs
        ``shadow_program``.  ``key_pv`` is the light matrix on the host,
        ``light_pv`` the one a recompute reads."""
        return self._shadow_memo(np.asarray(key_pv, np.float32).tobytes(),
                                 lambda: light_pv, has_light)

    def _shadow_memo(self, key, light, has_light):
        """``_cached_shadow_quads`` keyed on ``key``, the light matrix's
        float32 bytes; ``light()`` gives the matrix a recompute reads,
        asked for only then."""
        cfg = self.config
        if not (self._fast and has_light and cfg.shadow_enabled
                and cfg.shadow_cache):
            return None
        with trace.span("shadow_memo"):
            if key != self._shadow_key or self._shadow_scene is not self.scene:
                with trace.span("shadow_replay"):
                    self._recompute_shadow(light())
                self._shadow_key = key
                self._shadow_scene = self.scene
        return self._shadow_quads

    def _recompute_shadow(self, light_pv) -> None:
        if self.device.type == "cuda":
            graph = self._capture_shadow(light_pv)
            graph.replay(light_pv)
            self._shadow_quads = graph.out
            self._note_overflow(graph.overflow.clone())
        else:
            self._shadow_quads, ovf = shadow_program(
                self.scene, light_pv, cfg=self.config,
                binned_cap=self._binned_cap
            )
            self._note_overflow(overflow_counts(shadow=ovf))

    def _sync_topology(self, world) -> None:
        """Bring the packed scene up to date with a spawn or despawn after
        prepare (the reference's ``_sync_topology``, frame_graph.py:686):
        ``incremental_repack`` rewrites the changed rows of the padded
        tables in place; what the static layout cannot absorb (new texture
        content, a capacity overflow, a light-count change, a UV1 material
        on the fast path) falls back to a full ``prepare``."""
        with trace.span("sync_topology"):
            gen = getattr(world, "generation", None)
            if gen is None or gen == self._world_generation:
                return
            with trace.span("repack"):
                new_scene = incremental_repack(self.scene, world, self.config,
                                               forbid_uv1=self._fast)
            if new_scene is None:
                logger.info("world topology changed (generation %s -> %s): "
                            "full re-prepare", self._world_generation, gen)
                self.prepare(world)
                return
            logger.info("world topology changed (generation %s -> %s): "
                        "incremental repack", self._world_generation, gen)
            self.scene = new_scene
            self._world_generation = gen

    def _refresh_transforms(self) -> None:
        """Re-bake the entities' transforms if one moved
        (``refresh_transforms``), and rewrite the light rows in place if a
        light moved or changed (``refresh_lights``).  A bake replaces
        ``mesh_world``, ``mesh_normal_mat`` and ``tri_attrs`` with tensors
        of the same shapes, so the layout taken on the old scene holds for
        the new one (``_layout``)."""
        refresh_lights(self.scene)
        scene = refresh_transforms(self.scene)
        if scene is not self.scene and self._layout_scene is self.scene:
            self._layout_scene = scene
        self.scene = scene

    def frame_params(self, world):
        with trace.span("frame_params"):
            return self._frame_params(world)

    def _frame_params(self, world):
        """(the frame's CameraParams, whether a light casts the shadow).
        The block is built again (``camera_block_builds``) only when one of
        its inputs changed since the last build: the camera's translation,
        rotation, view, previous view, projection, near plane, field of
        view and aspect, and the light's matrix, each compared by its
        bytes (the light's float32 bytes, ``_light_key``, key the shadow
        memo too).  A build writes the block into a new host vector,
        page-locked for a card (``CameraParams.src``), which the captured
        frame's input copies without blocking; a block still being copied
        is never written, since the caching host allocator hands its
        memory out again only after the copies that read it."""
        camera: Camera = world.resource(Camera)
        light_pv, has_light = find_shadow_light(world)
        light_key = np.asarray(light_pv, np.float32).tobytes()
        fp = (
            np.asarray(camera.transform.translation).tobytes(),
            np.asarray(camera.transform.rotation).tobytes(),
            camera.view().tobytes(), camera.prev_view().tobytes(),
            camera.projection().tobytes(), light_key,
            camera.near_p(), camera.fov(), camera.aspect(),
        )
        if fp == self._params_fp:
            return self._params_prev, has_light
        src = torch.empty(CameraParams.SIZE, dtype=torch.float32,
                          pin_memory=self.device.type == "cuda")
        host = src.numpy()
        _write_camera_block(host, camera, light_pv)
        trace.count("camera_block_builds")
        self._params_prev = CameraParams(None, host=host, src=src,
                                         device=self.device)
        self._params_fp, self._light_key = fp, light_key
        return self._params_prev, has_light

    def _frame_inputs(self, world):
        """The host side of a frame before it runs: the topology, the
        transforms, the camera block and the shadow memo, each a check that
        rebuilds only what changed.  Returns (CameraParams, the memoized
        shadow table or None, has_light)."""
        self._sync_topology(world)
        with trace.span("refresh_transforms"):
            self._refresh_transforms()
        params, has_light = self.frame_params(world)
        quads = self._shadow_memo(
            self._light_key, lambda: params.src_field("light_proj_view"),
            has_light)
        return params, quads, has_light

    def _frame(self, params, quads, has_light, scene=None):
        """``frame_program`` on the prepared scene (or ``scene``, the
        staged one a graph reads): (rgba, (2,) dropped-pair counts)."""
        ibl_maps = self.ibl.maps() if self.ibl is not None else None
        return frame_program(
            self.scene if scene is None else scene, ibl_maps, params,
            cfg=self.config, pad_w=self.pad_w, pad_h=self.pad_h,
            binned_cap=self._binned_cap, has_shadow_light=has_light,
            slot_map=self._slot_map, n_lights=self._n_lights,
            fast=self._fast, shadow_quads=quads,
            extra_passes=self.extra_passes,
        )

    def render_device(self, world):
        """One frame left on the device: (H, W) int32 packed rgba8 bits.

        The host side (topology, transforms, camera params, the shadow
        memo) runs first, each step a check of what it last saw that
        rebuilds only what changed.  On a card the frame is then staging
        copies (the camera block one non-blocking copy from page-locked
        memory into the graph's input) and one replay of the captured
        frame (``_capture``), and the result is
        a clone of the graph's output, so a frame the caller keeps is not
        overwritten by the next; its dropped-pair counts stay on the
        device until the lag window reads them.  Elsewhere
        ``frame_program`` runs eagerly."""
        with trace.span("render_device"):
            params, quads, has_light = self._frame_inputs(world)
            if not self._fast:
                trace.count("reference_frames")
            if self.device.type != "cuda":
                with trace.span("eager_frame"):
                    rgba, overflow = self._frame(params, quads, has_light)
                with trace.span("note_overflow"):
                    self._note_overflow(overflow)
                return rgba
            graph = self._capture(params.src, quads, has_light)
            with trace.span("replay"):
                graph.replay(params.src)
            with trace.span("note_overflow"):
                self._note_overflow(graph.overflow.clone())
            return graph.out.clone()

    # --- camera-path sequences ----------------------------------------------
    def _sequence_shadow(self, world, params_list):
        """(memoized shadow table or None, has_light) for frames whose
        params are ``params_list``: the memo only when every step's light
        matrix has the bytes of the world's light (frame_graph.py:790-804);
        otherwise each step rasterizes its own shadow."""
        light_pv, has_light = find_shadow_light(world)
        lpv = np.asarray(light_pv, np.float32).reshape(-1)
        same_light = all(
            p.host is not None and np.array_equal(p.host[32:48], lpv)
            for p in params_list
        )
        if not same_light:
            return None, has_light
        return self._cached_shadow_quads(
            lpv, params_list[0]["light_proj_view"], has_light), has_light

    def render_sequence_device(self, world, params_list):
        """K frames of a camera path, left on the device as (K, H, W) int32
        packed rgba8 bits (frame_graph.py:768).  The scene is fixed over
        the sequence (one topology sync and one transform refresh up
        front); each step is the whole frame, its shadow included unless
        every step has the world's light (then the memoized table).

        ``params_list``: per-step ``CameraParams`` (``build_camera_params``).
        On a card the captured frame of ``render_device`` (same key, same
        graph) is replayed per step (see ``_render_params``); frames equal
        ``render_device``'s bit for bit."""
        self._sync_topology(world)
        self._refresh_transforms()
        quads, has_light = self._sequence_shadow(world, params_list)
        frames, overflow = self._render_params(stack_params(params_list),
                                               quads, has_light)
        self._note_overflow(overflow)
        return frames

    def _render_params(self, stack, quads, has_light):
        """Frames of the prepared scene for the (N, 64) ``stack`` of camera
        params (``stack_params``): (frames (N, H, W), dropped pairs).

        On a card: per step, a device copy of the step's params into the
        captured frame's input (``_capture``: the graph of
        ``render_device``, shared), one replay, a copy of its output into
        ``frames[i]``, and its counts added up on the device.  Elsewhere:
        a loop over ``frame_program``."""
        n = stack.vec.shape[0]
        if not self._fast:
            trace.count("reference_frames", n)
        if self.device.type != "cuda":
            frames, counts = zip(*(
                self._frame(CameraParams(stack.vec[i], stack.host[i]), quads,
                            has_light) for i in range(n)))
            return torch.stack(frames), torch.stack(counts).sum(0)
        steps = stack.vec.to(self.device)
        graph = self._capture(steps[0], quads, has_light)
        with trace.span("replay"):
            frames = torch.empty((n, self.config.height, self.config.width),
                                 dtype=torch.int32, device=self.device)
            total = torch.zeros(2, dtype=torch.int64, device=self.device)
            for i in range(n):
                graph.replay(steps[i])
                frames[i].copy_(graph.out)  # the next replay overwrites it
                total += graph.overflow
        return frames, total

    # --- captured programs (on a card) ----------------------------------
    def _layout(self):
        """What a captured program's shapes hang on: the prepare that
        packed the scene, and the shape and dtype of every scene field.
        No object's identity: a move, a spawn or a despawn keeps its value.
        Taken again only on a scene it was not taken on (a prepare, a
        repack; a bake carries it over, ``_refresh_transforms``), and the
        tuple taken before is kept while the value is the same, so a
        caller may check it by identity."""
        if self._layout_scene is not self.scene:
            layout = (self._prepare_count, tuple(
                (name, tuple(t.shape), t.dtype)
                for name, t in _scene_fields(self.scene)))
            if layout != self._layout_value:
                self._layout_value = layout
            self._layout_scene = self.scene
        return self._layout_value

    def _graph_key(self, has_light, quads):
        """The captured frame's key: the layout, the pad size, the config
        (its values), the light, whether the shadow is memoized (``quads``
        given) or rastered in the frame, the IBL maps and the extra
        passes, and whether the tracer is on (its graph holds the pass
        markers).  A new camera, entity transform, light matrix, spawn or
        despawn keeps its value; a resize, a full prepare, a light that
        appears or goes, an extra pass, another shadow mode or the tracer
        switched changes it.  The key is one tuple, built again
        (``graph_key_builds``) only when the layout is another object or
        another part differs, so a frame that changes none of them checks
        it by identity and a few scalar comparisons."""
        ibl_maps = self.ibl.maps() if self.ibl is not None else None
        layout = self._layout()
        parts = (self.pad_w, self.pad_h, tuple(vars(self.config).values()),
                 has_light, quads is not None, id(ibl_maps),
                 tuple(map(id, self.extra_passes)), trace.enabled())
        if (self._key is None or self._key[0] is not layout
                or self._key[1:] != parts):
            self._key = (layout,) + parts
            trace.count("graph_key_builds")
        return self._key

    def _staged_scene(self):
        """The scene as the captured programs read it, staged from
        ``self.scene`` (``_StagedScene``; a layout of another value stages
        anew)."""
        key = self._layout()
        if self._staged is None or self._staged.key != key:
            self._staged = _StagedScene(key, self.scene)
        self._staged.stage(self.scene)
        return self._staged.scene

    def _capture(self, params, quads, has_light):
        """The captured frame for the current key (``_graph_key``), with
        the scene staged: the first call with a key captures (after
        freeing the old graph), later calls reuse it.  ``params`` is the
        first frame's (64,) vector (``CameraParams.src``: on the device,
        or page-locked on the host), ``quads`` the memoized
        table or None.  The table is the shadow graph's output, which the
        frame reads in place: a new shadow graph drops the frame graph
        (``_capture_shadow``)."""
        with trace.span("graph_lookup"):
            return self._lookup(params, quads, has_light)

    def _lookup(self, params, quads, has_light):
        key = self._graph_key(has_light, quads)
        scene = self._staged_scene()
        if self._graph is not None and self._graph.key == key:
            return self._graph
        self._graph = None  # free the old graph's memory first
        ibl_maps = self.ibl.maps() if self.ibl is not None else None

        def frame(p):
            return self._frame(CameraParams(p), quads, has_light,
                               scene=scene)

        self._graph = _FrameGraph(
            key, self.device, frame, params,
            refs=(ibl_maps, tuple(self.extra_passes), quads))
        self._captures += 1
        return self._graph

    def _capture_shadow(self, light_pv):
        """The memoized shadow's graph (the reference's ``_shadow_fn``):
        ``shadow_program`` on the staged scene, the (4, 4) light matrix its
        input.  Keyed on the layout, the config but its size (a resize
        keeps it) and whether the tracer is on."""
        cfg = self.config
        key = (self._layout(), dataclasses.astuple(
            dataclasses.replace(cfg, width=0, height=0)), trace.enabled())
        scene = self._staged_scene()
        if self._shadow_graph is not None and self._shadow_graph.key == key:
            return self._shadow_graph
        self._shadow_graph = self._graph = None  # the frame reads its table
        cap = self._binned_cap

        def shadow(light):
            table, ovf = shadow_program(scene, light, cfg=cfg,
                                        binned_cap=cap)
            return table, overflow_counts(shadow=ovf)

        self._shadow_graph = _FrameGraph(key, self.device, shadow, light_pv,
                                         name="shadow")
        self._shadow_captures += 1
        return self._shadow_graph

    forward = render_device

    def render(self, world) -> np.ndarray:
        """One frame fetched to the host as (H, W, 4) uint8 rgba.  On a
        card the frame's dropped-pair counts are copied to the host
        without blocking (``stage_overflow``) before the frame's own copy
        (``unpack_rgba8``), whose one wait finishes both; the check after
        it reads host integers and raises on this frame, as before."""
        packed = self.render_device(world)
        with trace.span("fetch"):
            self.stage_overflow()
            frame = unpack_rgba8(packed)
        with trace.span("check_overflow"):
            self.check_overflow()
        return frame


# The SceneBuffers fields that a frame-to-frame update replaces with new
# tensors: a moved entity (refresh_transforms) brings a new mesh_world and
# mesh_normal_mat, and a move or a spawn (refresh_tri_attrs) a new
# tri_attrs.  A captured program reads its own copies of these.  Every
# other field keeps its tensor from one prepare to the next:
# incremental_repack writes the rows of the vertex, triangle, mesh,
# material and light tables in place (_write_rows, also into the current
# mesh_world and mesh_normal_mat, which staging sees by their version),
# and nothing writes the textures, the stacks or the light count, so a
# captured program reads them where they are.
STAGED_FIELDS = ("mesh_world", "mesh_normal_mat", "tri_attrs")


def _scene_fields(scene):
    """(name, tensor) of every SceneBuffers field."""
    return [(f.name, getattr(scene, f.name))
            for f in dataclasses.fields(scene)]


class _Staged:
    """An input buffer a captured program reads (``buf``, on ``device``,
    by default the source's), filled by a copy from the tensor a call
    hands it when that is not the tensor copied last, or is but was
    written in place since (its version counter moved).  The copy does
    not block: from another device tensor or from page-locked host memory
    it runs in stream order, before the replay that reads it."""

    def __init__(self, src, device=None):
        self.buf = torch.empty_like(src, device=device)
        self.buf.copy_(src, non_blocking=True)
        self.src, self.version = src, src._version

    def stage(self, src) -> None:
        if src is self.src and src._version == self.version:
            return
        self.buf.copy_(src, non_blocking=True)
        self.src, self.version = src, src._version


class _StagedScene:
    """The scene as the captured programs read it: ``STAGED_FIELDS`` in
    buffers of its own (``_Staged``), every other field the scene's own
    tensor.  ``key`` is the layout it was staged for."""

    def __init__(self, key, scene):
        self.key = key
        self.staged = {name: _Staged(getattr(scene, name))
                       for name in STAGED_FIELDS}
        self.scene = dataclasses.replace(
            scene, **{name: st.buf for name, st in self.staged.items()})
        self._last = scene  # the scene staged last

    def stage(self, scene) -> None:
        """Stage ``STAGED_FIELDS`` (each by its tensor and version); on a
        scene other than the one staged last, also check that every other
        field is still the tensor the programs read."""
        for name, st in self.staged.items():
            st.stage(getattr(scene, name))
        if scene is self._last:
            return
        for name, t in _scene_fields(scene):
            if name not in self.staged and t is not getattr(self.scene, name):
                raise RuntimeError(
                    f"scene field {name} was replaced without a prepare; "
                    f"a captured frame reads it in place (only "
                    f"{', '.join(STAGED_FIELDS)} are staged)")
        self._last = scene


class _FrameGraph:
    """One program (a Renderer's frame or memoized shadow, or the
    row-sharded frame) captured in a ``torch.cuda.CUDAGraph`` under
    ``key``.

    ``fn(buf)`` returns (output, (2,) dropped-pair counts); ``buf`` is the
    program's own input on ``device`` (the camera params or the light
    matrix, ``_Staged``), filled at each ``replay`` from the tensor it is
    handed, on the device or in page-locked host memory.  ``out`` is the
    output and ``overflow`` this replay's counts, both overwritten by the
    next replay.  The program runs once eagerly on a side stream first, as
    capture requires (it builds the kernel library, fills the per-device
    table caches and meets any collective once).  The kernel wrappers
    count their launches while the graph is captured, which launches
    nothing: those counts are taken back, and each replay adds them
    (``launches``) instead.  ``refs`` keeps what the key names by
    identity alive.  ``name`` is the program's pass in ``mark.PASSES``:
    with the tracer on, the graph opens and closes with its markers."""

    def __init__(self, key, device, fn, first, refs=(), name="frame"):
        self.key = key
        self.refs = refs
        self.input = _Staged(first, device)
        self.overflow = torch.zeros(2, dtype=torch.int64, device=device)

        def run():
            with mark.pass_span(name):
                out, counts = fn(self.input.buf)
                self.overflow.copy_(counts)
            return out

        with trace.span("capture"):
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                run()
            torch.cuda.current_stream(device).wait_stream(side)
            before = dict(_build.LAUNCHES)
            self.graph = torch.cuda.CUDAGraph()
            # no automatic collection inside the capture (the graph's entry
            # collects first): a cycle freed there may hold another
            # renderer's graph, whose destruction invalidates the capture
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(self.graph):
                    self.out = run()
            finally:
                if collecting:
                    gc.enable()
        self.launches = {k: v - before[k] for k, v in _build.LAUNCHES.items()
                         if v != before[k]}
        _build.LAUNCHES.update(before)
        logger.info("captured in a CUDA graph: %s launches", self.launches)

    def replay(self, src) -> None:
        self.input.stage(src)
        self.graph.replay()
        for name, n in self.launches.items():
            _build.count(name, n)
