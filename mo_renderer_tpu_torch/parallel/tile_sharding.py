"""One frame's rows sharded over the ranks of a process group (port of
``mo_renderer_tpu/parallel/tile_sharding.py``).

Each rank renders one horizontal band of the padded framebuffer:

- the scene, the IBL maps and the camera are the same on every rank, and
  triangle setup runs on each (it is T-sized);
- binning is band-local: each rank lists only the (tile, triangle) pairs
  of its own bin rows (``bin_triangles(band_row0=...)``), with global tile
  ids, so its runs are those of the whole frame's bins in its band;
- the band raster (``rasterize(tile_row_offset=...)``, K1b), the G-buffer
  (``y0``), SSAO and the sky rays (``row_offset`` / ``full_height``) keep
  every pixel's row in the whole frame;
- SSAO's depth neighbourhood is the one dependency between bands: each
  rank gathers its neighbours' ``ssao_halo_rows`` edge rows (one
  ``all_gather``) and hands them to the band kernel (``y_halo``, K4b); the
  outermost bands replicate their edge row, as the whole-image pass does;
- the shadow map (light space, unrelated to screen rows) is rastered in
  bands too when the map splits into whole bins per rank (K2b, then one
  ``all_gather`` of the map), else on every rank whole;
- the bands are gathered into the whole frame on every rank, and so are
  the bands' (2,) dropped-pair counts, summed on the device (the
  reference's ``overflow.reshape(-1, 2).sum(axis=0)``), so no count is
  read on the host until the lag window drains it.

Binning fills the inner Renderer's static pair capacity, so nothing
reads the device on the host: on a card the whole frame, collectives
included, is captured in a CUDA graph keyed on the layout, as the
single-device frame is, and replayed per frame; on the CPU (gloo) it
runs eagerly.

What differs from the single-device frame (the tests hold both): the
half-resolution upsamplers and the checkerboard reconstruction interpolate
within a band, so at most two rows per band border blend toward an edge
sample.  SSAO runs at full rate (its halo is sized for it): a config with
``ssao_res_divisor > 1`` or ``ssao_pallas=False`` raises instead of being
ignored, and so do the reference sampling path and the raster megakernel.
"""

from __future__ import annotations

import functools
import logging
import math

import torch
import torch.distributed as dist

from ..config import EngineConfig
from ..kernels.decimate import decimate_cols
from ..kernels.raster_setup import bin_triangles, triangle_setup_from_attrs
from ..kernels.rasterizer import BIN_H, BIN_W, rasterize
from ..passes.checkerboard import reconstruct_present
from ..passes.frame_graph import (
    CameraParams,
    Renderer,
    _FrameGraph,
    _pcf_build,
    overflow_counts,
    shadow_program,
)
from ..passes.gbuffer import gbuffer_pass_fast
from ..passes.present import present_pass, unpack_rgba8
from ..passes.shading import shading_pass_fast
from ..passes.ssao import TILE_H as SSAO_TILE_H
from ..passes.ssao import ssao_halo_rows, ssao_pass_tiles
from .multi_view import RankGroup

logger = logging.getLogger("mo_renderer_tpu_torch")


def _check_config(cfg: EngineConfig) -> None:
    """The options the row-sharded frame does not run raise, each by name
    (the reference ignores the SSAO ones, tile_sharding.py:234-262)."""
    if cfg.ssao_enabled and cfg.ssao_res_divisor > 1:
        raise ValueError(
            f"row sharding runs SSAO at full rate: ssao_res_divisor="
            f"{cfg.ssao_res_divisor} is not supported (set it to 1)"
        )
    if cfg.ssao_enabled and not cfg.ssao_pallas:
        raise ValueError(
            "row sharding runs SSAO through the band kernel: ssao_pallas="
            "False is not supported"
        )
    if not cfg.fast_sampling:
        raise ValueError(
            "row sharding requires the fast sampling path: fast_sampling="
            "False (the reference sampling path) is not supported"
        )
    if cfg.raster_interp_attrs:
        raise ValueError(
            "row sharding does not support the raster megakernel: "
            "raster_interp_attrs=True"
        )


def _all_gather(t, group: RankGroup):
    """Every rank's ``t`` (same shape on every rank), in rank order."""
    parts = [torch.empty_like(t) for _ in range(group.size)]
    dist.all_gather(parts, t.contiguous(), group=group.group)
    return parts


def band_rows(cfg: EngineConfig, n_ranks: int) -> int:
    """What the split height is a multiple of: ``n_ranks`` bands, each a
    whole number of framebuffer tiles, raster bins and SSAO tiles."""
    return n_ranks * math.lcm(cfg.tile_h, BIN_H, SSAO_TILE_H)


def shadow_bands_divisible(cfg: EngineConfig, n_ranks: int) -> bool:
    """The shadow map splits into whole bin rows per rank."""
    return cfg.shadow_map_size % (n_ranks * BIN_H) == 0


def _shadow_quads_banded(scene, light_pv, cfg, binned_cap, group: RankGroup):
    """The shadow map in light-space bands: each rank bins and rasters
    ``shadow_map_size / n`` rows (K2b), one ``all_gather`` puts the whole
    map on every rank (any pixel may sample any texel), then the PCF
    table.  Equal to the whole map's raster bit for bit: the bands
    partition the bins and the depth rule is per pixel.  Returns (table,
    this rank's dropped pair count)."""
    smap = cfg.shadow_map_size
    setup = triangle_setup_from_attrs(
        scene.tri_attrs, scene.tri_valid, light_pv, smap, smap,
        cull_backface=False,
        depth_bias_const=cfg.shadow_depth_bias_const,
        depth_bias_slope=cfg.shadow_depth_bias_slope,
    )
    bins_per_band = smap // BIN_H // group.size
    row0 = group.rank * bins_per_band
    binned = bin_triangles(
        setup, tile_h=BIN_H, tile_w=BIN_W, n_tiles_x=-(-smap // BIN_W),
        n_tiles_y=smap // BIN_H, binned_cap=binned_cap,
        band_row0=row0, band_tile_rows=bins_per_band,
    )
    _, band, _, _ = rasterize(binned, width=smap, height=smap // group.size,
                              depth_only=True, tile_row_offset=row0)
    shadow_map = torch.cat(_all_gather(band, group))
    return _pcf_build(cfg)(shadow_map), binned.overflow


def _ssao_halo(z, n_rows, group: RankGroup):
    """(top, bottom): the ``n_rows`` depth rows above and below this
    rank's band, from its neighbours; the outermost bands replicate their
    own edge row.  One ``all_gather`` of every band's first and last rows
    (the reference's two ``ppermute``s, tile_sharding.py:238-255)."""
    edges = _all_gather(torch.stack([z[:n_rows], z[-n_rows:]]), group)
    r = group.rank
    top = (edges[r - 1][1] if r > 0
           else z[:1].expand(n_rows, -1).contiguous())
    bottom = (edges[r + 1][0] if r < group.size - 1
              else z[-1:].expand(n_rows, -1).contiguous())
    return top, bottom


def row_sharded_frame_body(scene, ibl, params, *, cfg, pad_w, pad_h,
                           pad_h_split, binned_cap, has_shadow_light,
                           slot_map, n_lights, group: RankGroup):
    """This rank's band of the frame: rows ``rank * h`` to ``(rank + 1) *
    h`` of the ``pad_h_split``-row split canvas, ``h = pad_h_split / n``.

    ``pad_h`` is the viewport height, as in the single-device frame, so
    the image is the same; the rows from ``pad_h`` to ``pad_h_split`` have
    no triangle, render sky and are cropped away.  Returns (rgba (h,
    pad_w) int32 packed rgba8 bits, (G-buffer, shadow) dropped pairs of
    this rank's bands as a (2,) int64 tensor)."""
    if pad_h_split % band_rows(cfg, group.size):
        raise ValueError(f"split height {pad_h_split} is not a multiple of "
                         f"{band_rows(cfg, group.size)}")
    h_local = pad_h_split // group.size
    row0 = group.rank * h_local
    bin_row0 = row0 // BIN_H

    shadow_quads, shadow_overflow = None, None
    if cfg.shadow_enabled and has_shadow_light:
        if shadow_bands_divisible(cfg, group.size):
            shadow_quads, shadow_overflow = _shadow_quads_banded(
                scene, params["light_proj_view"], cfg, binned_cap, group)
        else:  # the whole map on every rank
            shadow_quads, shadow_overflow = shadow_program(
                scene, params["light_proj_view"], cfg=cfg,
                binned_cap=binned_cap)

    setup = triangle_setup_from_attrs(
        scene.tri_attrs, scene.tri_valid, params["proj_view"], pad_w, pad_h,
        cull_backface=True,
    )
    # the run table covers the split canvas: its rows past pad_h are empty
    binned = bin_triangles(
        setup, tile_h=BIN_H, tile_w=BIN_W, n_tiles_x=-(-pad_w // BIN_W),
        n_tiles_y=pad_h_split // BIN_H, binned_cap=binned_cap,
        band_row0=bin_row0, band_tile_rows=h_local // BIN_H,
    )
    tri, z, _, _ = rasterize(binned, width=pad_w, height=h_local, slim=True,
                             tile_row_offset=bin_row0)
    # bands start on even rows, so a band's row parity is the frame's
    # checkerboard phase and the band-local decimate is the frame's
    use_cb = cfg.checkerboard
    tri_g, z_g = tri, z
    if use_cb:
        tri_g, z_g = decimate_cols(tri, "cb"), decimate_cols(z, "cb")
    gbuf = gbuffer_pass_fast(tri_g, z_g, scene, scene.tri_attrs, params,
                             slot_map, cb=use_cb, full_wh=(pad_w, pad_h),
                             plane_kernel=cfg.attrs_plane_kernel,
                             stack_kernel=cfg.stack_plane_kernel, y0=row0)

    if cfg.ssao_enabled:
        ssao = ssao_pass_tiles(
            z, near=cfg.ssao_near, far=cfg.ssao_far, row_offset=row0,
            y_halo=_ssao_halo(z, ssao_halo_rows(pad_w), group),
        )
        if use_cb:
            ssao = decimate_cols(ssao, "cb")
    else:
        ssao = torch.ones_like(gbuf.depth)

    color = shading_pass_fast(
        gbuf, ssao, shadow_quads, cfg.shadow_map_size, scene.lights,
        n_lights, params, ibl=ibl, shadow_res_divisor=cfg.pcf_res_divisor,
        parent_mip_half_res=cfg.spec_parent_mip_half_res,
        mirror_half_res=cfg.spec_mirror_half_res,
        merged_trilinear=cfg.spec_merged_trilinear, cb=use_cb,
        row_offset=row0, full_height=pad_h,
    )
    rgba = reconstruct_present(color, tri) if use_cb else present_pass(color)
    return rgba, overflow_counts(binned.overflow, shadow_overflow)


class TileShardedRenderer:
    """Renders ONE frame with its rows sharded over the ranks of
    ``group`` (tile_sharding.py:284): every rank calls ``render`` with
    the same world and gets the whole frame.  Scene preparation is the
    single-device Renderer's, on ``device`` (the rank's card unless the
    caller passes another)."""

    def __init__(self, config: EngineConfig, group: RankGroup,
                 device="cuda"):
        _check_config(config)
        self.config = config
        self.group = group
        self._inner = Renderer(config, device)
        self._frame_fn = None
        self._prepared_at = None
        self._graph = None  # the captured sharded frame (on a card)
        self._captures = 0

    @property
    def scene(self):
        return self._inner.scene

    @property
    def ibl(self):
        return self._inner.ibl

    def prepare(self, world) -> None:
        self._inner.prepare(world)
        self._rebuild_frame_fn()
        logger.info("tile-sharded renderer: %d rows in %d bands",
                    self._pad_h_split, self.group.size)

    def resize(self, width: int, height: int) -> None:
        """A new framebuffer size: the inner Renderer's ``resize``, then
        the band program for the new split (the next frame on a card
        captures once)."""
        self._inner.resize(width, height)
        self.config = self._inner.config
        self._rebuild_frame_fn()

    def _rebuild_frame_fn(self) -> None:
        """Check the prepared scene's path and bind the band program; run
        again after a full re-prepare (a topology change may flip the
        path) or a resize.  An incremental repack changes table contents
        only, and keeps the program."""
        inner, cfg = self._inner, self.config
        self._prepared_at = inner._prepare_count
        if not inner._fast:
            raise ValueError(
                "row sharding requires the fast sampling path: this scene "
                "samples UV set 1 (the reference sampling path)"
            )
        step = band_rows(cfg, self.group.size)
        self._pad_h_split = -(-inner.pad_h // step) * step
        halo = ssao_halo_rows(inner.pad_w)
        h_band = self._pad_h_split // self.group.size
        if cfg.ssao_enabled and h_band < halo:
            raise ValueError(f"row sharding: a band of {h_band} rows is "
                             f"shorter than SSAO's {halo} halo rows")
        self._frame_fn = functools.partial(
            row_sharded_frame_body, cfg=cfg, pad_w=inner.pad_w,
            pad_h=inner.pad_h, pad_h_split=self._pad_h_split,
            binned_cap=inner._binned_cap, slot_map=inner._slot_map,
            n_lights=inner._n_lights, group=self.group,
        )

    def _frame(self, params, has_light, scene=None):
        """The whole frame on every rank: this rank's band, one
        ``all_gather`` of the bands and one of their (2,) dropped-pair
        counts, summed on the device.  Returns (rgba (H, W), (2,) int64
        counts).  ``scene``: the staged scene a graph reads (default: the
        prepared one)."""
        inner = self._inner
        ibl_maps = self.ibl.maps() if self.ibl is not None else None
        band, counts = self._frame_fn(
            inner.scene if scene is None else scene, ibl_maps, params,
            has_shadow_light=has_light)
        full = torch.cat(_all_gather(band, self.group))
        total = torch.stack(_all_gather(counts, self.group)).sum(0)
        return full[: self.config.height, : self.config.width], total

    def _capture(self, params, has_light):
        """The captured sharded frame for the inner Renderer's layout key
        and this split, with the scene staged (``Renderer._capture``
        does the same for the single-device frame).  The warm-up frame
        before the capture meets every collective once."""
        inner = self._inner
        key = (inner._graph_key(has_light, None), self._pad_h_split,
               self.group.rank, self.group.size)
        scene = inner._staged_scene()
        if self._graph is not None and self._graph.key == key:
            return self._graph
        self._graph = None  # free the old graph's memory first
        ibl_maps = self.ibl.maps() if self.ibl is not None else None

        def frame(p):
            return self._frame(CameraParams(p), has_light, scene=scene)

        self._graph = _FrameGraph(key, inner.device, frame, params,
                                  refs=(ibl_maps,))
        self._captures += 1
        return self._graph

    def render_device(self, world):
        """The whole frame on this rank's device: (H, W) int32 packed
        rgba8 bits.  On a card: staging copies and one replay of the
        captured sharded frame, and a clone of its output; its counts
        stay on the device until the lag window reads them."""
        inner = self._inner
        if self._frame_fn is None:
            self.prepare(world)
        inner._sync_topology(world)
        if inner._prepare_count != self._prepared_at:
            self._rebuild_frame_fn()
        inner._refresh_transforms()
        params, has_light = inner.frame_params(world)
        if inner.device.type != "cuda":
            full, overflow = self._frame(params, has_light)
        else:
            graph = self._capture(params.src, has_light)
            graph.replay(params.src)
            full, overflow = graph.out.clone(), graph.overflow.clone()
        inner._note_overflow(overflow)
        return full

    def check_overflow(self) -> None:
        self._inner.check_overflow()

    def render(self, world):
        """The whole frame fetched to the host as (H, W, 4) uint8 rgba,
        its counts copied before it (``Renderer.render``)."""
        full = self.render_device(world)
        self._inner.stage_overflow()
        frame = unpack_rgba8(full)
        self.check_overflow()
        return frame
