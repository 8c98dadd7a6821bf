"""Triangle setup and tile binning: CUDA kernels for a card's tensors,
PyTorch ops (the plain version) for the CPU's.

Port of ``mo_renderer_tpu/kernels/raster_setup.py``:

- ``setup_from_corners`` / ``triangle_setup`` /
  ``triangle_setup_from_attrs`` build the same
  16-column triangle rows (edge equations, affine depth plane, tie bits,
  validity) and inclusive pixel bboxes, with the same Vulkan conventions:
  pixel centres at +0.5, top-left fill rule, front face = negative signed
  area in y-down screen space, LessOrEqual depth with later-draw-wins.

- ``bin_triangles`` lists every (tile, triangle) pair into exactly
  ``binned_cap`` slots, a static capacity as in the reference (whose
  ``jit`` needs static shapes), with nothing read on the host, so a CUDA
  graph can capture it: the pairs are enumerated in draw order (slot ->
  triangle by ``searchsorted`` over the inclusive ``cumsum`` of the pair
  counts), then one sort of the key ``tile * T + tri`` puts each tile's
  run in draw order, which the rasterizer's later-wins tie rule needs;
  the slots past the true total get a key after the last tile.  The
  pairs past ``binned_cap`` (the last triangles') are dropped and counted
  in ``overflow``, a 0-d device tensor.  ``pair_capacity`` is the
  reference's static capacity (``Renderer.prepare``,
  frame_graph.py:481-511), built from its class caps.

On a CUDA tensor every entry point launches the hand kernels of
``csrc/raster_setup.cu`` instead (or raises; nothing falls back): one
setup launch with the corners' source fused in, and binning as a stable
counting sort by tile (a histogram of each chunk of triangles' pairs, a
scan, a fill in draw order) that touches only the real pairs.  Rows,
boxes, runs and dropped counts equal the plain version's bit for bit;
the slots past the runs, which no reader reads, are zeros in the plain
version and left unwritten by the kernels.
"""

from __future__ import annotations

import dataclasses

import torch

from . import _build

# tri_data column layout (16 f32 per triangle), as in the reference
COL_A0, COL_A1, COL_A2 = 0, 1, 2
COL_B0, COL_B1, COL_B2 = 3, 4, 5
COL_C0, COL_C1, COL_C2 = 6, 7, 8
COL_ZX, COL_ZY, COL_ZC = 9, 10, 11
COL_INV_AREA = 12
COL_TIE = 13
COL_TRI_ID = 14
COL_VALID = 15
TRI_STRIDE = 16

# An edge function (a*px + b*py) + c rounds in float32, and its error in
# pixels grows with the triangle's screen coordinates: about 1e-7 of them.
# While every edge spans at most this many pixels the error stays some
# hundredths of a pixel, far inside the full pixel between a triangle's
# corners and the first pixel centre outside its box.  A triangle with a
# corner just behind the ``w_eps`` cut (screen coordinates of 1e6 and more)
# can cover pixels outside its box.
MAX_EXACT_EXTENT = 65536.0


def default_medium_cap(t: int) -> int:
    """The reference's capacity of the medium (span 3..mt) class
    (raster_setup.py:289)."""
    return max(1024, t // 16)


LARGE_SPAN = 32  # the reference's large class: span up to 32 tiles


def default_large_cap(t: int) -> int:
    """The reference's capacity of the large class (raster_setup.py:296)."""
    return max(256, t // 128)


def default_xlarge_cap(t: int) -> int:
    """The reference's capacity of the xlarge (span 33..n_tiles) class
    (raster_setup.py:308)."""
    return max(8, t // 2048)


def pair_capacity(t: int, n_tiles: int) -> int:
    """The static pair capacity of ``t`` triangles over ``n_tiles`` bins
    (frame_graph.py:496-511): 2 slots per triangle + 8 / ``LARGE_SPAN`` /
    ``n_tiles`` per medium / large / xlarge class row, clamped to [8192,
    2^20] and rounded up to 8."""
    cap = (
        2 * t
        + 8 * default_medium_cap(t)
        + LARGE_SPAN * default_large_cap(t)
        + n_tiles * default_xlarge_cap(t)
    )
    return -(-min(max(8192, cap), 1 << 20) // 8) * 8


@dataclasses.dataclass
class TriangleSetup:
    tri_data: torch.Tensor  # (T, 16) f32
    bbox: torch.Tensor  # (T, 4) int32: x0, y0, x1, y1 inclusive; empty if x0 > x1


@dataclasses.dataclass
class BinnedTriangles:
    """Per-tile runs of triangle ids, each run in draw order.

    ``pair_tri[tile_start[k] : tile_start[k] + tile_count[k]]`` are the
    ids of the triangles whose bbox touches tile k (row-major tiles of
    ``tile_h`` x ``tile_w`` pixels); their rows are ``tri_data[id]``.
    ``bbox[id]`` is an inclusive pixel box a rasterizer may skip by: inside
    the tiles of its run a triangle covers no pixel outside it.  It is
    ``TriangleSetup.bbox``, except for a binned triangle with an edge
    longer than ``MAX_EXACT_EXTENT`` pixels, whose box is the whole of the
    tiles it is binned to."""

    tri_data: torch.Tensor  # (T, 16) f32
    bbox: torch.Tensor  # (T, 4) int32
    pair_tri: torch.Tensor  # (binned_cap,) int32
    tile_start: torch.Tensor  # (n_tiles,) int32
    tile_count: torch.Tensor  # (n_tiles,) int32
    tile_h: int
    tile_w: int
    n_tiles_x: int
    n_tiles_y: int
    overflow: torch.Tensor  # 0-d int64: pairs dropped by binned_cap


def project(points, m):
    """``points @ m.T`` for (N, 4) points and a (4, 4) matrix, summed in
    the order XLA's CPU dot uses at a packed scene's row counts
    (multiples of 1024): (x0*m0 + x1*m1) + (x2*m2 + x3*m3), one rounding
    per operation.  A BLAS matmul sums differently, which moves
    exact-on-edge pixels of the rasterizer."""
    return (points[:, 0:1] * m[:, 0] + points[:, 1:2] * m[:, 1]) + (
        points[:, 2:3] * m[:, 2] + points[:, 3:4] * m[:, 3]
    )


def triangle_setup(
    clip, indices, tri_valid, width, height, cull_backface=True,
    depth_bias_const=0.0, depth_bias_slope=0.0, w_eps=1e-6,
) -> TriangleSetup:
    """Setup from per-VERTEX clip positions (V, 4) and indices (T, 3)
    (raster_setup.py:122); triangles with any w <= w_eps are culled."""
    return _setup(SRC_INDEXED, (clip, indices), tri_valid, width, height,
                  cull_backface, depth_bias_const, depth_bias_slope, w_eps)


def triangle_setup_from_attrs(
    tri_attrs, tri_valid, proj_view, width, height, cull_backface=True,
    depth_bias_const=0.0, depth_bias_slope=0.0, w_eps=1e-6,
) -> TriangleSetup:
    """Setup straight from the packed per-triangle world corners
    (columns 0..8 of ``tri_attrs``): clip = [wp, 1] @ PV^T per corner."""
    return _setup(SRC_ATTRS, (tri_attrs, proj_view), tri_valid, width,
                  height, cull_backface, depth_bias_const, depth_bias_slope,
                  w_eps)


def setup_from_corners(
    v0, v1, v2, tri_valid, width, height, *,
    cull_backface=True, depth_bias_const=0.0, depth_bias_slope=0.0,
    w_eps=1e-6,
) -> TriangleSetup:
    """Core setup math over per-triangle clip corners (T, 4) x 3."""
    return _setup(SRC_CORNERS, (v0, v1, v2), tri_valid, width, height,
                  cull_backface, depth_bias_const, depth_bias_slope, w_eps)


# the corners' source of a setup: (v0, v1, v2) (T, 4) each; (clip (V, 4),
# indices (T, 3)); (tri_attrs (T, C >= 9), proj_view (4, 4))
SRC_CORNERS, SRC_INDEXED, SRC_ATTRS = 0, 1, 2


def _setup(src, inputs, *args) -> TriangleSetup:
    """The CUDA kernel for a card's tensors, the plain version for the
    CPU's."""
    fn = _setup_cuda if inputs[0].is_cuda else _setup_plain
    return fn(src, inputs, *args)


def _setup_plain(src, inputs, tri_valid, width, height, cull_backface,
                 depth_bias_const, depth_bias_slope, w_eps) -> TriangleSetup:
    """The setup in torch ops, on any device: the corners from ``src``'s
    inputs, then ``_corners_plain``."""
    if src == SRC_INDEXED:
        clip, indices = inputs
        idx = indices.to(torch.int64)
        corners = clip[idx[:, 0]], clip[idx[:, 1]], clip[idx[:, 2]]
    elif src == SRC_ATTRS:
        tri_attrs, proj_view = inputs

        def clip_of(k):
            wp = tri_attrs[:, 3 * k : 3 * k + 3]
            return project(
                torch.cat([wp, torch.ones_like(wp[:, :1])], dim=-1),
                proj_view,
            )

        corners = clip_of(0), clip_of(1), clip_of(2)
    else:
        corners = inputs
    return _corners_plain(*corners, tri_valid, width, height, cull_backface,
                          depth_bias_const, depth_bias_slope, w_eps)


def _corners_plain(v0, v1, v2, tri_valid, width, height, cull_backface,
                   depth_bias_const, depth_bias_slope, w_eps):
    w0, w1, w2 = v0[:, 3], v1[:, 3], v2[:, 3]
    w_ok = (w0 > w_eps) & (w1 > w_eps) & (w2 > w_eps)

    def to_screen(v, w):
        inv = 1.0 / torch.where(w > w_eps, w, torch.ones_like(w))
        sx = (v[:, 0] * inv + 1.0) * (0.5 * width)
        sy = (v[:, 1] * inv + 1.0) * (0.5 * height)
        z = v[:, 2] * inv
        return sx, sy, z

    x0, y0, z0 = to_screen(v0, w0)
    x1, y1, z1 = to_screen(v1, w1)
    x2, y2, z2 = to_screen(v2, w2)

    area2 = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    s = torch.where(area2 >= 0.0, 1.0, -1.0)

    def edge(ax, ay, bx, by):
        a_coef = -s * (by - ay)
        b_coef = s * (bx - ax)
        c_coef = s * ((by - ay) * ax - (bx - ax) * ay)
        tie = (a_coef > 0) | ((a_coef == 0) & (b_coef > 0))
        return a_coef, b_coef, c_coef, tie

    a0c, b0c, c0c, tie0 = edge(x1, y1, x2, y2)
    a1c, b1c, c1c, tie1 = edge(x2, y2, x0, y0)
    a2c, b2c, c2c, tie2 = edge(x0, y0, x1, y1)

    abs_area = area2.abs()
    inv_area = torch.where(
        abs_area > 0, 1.0 / torch.clamp(abs_area, min=1e-30), 0.0
    )

    valid = tri_valid & w_ok & (abs_area > 0)
    if cull_backface:
        valid = valid & (area2 < 0.0)

    zx = (a0c * z0 + a1c * z1 + a2c * z2) * inv_area
    zy = (b0c * z0 + b1c * z1 + b2c * z2) * inv_area
    zc = (c0c * z0 + c1c * z1 + c2c * z2) * inv_area
    if depth_bias_const != 0.0 or depth_bias_slope != 0.0:
        # shadow_pass.rs:132-140 polygon offset semantics
        zc = zc + depth_bias_const * (2.0**-23) + (
            depth_bias_slope * torch.maximum(zx.abs(), zy.abs())
        )

    tie_bits = tie0 * 1.0 + tie1 * 2.0 + tie2 * 4.0
    tri_id = torch.arange(
        tri_valid.shape[0], dtype=torch.float32, device=v0.device
    )
    tri_data = torch.stack(
        [
            a0c, a1c, a2c,
            b0c, b1c, b2c,
            c0c, c1c, c2c,
            zx, zy, zc,
            inv_area,
            tie_bits,
            tri_id,
            valid.to(torch.float32),
        ],
        dim=-1,
    )

    min_x = torch.minimum(torch.minimum(x0, x1), x2)
    max_x = torch.maximum(torch.maximum(x0, x1), x2)
    min_y = torch.minimum(torch.minimum(y0, y1), y2)
    max_y = torch.maximum(torch.maximum(y0, y1), y2)

    def pix(v, hi):
        return torch.clamp(v, 0, hi).to(torch.int32)

    bx0 = pix(torch.floor(min_x - 0.5), width - 1)
    bx1 = pix(torch.ceil(max_x - 0.5), width - 1)
    by0 = pix(torch.floor(min_y - 0.5), height - 1)
    by1 = pix(torch.ceil(max_y - 0.5), height - 1)
    offscreen = (
        (max_x < 0.5) | (min_x > width - 0.5)
        | (max_y < 0.5) | (min_y > height - 0.5)
    )
    empty = offscreen | ~valid
    bx0 = torch.where(empty, 1, bx0)
    bx1 = torch.where(empty, 0, bx1)
    bbox = torch.stack([bx0, by0, bx1, by1], dim=-1).to(torch.int32)
    return TriangleSetup(tri_data=tri_data, bbox=bbox)


def _pair_keys(pairs, span_x, ly0, tx0, n_tiles_x, n_tiles, binned_cap):
    """Sorted keys ``tile * T + triangle`` of exactly ``binned_cap``
    slots, with no host read: slot -> the triangle whose pairs hold it by
    ``searchsorted`` over the inclusive ``cumsum``, then its tile from
    the slot's place among that triangle's tiles (row-major); the slots
    past the total sort after the last tile, so no run reaches them.  The
    count dropped is a 0-d device tensor."""
    t = pairs.shape[0]
    stride = max(t, 1)
    incl = torch.cumsum(pairs, 0)
    first = incl - pairs
    slot = torch.arange(binned_cap, device=pairs.device)
    tri_rep = torch.searchsorted(incl, slot, right=True)
    listed_slot = tri_rep < t  # t past the last pair
    tri_rep = torch.clamp(tri_rep, max=max(t - 1, 0))
    local = slot - first[tri_rep]
    sx = span_x[tri_rep]
    dy = torch.div(local, sx, rounding_mode="floor")
    tile = (ly0[tri_rep] + dy) * n_tiles_x + tx0[tri_rep] + local - dy * sx
    key, _ = torch.sort(torch.where(listed_slot, tile * stride + tri_rep,
                                    n_tiles * stride))
    return key, torch.clamp(pairs.sum() - binned_cap, min=0)


def bin_triangles(
    setup: TriangleSetup,
    *,
    tile_h: int,
    tile_w: int,
    n_tiles_x: int,
    n_tiles_y: int,
    binned_cap: int,
    band_row0: int | None = None,
    band_tile_rows: int | None = None,
) -> BinnedTriangles:
    """Every (tile, triangle) pair of the triangles' bboxes, sorted by
    (tile, draw order), with no host read.  The pairs fill exactly
    ``binned_cap`` slots: ``pair_tri`` has that length, the runs cover
    its first min(total, cap) entries, and ``overflow`` is the 0-d device
    tensor max(total - cap, 0).  Past the cap the first triangles' pairs
    are kept (the first slots in draw order).

    Band mode (raster_setup.py:350): with ``band_row0`` and
    ``band_tile_rows``, only the pairs whose tile row lies in [band_row0,
    band_row0 + band_tile_rows) are listed.  Tile ids stay global and the
    run table covers all ``n_tiles_x * n_tiles_y`` tiles (empty outside
    the band), so a band raster reads the same runs it would read from
    the whole frame's bins; the band fills ``binned_cap`` slots and
    ``overflow`` counts its pairs past them."""
    fn = _bin_cuda if setup.tri_data.is_cuda else _bin_plain
    return fn(setup, tile_h, tile_w, n_tiles_x, n_tiles_y, binned_cap,
              band_row0, band_tile_rows)


def _bin_plain(setup, tile_h, tile_w, n_tiles_x, n_tiles_y, binned_cap,
               band_row0, band_tile_rows) -> BinnedTriangles:
    """The binning in torch ops, on any device (``bin_triangles``)."""
    tri_data, bbox = setup.tri_data, setup.bbox
    dev = tri_data.device
    t = tri_data.shape[0]
    n_tiles = n_tiles_x * n_tiles_y

    live = (tri_data[:, COL_VALID] > 0) & (bbox[:, 0] <= bbox[:, 2])
    bb = bbox.to(torch.int64)
    tx0 = bb[:, 0] // tile_w
    tx1 = bb[:, 2] // tile_w
    ty0 = bb[:, 1] // tile_h
    ty1 = bb[:, 3] // tile_h
    span_x = tx1 - tx0 + 1
    # the tile rows listed: the box's, clipped to the band in band mode
    ly0, ly1, listed = ty0, ty1, live
    if band_tile_rows is not None:
        ly0 = torch.clamp(ty0, min=band_row0)
        ly1 = torch.clamp(ty1, max=band_row0 + band_tile_rows - 1)
        listed = live & (ly1 >= ly0)
    pairs = torch.where(listed, span_x * (ly1 - ly0 + 1), 0)
    # columns 0..5 are the edges' extents in pixels (a = -+dy, b = +-dx)
    huge = live & ~(tri_data[:, :COL_C0].abs().amax(1) <= MAX_EXACT_EXTENT)
    tiles_box = torch.stack(
        [tx0 * tile_w, ty0 * tile_h, (tx1 + 1) * tile_w - 1,
         (ty1 + 1) * tile_h - 1], dim=-1,
    ).to(torch.int32)
    bbox = torch.where(huge[:, None], tiles_box, bbox)
    stride = max(t, 1)
    key, overflow = _pair_keys(pairs, span_x, ly0, tx0, n_tiles_x, n_tiles,
                               binned_cap)
    tile_sorted = torch.div(key, stride, rounding_mode="floor")
    pair_tri = (key - tile_sorted * stride).to(torch.int32)
    tile_end = torch.searchsorted(
        tile_sorted, torch.arange(n_tiles, device=dev), right=True
    )
    tile_start = torch.cat(
        [torch.zeros(1, dtype=tile_end.dtype, device=dev), tile_end[:-1]]
    )
    return BinnedTriangles(
        tri_data=tri_data.contiguous(),
        bbox=bbox.contiguous(),
        pair_tri=pair_tri.contiguous(),
        tile_start=tile_start.to(torch.int32),
        tile_count=(tile_end - tile_start).to(torch.int32),
        tile_h=tile_h,
        tile_w=tile_w,
        n_tiles_x=n_tiles_x,
        n_tiles_y=n_tiles_y,
        overflow=overflow,
    )


# --- the CUDA kernels (csrc/raster_setup.cu) ---------------------------------

# a binning block's tile tables live in shared memory: 12 bytes a tile
MAX_CUDA_TILES = 16 * 1024


def _setup_cuda(src, inputs, tri_valid, width, height, cull_backface,
                depth_bias_const, depth_bias_slope, w_eps) -> TriangleSetup:
    """``tri_setup_kernel``: one launch from the corners ``inputs``, as
    ``src`` says."""
    inputs = [x.contiguous() for x in inputs]
    if src == SRC_INDEXED and inputs[1].dtype != torch.int32:
        inputs[1] = inputs[1].to(torch.int32)
    valid = tri_valid.contiguous()
    f32, i32 = torch.float32, torch.int32
    dtypes = {SRC_CORNERS: (f32, f32, f32), SRC_INDEXED: (f32, i32),
              SRC_ATTRS: (f32, f32)}[src]
    _build.require_cuda("tri_setup", *inputs, valid,
                        dtypes=dtypes + (torch.bool,))
    t = valid.shape[0]
    if src == SRC_CORNERS:
        shapes_ok = all(x.shape == (t, 4) for x in inputs)
    elif src == SRC_INDEXED:
        shapes_ok = (inputs[0].dim() == 2 and inputs[0].shape[1] == 4
                     and inputs[1].shape == (t, 3))
    else:
        shapes_ok = (inputs[0].dim() == 2 and inputs[0].shape[0] == t
                     and inputs[0].shape[1] >= 9
                     and inputs[1].shape == (4, 4))
    if not shapes_ok or valid.shape != (t,):
        raise ValueError(
            f"tri_setup: inputs {[tuple(x.shape) for x in inputs]} do not "
            f"fit {t} triangles")
    tri_data = torch.empty((t, TRI_STRIDE), dtype=f32, device=valid.device)
    bbox = torch.empty((t, 4), dtype=i32, device=valid.device)
    if t == 0:
        return TriangleSetup(tri_data=tri_data, bbox=bbox)
    ptrs = [x.data_ptr() for x in inputs] + [None] * (3 - len(inputs))
    idx = None
    if src == SRC_INDEXED:
        ptrs[1], idx = None, ptrs[1]
    fn = _build.function(
        "mo_tri_setup",
        [_build.I] + [_build.P] * 7 + [_build.I] * 2 + [_build.F]
        + [_build.I] * 4 + [_build.F] * 2 + [_build.P],
    )
    bias = depth_bias_const != 0.0 or depth_bias_slope != 0.0
    err = fn(
        src, ptrs[0], ptrs[1], ptrs[2], idx, valid.data_ptr(),
        tri_data.data_ptr(), bbox.data_ptr(), t,
        inputs[0].shape[1] if src == SRC_ATTRS else 0, w_eps, width, height,
        int(cull_backface), int(bias), depth_bias_const * (2.0**-23),
        depth_bias_slope, _build.stream_of(tri_data),
    )
    _build.check("tri_setup", err)
    _build.count("tri_setup")
    return TriangleSetup(tri_data=tri_data, bbox=bbox)


def _bin_cuda(setup, tile_h, tile_w, n_tiles_x, n_tiles_y, binned_cap,
              band_row0, band_tile_rows) -> BinnedTriangles:
    """``bin_count_kernel`` + ``bin_scan_kernel``, then
    ``bin_fill_kernel``."""
    tri_data, bbox = setup.tri_data.contiguous(), setup.bbox.contiguous()
    _build.require_cuda("binning", tri_data, bbox,
                        dtypes=(torch.float32, torch.int32))
    t = tri_data.shape[0]
    n_tiles = n_tiles_x * n_tiles_y
    if (tri_data.dim() != 2 or tri_data.shape[1] < TRI_STRIDE
            or bbox.shape != (t, 4)):
        raise ValueError(f"binning: rows {tuple(tri_data.shape)} and boxes "
                         f"{tuple(bbox.shape)}")
    if not 0 < n_tiles <= MAX_CUDA_TILES:
        raise ValueError(f"binning: {n_tiles} tiles; the kernels take 1 to "
                         f"{MAX_CUDA_TILES}")
    if t * n_tiles > _build.INT32_MAX:
        raise ValueError(f"binning: {t} triangles over {n_tiles} tiles "
                         "overflow its 32-bit pair counts")
    dev = tri_data.device
    i32 = torch.int32
    tile_start = torch.empty(n_tiles, dtype=i32, device=dev)
    tile_count = torch.empty(n_tiles, dtype=i32, device=dev)

    def binned(pair_tri, box, overflow):
        return BinnedTriangles(
            tri_data=tri_data, bbox=box, pair_tri=pair_tri,
            tile_start=tile_start, tile_count=tile_count, tile_h=tile_h,
            tile_w=tile_w, n_tiles_x=n_tiles_x, n_tiles_y=n_tiles_y,
            overflow=overflow)

    if t == 0:
        tile_start.zero_()
        tile_count.zero_()
        return binned(torch.zeros(binned_cap, dtype=i32, device=dev), bbox,
                      torch.zeros((), dtype=torch.int64, device=dev))

    n_ws = _build.function("mo_bin_workspace_ints",
                           [_build.I, _build.I])(t, n_tiles)
    if n_ws < 0:
        raise ValueError(f"binning: {t} triangles over {n_tiles} tiles need "
                         "too large a workspace")
    ws = torch.empty(n_ws, dtype=i32, device=dev)
    totals = torch.empty(2, dtype=torch.int64, device=dev)
    box = torch.empty_like(bbox)
    stream = _build.stream_of(ws)
    band = band_tile_rows is not None
    prepare = _build.function(
        "mo_bin_prepare",
        [_build.P, _build.I, _build.P] + [_build.I] * 9
        + [_build.P] * 4,
    )
    err = prepare(
        tri_data.data_ptr(), tri_data.shape[1], bbox.data_ptr(), t, tile_h,
        tile_w, n_tiles_x, n_tiles, int(band), band_row0 if band else 0,
        band_tile_rows if band else 0, binned_cap, ws.data_ptr(),
        totals.data_ptr(), box.data_ptr(), stream,
    )
    _build.check("binning", err)
    _build.count("bin_count")
    _build.count("bin_scan")
    pair_tri = torch.empty(binned_cap, dtype=i32, device=dev)
    fill = _build.function(
        "mo_bin_fill", [_build.I] * 4 + [_build.P] * 5)
    err = fill(
        t, n_tiles_x, n_tiles, binned_cap, ws.data_ptr(),
        pair_tri.data_ptr(), tile_start.data_ptr(), tile_count.data_ptr(),
        stream,
    )
    _build.check("bin_fill", err)
    _build.count("bin_fill")
    return binned(pair_tri, box, totals[1])
