"""Tile rasterizer: the visibility buffer (triangle id + depth), its full
mode with barycentrics, the depth-only shadow map, and the megakernel that
also interpolates the winner's attributes.

Port of ``mo_renderer_tpu/kernels/rasterizer.py``: ``rasterize`` with
``slim=True`` (K1), in full mode (K6) and with ``depth_only=True`` (K2)
becomes one CUDA kernel with a compile-time mode, ``csrc/raster.cu``;
``rasterize_attrs`` (K8) is ``csrc/raster_attrs.cu``.  Both sources share
one walk (``csrc/raster_common.cuh``): a block per 32 x 32 region of a
``BIN_H`` x ``BIN_W`` pixel bin, so the frame bins at that size; the
output does not depend on the tiling.  The walk takes the triangles' pixel
boxes (``BinnedTriangles.bbox``) and skips what a box cannot touch, which
changes no result: inside its tiles a triangle covers no pixel outside
that box.  The megakernel takes its rows as two 16-byte aligned tensors,
the (T, 16) raster rows and the (T, 48) attribute rows
(``vertex_stage.pack_raster_attr_rows``); ``split_attr_rows`` makes them
from the reference's (T, 63) rows.

Semantics, identical in the kernels and in the plain versions below:

- a pixel centre (x+0.5, y+0.5) is covered when each edge value
  w = (a*px + b*py) + c, rounded once per operation, is > 0, or == 0 on
  a top/left edge (tie bits, column 13);
- depth z = fma(zx, px, zy*py) + zc must be >= 0.  The multiply-add is
  fused because the reference fuses it where its CPU evaluation is the
  comparison: XLA contracts ``zx*px + zy*py`` into one FMA, and steep
  depth planes (|zx*px| >> |z|) amplify one rounding into ~1e-5 of
  depth.  The coverage edges keep one rounding per operation: their sign
  decides coverage, and the tests hold the ids to the reference exactly;
- LessOrEqual depth test walked in draw order from far = 1.0, so the
  later triangle wins ties; the id is -1 where z >= 1 (visibility mode);
- depth-only mode keeps min(1.0, z) over covering triangles;
- the full mode's barycentrics are the winner's b_i = w_i * inv_area
  (column 12) with w_i in the fused form fma(a, px, b*py) + c, as the
  reference computes them (0 where nothing covers);
- the megakernel interpolates the winner's 14 channels perspective-
  correctly from the 47 attribute columns (``pack_raster_attr_rows``)
  and passes its material id and has_tangent flag through.
"""

from __future__ import annotations

import dataclasses

import torch

from . import _build
from .raster_setup import (
    COL_INV_AREA,
    COL_TIE,
    TRI_STRIDE,
    BinnedTriangles,
)

FAR_DEPTH = 1.0
BIN_H = 32  # the CUDA kernels' bin: 32 x 128 pixels
BIN_W = 128
N_INTERP = 14  # RA_N_INTERP of passes/vertex_stage.py
ATTR_COLS = 3 + 3 * N_INTERP + 2  # RA_EXTRA_COLS of passes/vertex_stage.py
ATTR_ROW = 48  # ATTR_COLS padded to 16-byte aligned rows


def rasterize(binned: BinnedTriangles, *, width: int, height: int,
              depth_only: bool = False, slim: bool = False,
              tile_row_offset: int | None = None):
    """Rasterize binned triangles.

    Returns (tri int32 (H, W) with -1 for background, z f32 (H, W), b0,
    b1) as the reference does: b0/b1 are the winner's screen-space
    barycentrics in full mode and None when ``slim``; ``depth_only``
    returns (None, z, None, None).

    ``tile_row_offset`` (rasterizer.py:585-590; the row-sharded frame's
    band raster, K1b/K2b, slim or depth-only): render the ``height``-tall
    band that starts at pixel row ``tile_row_offset * binned.tile_h`` (bin
    rows of ``BIN_H`` on the card) of bins laid out for the whole frame,
    binned whole or band-locally (``bin_triangles(band_row0=...)``).  Every
    pixel keeps its row in the frame, so the band equals the same rows of
    the whole frame's raster bit for bit.  None, the default, is the whole
    frame (the band kernel is a separate launch even at offset 0).
    """
    mode = "depth" if depth_only else ("slim" if slim else "full")
    if tile_row_offset is not None:
        _check_band(binned, height, mode, tile_row_offset)
        if binned.tri_data.is_cuda:
            return _raster_band_cuda(binned, width, height, mode,
                                     tile_row_offset)
        return _raster_plain(binned, width, height, mode, tile_row_offset)
    if binned.tri_data.is_cuda:
        return _raster_cuda(binned, width, height, mode)
    return _raster_plain(binned, width, height, mode)


def _check_band(binned, height, mode, tile_row_offset):
    if mode == "full":
        raise ValueError("rasterize: the band raster takes slim or "
                         "depth_only (no caller bands the full mode)")
    if tile_row_offset < 0:
        raise ValueError(f"rasterize: tile_row_offset {tile_row_offset} < 0")
    if (tile_row_offset * binned.tile_h + height
            > binned.n_tiles_y * binned.tile_h):
        raise ValueError(
            f"rasterize: the band of {height} rows at bin row "
            f"{tile_row_offset} ends past the {binned.n_tiles_y} bin rows "
            "of the run table (bin the frame's split height)"
        )


def rasterize_attrs(binned: BinnedTriangles, *, width: int, height: int,
                    attr_rows):
    """Rasterize and interpolate attributes (the megakernel).

    ``binned.tri_data`` rows are the (T, 16) raster columns and
    ``attr_rows`` (T, 48) is ``vertex_stage.pack_raster_attr_rows``.
    Returns (tri int32 (H, W) with -1 for background, z (H, W), tuple of
    14 (H, W) f32 planes ordered wp.xyz, n.xyz, t.xyz, bt.xyz, uv0.uv,
    material id (H, W) f32, has_tangent (H, W) f32).
    """
    n_tri = binned.tri_data.shape[0]
    if (binned.tri_data.shape[1] != TRI_STRIDE
            or tuple(attr_rows.shape) != (n_tri, ATTR_ROW)):
        raise ValueError(
            f"rasterize_attrs takes (T, {TRI_STRIDE}) raster rows and (T, "
            f"{ATTR_ROW}) attribute rows, got "
            f"{tuple(binned.tri_data.shape)} and {tuple(attr_rows.shape)}"
        )
    if binned.tri_data.is_cuda:
        tri, z, planes = _raster_attrs_cuda(binned, attr_rows, width, height)
    else:
        tri, z, planes = _raster_attrs_plain(binned, attr_rows, width, height)
    return tri, z, tuple(planes[:N_INTERP]), planes[N_INTERP], planes[-1]


def split_attr_rows(binned: BinnedTriangles):
    """Binned triangles with the reference's (T, 63) rows (the 16 raster
    columns, then the 47 attribute columns) -> (the same with (T, 16)
    raster rows, the (T, 48) attribute rows)."""
    rows = binned.tri_data
    if rows.shape[1] != TRI_STRIDE + ATTR_COLS:
        raise ValueError(
            f"split_attr_rows takes {TRI_STRIDE + ATTR_COLS}-column rows, "
            f"got {rows.shape[1]}"
        )
    attr_rows = torch.nn.functional.pad(
        rows[:, TRI_STRIDE:], (0, ATTR_ROW - ATTR_COLS))
    raster = dataclasses.replace(
        binned, tri_data=rows[:, :TRI_STRIDE].contiguous())
    return raster, attr_rows


def _edge(a, b, c, px, py):
    return (a * px + b * py) + c


def _fused(a, b, c, px, py):
    """fma(a, px, b*py) + c, the fused multiply-add computed in float64
    (a*px is exact there, and so is the sum but for exponent gaps of more
    than ~16 bits, where a double rounding has ~2^-29 odds)."""
    fused = (a.double() * px.double() + (b * py).double()).float()
    return fused + c


def _winners(binned, with_winner=True, chunk=4096, row0=0, n_rows=None):
    """Per pixel of the bin canvas from bin row ``row0`` on (``n_rows``
    bin rows, all by default): z = min(1, z of covering pairs), and the
    winner id = the LAST pair in draw order with that z (what the
    sequential ``zin <= acc`` walk keeps; -1 where nothing covers).
    Returns (z (n_pix,), win (n_pix,) int64 or None without
    ``with_winner``, canvas width)."""
    dev = binned.tri_data.device
    th, tw = binned.tile_h, binned.tile_w
    ntx, nty = binned.n_tiles_x, binned.n_tiles_y
    if n_rows is None:
        n_rows = nty - row0
    canvas_w = ntx * tw
    n_pix = n_rows * th * canvas_w
    # the runs fill pair_tri's head; the capacity's slots pad it past them
    n_listed = int(binned.tile_count.sum())
    tiles = torch.repeat_interleave(
        torch.arange(ntx * nty, device=dev), binned.tile_count.to(torch.int64),
        output_size=n_listed,
    )
    ids = binned.pair_tri[:n_listed].to(torch.int64)
    if (row0, n_rows) != (0, nty):  # the pairs of the canvas's tiles
        keep = (tiles >= row0 * ntx) & (tiles < (row0 + n_rows) * ntx)
        tiles, ids = tiles[keep], ids[keep]
    iy = torch.arange(th, device=dev)
    ix = torch.arange(tw, device=dev)

    def pair_planes(lo, hi):
        rows = binned.tri_data[ids[lo:hi], :TRI_STRIDE]
        ty = torch.div(tiles[lo:hi], ntx, rounding_mode="floor")
        tx = tiles[lo:hi] - ty * ntx
        gy = (ty * th)[:, None, None] + iy[None, :, None]  # (p, th, 1)
        gx = (tx * tw)[:, None, None] + ix[None, None, :]  # (p, 1, tw)
        py = gy.to(torch.float32) + 0.5
        px = gx.to(torch.float32) + 0.5

        def col(j):
            return rows[:, j, None, None]

        tb = rows[:, COL_TIE].to(torch.int32)[:, None, None]

        def accept(w, bit):
            return (w > 0) | (((tb & bit) > 0) & (w == 0))

        cover = (
            accept(_edge(col(0), col(3), col(6), px, py), 1)
            & accept(_edge(col(1), col(4), col(7), px, py), 2)
            & accept(_edge(col(2), col(5), col(8), px, py), 4)
        )
        z = _fused(col(9), col(10), col(11), px, py)
        zin = torch.where(cover & (z >= 0.0), z, torch.inf)
        flat = ((gy - row0 * th) * canvas_w + gx).expand(zin.shape)
        return zin.reshape(-1), flat.reshape(-1)

    zbuf = torch.full((n_pix,), FAR_DEPTH, dtype=torch.float32, device=dev)
    n_pairs = ids.shape[0]
    for lo in range(0, n_pairs, chunk):
        zin, flat = pair_planes(lo, min(lo + chunk, n_pairs))
        zbuf.scatter_reduce_(0, flat, zin, reduce="amin", include_self=True)
    if not with_winner:
        return zbuf, None, canvas_w

    win = torch.full((n_pix,), -1, dtype=torch.int64, device=dev)
    for lo in range(0, n_pairs, chunk):
        hi = min(lo + chunk, n_pairs)
        zin, flat = pair_planes(lo, hi)
        pid = ids[lo:hi, None].expand(-1, th * tw).reshape(-1)
        hit = zin == zbuf[flat]
        win.scatter_reduce_(
            0, flat, torch.where(hit, pid, -1), reduce="amax",
            include_self=True,
        )
    return zbuf, win, canvas_w


def _canvas(a, canvas_w, width, height):
    return a.reshape(-1, canvas_w)[:height, :width].contiguous()


def _winner_rows(binned, win, canvas_w):
    """The winner's row and the pixel centre, per canvas pixel (of the
    whole frame's canvas: full mode has no band)."""
    dev = win.device
    n_pix = win.shape[0]
    flat = torch.arange(n_pix, device=dev)
    py = torch.div(flat, canvas_w, rounding_mode="floor")
    px = (flat - py * canvas_w).to(torch.float32) + 0.5
    return binned.tri_data[win.clamp(min=0)], px, py.to(torch.float32) + 0.5


def _raster_plain(binned, width, height, mode, tile_row_offset=None):
    """The same coverage and depth rule over all pairs at once; a band
    takes the pairs of its bin rows only."""
    band = {}
    if tile_row_offset is not None:
        band = dict(row0=tile_row_offset,
                    n_rows=-(-height // binned.tile_h))
    zbuf, win, canvas_w = _winners(binned, with_winner=mode != "depth",
                                   **band)
    z = _canvas(zbuf, canvas_w, width, height)
    if mode == "depth":
        return None, z, None, None
    tri = _canvas(win, canvas_w, width, height).to(torch.int32)
    tri = torch.where(z < FAR_DEPTH, tri, -1)
    if mode == "slim":
        return tri, z, None, None
    rows, px, py = _winner_rows(binned, win, canvas_w)
    has = win >= 0
    b = []
    for i in range(2):
        bi = _fused(rows[:, i], rows[:, 3 + i], rows[:, 6 + i], px, py)
        bi = torch.where(has, bi * rows[:, COL_INV_AREA], 0.0)
        b.append(_canvas(bi, canvas_w, width, height))
    return tri, z, b[0], b[1]


def _raster_attrs_plain(binned, attr_rows, width, height):
    """Winner per pixel as in ``_raster_plain``, then one interpolation of
    the winner's rows (the kernel's arithmetic, see csrc/raster_attrs.cu)."""
    zbuf, win, canvas_w = _winners(binned)
    z = _canvas(zbuf, canvas_w, width, height)
    tri = _canvas(win, canvas_w, width, height).to(torch.int32)
    tri = torch.where(z < FAR_DEPTH, tri, -1)
    rows, px, py = _winner_rows(binned, win, canvas_w)
    attrs = attr_rows[win.clamp(min=0)]
    q = []
    for i in range(3):
        w = _fused(rows[:, i], rows[:, 3 + i], rows[:, 6 + i], px, py)
        q.append(w * rows[:, COL_INV_AREA] * attrs[:, i])
    qs = (q[0] + q[1]) + q[2]
    rs = 1.0 / torch.where(qs.abs() > 1e-20, qs, 1.0)
    ob = [qi * rs for qi in q]
    planes = []
    for c in range(N_INTERP):
        a = attrs[:, 3 + 3 * c : 6 + 3 * c]
        planes.append((ob[0] * a[:, 0] + ob[1] * a[:, 1]) + ob[2] * a[:, 2])
    planes += [attrs[:, ATTR_COLS - 2], attrs[:, ATTR_COLS - 1]]
    has = win >= 0
    planes = torch.stack(
        [_canvas(torch.where(has, p, 0.0), canvas_w, width, height)
         for p in planes]
    )
    return tri, z, planes


def _check_bins(name, binned, width, height):
    """What the region walk takes: 32 x 128 bins that cover the target,
    16-column rows and one box per row, 16-byte aligned."""
    if (binned.tile_h, binned.tile_w) != (BIN_H, BIN_W):
        raise ValueError(
            f"the CUDA rasterizer takes {BIN_H}x{BIN_W} bins, got "
            f"{binned.tile_h}x{binned.tile_w}"
        )
    if (binned.n_tiles_x * BIN_W < width
            or binned.n_tiles_y * BIN_H < height):
        raise ValueError("the bins do not cover the raster target")
    _build.require_cuda(
        name, binned.tri_data, binned.pair_tri, binned.tile_start,
        binned.tile_count, binned.bbox,
        dtypes=(torch.float32, torch.int32, torch.int32, torch.int32,
                torch.int32),
    )
    tri_data, bbox = binned.tri_data, binned.bbox
    if (tri_data.shape[1] != TRI_STRIDE
            or bbox.shape != (tri_data.shape[0], 4)):
        raise ValueError(
            f"{name} takes {TRI_STRIDE}-column rows and one box per row, "
            f"got {tuple(tri_data.shape)} and {tuple(bbox.shape)}"
        )
    if tri_data.data_ptr() % 16 or bbox.data_ptr() % 16:
        raise ValueError(f"{name}: rows and boxes must be 16-byte aligned "
                         "(the kernel copies them 16 bytes at a time)")


_MODES = {"depth": 0, "slim": 1, "full": 2}


def _raster_cuda(binned, width, height, mode):
    _check_bins("rasterize", binned, width, height)
    tri_data, bbox = binned.tri_data, binned.bbox
    dev = tri_data.device

    def plane(dtype=torch.float32):
        return torch.empty((height, width), dtype=dtype, device=dev)

    z = plane()
    tri = None if mode == "depth" else plane(torch.int32)
    b0, b1 = (plane(), plane()) if mode == "full" else (None, None)

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    fn = _build.function(
        "mo_raster",
        [_build.P] * 9 + [_build.I] * 5 + [_build.P],
    )
    err = fn(
        tri_data.data_ptr(), bbox.data_ptr(), binned.pair_tri.data_ptr(),
        binned.tile_start.data_ptr(), binned.tile_count.data_ptr(),
        z.data_ptr(), ptr(tri), ptr(b0), ptr(b1),
        width, height, binned.n_tiles_x, binned.n_tiles_y, _MODES[mode],
        _build.stream_of(z),
    )
    _build.check("rasterize", err)
    _build.count(f"raster_{mode}")
    return tri, z, b0, b1


def _raster_band_cuda(binned, width, height, mode, tile_row_offset):
    _check_bins("rasterize", binned, width, height)
    dev = binned.tri_data.device
    z = torch.empty((height, width), dtype=torch.float32, device=dev)
    tri = (None if mode == "depth" else
           torch.empty((height, width), dtype=torch.int32, device=dev))
    fn = _build.function(
        "mo_raster_band", [_build.P] * 7 + [_build.I] * 5 + [_build.P],
    )
    err = fn(
        binned.tri_data.data_ptr(), binned.bbox.data_ptr(),
        binned.pair_tri.data_ptr(), binned.tile_start.data_ptr(),
        binned.tile_count.data_ptr(), z.data_ptr(),
        0 if tri is None else tri.data_ptr(),
        width, height, binned.n_tiles_x, tile_row_offset, _MODES[mode],
        _build.stream_of(z),
    )
    _build.check("rasterize", err)
    _build.count(f"raster_{mode}_band")
    return tri, z, None, None


def _raster_attrs_cuda(binned, attr_rows, width, height):
    _check_bins("rasterize_attrs", binned, width, height)
    _build.require_cuda("rasterize_attrs", binned.tri_data, attr_rows,
                        dtypes=(torch.float32, torch.float32))
    if attr_rows.data_ptr() % 16:
        raise ValueError("rasterize_attrs: attribute rows must be 16-byte "
                         "aligned (the kernel reads them 16 bytes at a time)")
    dev = binned.tri_data.device
    z = torch.empty((height, width), dtype=torch.float32, device=dev)
    tri = torch.empty((height, width), dtype=torch.int32, device=dev)
    planes = torch.empty((N_INTERP + 2, height, width), dtype=torch.float32,
                         device=dev)
    fn = _build.function(
        "mo_raster_attrs", [_build.P] * 9 + [_build.I] * 4 + [_build.P],
    )
    err = fn(
        binned.tri_data.data_ptr(), attr_rows.data_ptr(),
        binned.bbox.data_ptr(), binned.pair_tri.data_ptr(),
        binned.tile_start.data_ptr(), binned.tile_count.data_ptr(),
        z.data_ptr(), tri.data_ptr(), planes.data_ptr(),
        width, height, binned.n_tiles_x, binned.n_tiles_y,
        _build.stream_of(z),
    )
    _build.check("rasterize_attrs", err)
    _build.count("raster_attrs")
    return tri, z, planes
