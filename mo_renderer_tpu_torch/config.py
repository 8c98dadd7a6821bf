"""Engine configuration: the port's own copy of ``mo_renderer_tpu/config.py``.

Same fields, same defaults (``tests/test_torch_scene_api.py`` holds them
equal), so one ``EngineConfig(...)`` call means the same frame in both
packages.  The reference hardcodes these knobs across files (shadow map
2048^2 at mo_renderpass/src/shadow_pass.rs:56, IBL size 512 at
mo_ecs/src/resource/ibl_resource.rs:41, camera speeds at
mo_ecs/src/resource/camera.rs:13-15, SSAO near/far at
resources/shaders/ssao.comp:12-13, window 1280x720 at
mo_vk/src/window.rs:349-350).

A few fields shape only the JAX package's TPU programs and are read here
only to pad the framebuffer (``tile_h``, ``tile_w``) or not at all
(``raster_sub_y``, ``raster_sub_x``, ``compile_cache``); the port's
CUDA rasterizer bins at its own 32x128 tiles and the output does not
depend on the tiling.
"""

from __future__ import annotations

import dataclasses
import os

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _default_resource_root() -> str:
    """Locate the ``resources/`` asset tree: $MO_RESOURCES, then
    ./resources, then the checkout's own ``resources/``."""
    for cand in (
        os.environ.get("MO_RESOURCES"),
        os.path.join(os.getcwd(), "resources"),
        os.path.join(_REPO, "resources"),
    ):
        if cand and os.path.isdir(cand):
            return cand
    return os.path.join(os.getcwd(), "resources")


@dataclasses.dataclass
class EngineConfig:
    # Framebuffer (reference default window: mo_vk/src/window.rs:349-350)
    width: int = 1280
    height: int = 720

    # Shadow map (shadow_pass.rs:54-61): fixed-size D32 depth map, and the
    # shadow pipeline's depth bias (shadow_pass.rs:132-140).
    shadow_map_size: int = 2048
    shadow_depth_bias_const: float = 2.0
    shadow_depth_bias_slope: float = 2.0

    # IBL precompute (ibl_resource.rs:41-64)
    ibl_cubemap_size: int = 512
    ibl_brdf_lut_size: int = 512
    ibl_env_name: str = "default_sky"
    ibl_specular_samples: int = 1024
    ibl_irradiance_delta: float = 0.025

    # SSAO (ssao.comp:12-13): hardcoded linearization range.
    ssao_near: float = 0.1
    ssao_far: float = 100.0
    ssao_enabled: bool = True
    shadow_enabled: bool = True
    # Memoize the shadow map while the caster light and every entity
    # transform stay the same (the map is a pure function of both).  Only
    # the fast path memoizes; the reference sampling path re-rasters the
    # shadow map every frame, as the JAX package does.
    shadow_cache: bool = True

    # Raster tiling of the JAX package's Pallas grid.  The framebuffer is
    # padded to (tile_h, tile_w) multiples in both packages; None picks 64
    # rows when that does not grow the padded height, else 32.
    tile_h: int | None = None
    tile_w: int = 128
    raster_sub_y: int | None = None
    raster_sub_x: int = 1
    # Capacity of the (tile, triangle) pair table, the slots every binning
    # fills; pairs past it are dropped and raise.  None: the reference's
    # pair_capacity over the larger of the frame's and the shadow map's
    # tilings.
    binned_cap: int | None = None

    # Scene capacities.
    max_vertices: int = 1 << 20
    max_triangles: int = 1 << 20
    max_meshes: int = 256
    max_materials: int = 256
    max_lights: int = 16
    # Texture array for the reference sampling path: every material
    # texture resampled into one (N, size, size, 4) array.  The fast
    # path's quad stacks keep native pow2 sizes, capped at
    # max_texture_size.
    texture_array_size: int = 1024
    max_texture_size: int = 2048
    max_textures: int = 64
    # Fast sampling: quad-packed texture/shadow/IBL layouts and SH9
    # irradiance.  Off, or when a material samples UV set 1, the frame
    # takes the reference sampling path.
    fast_sampling: bool = True
    # Interpolate the triangle attributes inside the raster kernel
    # (rasterize_attrs, the "megakernel") instead of a per-pixel row
    # gather after it.
    raster_interp_attrs: bool = False
    # Per-pixel attribute planes by the attr_planes kernel (fast path).
    attrs_plane_kernel: bool = True
    # Texture-stack unpack + bilinear by the stack_planes kernel.
    stack_plane_kernel: bool = False
    # PCF window table as u16-packed 4x4 windows (one gather per pixel),
    # anchored on the even texel grid only.
    pcf_u16: bool = True
    pcf_half_anchor: bool = True
    # Evaluate the PCF factor on a strided pixel grid (1 = full rate) and
    # bilinearly upsample.
    pcf_res_divisor: int = 4
    # Specular IBL on the even-pixel grid: the parent-mip tap, the mirror
    # tap (with a mask-aware upsample at the sky silhouette), and both taps
    # from one merged child+parent row.
    spec_parent_mip_half_res: bool = True
    spec_mirror_half_res: bool = True
    spec_merged_trilinear: bool = True
    # SSAO as one tile kernel (the other branch is the plain full-image
    # shift formulation).
    ssao_pallas: bool = True
    # Evaluate SSAO on the even-pixel grid and bilinearly upsample
    # (1 = full rate); the reference's radius scales with the resolution,
    # so this is its own semantics at half size.
    ssao_res_divisor: int = 2
    # Checkerboard shading: G-buffer and shading on half the pixels
    # (columns 2j + (y & 1)), the rest reconstructed from the four
    # neighbours, guided by triangle ids.  Fast path only.
    checkerboard: bool = True

    # Asset root containing gltf/, tex/, shaders/ subdirs.
    resource_root: str = dataclasses.field(default_factory=_default_resource_root)

    # The JAX package's persistent compilation cache switch (unused here).
    compile_cache: bool = True

    # Camera system constants (camera.rs:13-15).
    rotate_speed: float = 0.3141592653589793  # PI / 10
    move_speed: float = 0.01
    mouse_sensitivity: float = 0.005

    def __post_init__(self):
        def up(x, m):
            return ((x + m - 1) // m) * m

        if self.tile_h is None:
            self.tile_h = (
                64 if up(self.height, 64) == up(self.height, 32) else 32
            )
        if self.raster_sub_y is None:
            self.raster_sub_y = max(1, self.tile_h // 32)
        assert self.tile_w % 128 == 0, "tile_w must be a multiple of 128"
        assert self.tile_h % 8 == 0, "tile_h must be a multiple of 8"
        assert (
            self.tile_h % self.raster_sub_y == 0
            and (self.tile_h // self.raster_sub_y) % 8 == 0
        ), "tile_h/raster_sub_y must be a multiple of 8"


DEFAULT_CONFIG = EngineConfig()
