"""ReferenceRenderer: a world of the plain copy (``harness.world``) ->
frames, op by op, with exact binning, on any device."""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from .plain.device import sampling
from .plain.kernels import ibl as ibl_kernels
from .plain.kernels.raster_setup import pair_capacity
from .plain.kernels.rasterizer import BIN_H, BIN_W
from .plain.passes.frame_graph import (
    _round_up,
    build_camera_params,
    frame_program,
)
from .plain.passes.present import unpack_rgba8
from .plain.scene.scene_buffers import find_shadow_light, pack_scene


@dataclasses.dataclass
class IBLMaps:
    """The tensors the shading passes read (the port's IBLMaps)."""

    environment_faces: torch.Tensor
    irradiance_faces: torch.Tensor
    specular_mips: sampling.MipCube
    brdf_lut: torch.Tensor
    specular_quad: sampling.MipCubeQuad
    specular_quad_merged: sampling.MipCubeQuadMerged
    irradiance_sh9: torch.Tensor


def ibl_maps(equirect: np.ndarray, sizes: dict, device) -> IBLMaps:
    """The IBL precompute of an equirect panorama at ``sizes``
    (cubemap_size, irradiance_size, specular_mips, specular_samples,
    brdf_lut_size), as the port's ``IBLResource.ensure_computed``."""
    eq = torch.as_tensor(np.asarray(equirect, np.float32), device=device)
    env = ibl_kernels.equirect_to_cubemap(eq, sizes["cubemap_size"])[..., :3]
    irr = ibl_kernels.irradiance_map(env, sizes["irradiance_size"])
    spec = ibl_kernels.specular_prefilter(env, sizes["specular_mips"],
                                          sizes["specular_samples"])
    lut = ibl_kernels.brdf_lut(sizes["brdf_lut_size"], device=device)
    quad = sampling.MipCubeQuad.from_mipcube(spec)
    return IBLMaps(
        environment_faces=env, irradiance_faces=irr, specular_mips=spec,
        brdf_lut=lut, specular_quad=quad,
        specular_quad_merged=sampling.MipCubeQuadMerged.from_quad(quad),
        irradiance_sh9=ibl_kernels.sh9_project_cube(irr))


@contextlib.contextmanager
def tf32_mode(enabled: bool):
    """float32 products in TF32 (``enabled``) or in full float32 over the
    block; the previous settings after it."""
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


class ReferenceRenderer:
    """The deferred frame of ``config`` (the plain copy's EngineConfig)
    on ``device``.  ``tf32`` computes its float32 products in TF32: the
    control, one precision below the configuration's."""

    def __init__(self, config, ibl: IBLMaps, device, tf32: bool = False):
        self.config = config
        self.ibl = ibl
        self.device = torch.device(device)
        self.tf32 = tf32
        self.pad_w = _round_up(config.width, config.tile_w)
        self.pad_h = _round_up(config.height, config.tile_h)

    def prepare(self, world) -> None:
        """Pack ``world`` afresh (the port's ``Renderer.prepare``)."""
        cfg = self.config
        self.world = world
        self.scene = pack_scene(world, cfg, self.device)
        if cfg.binned_cap is not None:
            self.binned_cap = _round_up(cfg.binned_cap, 8)
        else:
            smap = cfg.shadow_map_size
            n_tiles = max(
                -(-self.pad_w // BIN_W) * -(-self.pad_h // BIN_H),
                -(-smap // BIN_W) * -(-smap // BIN_H))
            self.binned_cap = pair_capacity(
                int(self.scene.indices.shape[0]), n_tiles)
        uses_uv1 = bool(self.scene.materials[:, 5:10].any())
        self.fast = cfg.fast_sampling and not uses_uv1
        self.n_lights = int(self.scene.num_lights)
        self.slot_map = tuple(int(x) for x in self.scene.stack_slots.tolist())

    def params(self, camera):
        """The camera block of ``camera`` (a plain-copy Camera)."""
        light_pv, has_light = find_shadow_light(self.world)
        return build_camera_params(camera, light_pv, self.device), has_light

    def render_packed(self, camera) -> torch.Tensor:
        """One frame of the prepared world from ``camera``: (H, W) int32
        packed rgba8 bits on the device."""
        params, has_light = self.params(camera)
        with torch.no_grad(), tf32_mode(self.tf32):
            rgba, (g, s) = frame_program(
                self.scene, self.ibl, params, cfg=self.config,
                pad_w=self.pad_w, pad_h=self.pad_h,
                binned_cap=self.binned_cap, has_shadow_light=has_light,
                slot_map=self.slot_map, n_lights=self.n_lights,
                fast=self.fast, shadow_quads=None, extra_passes=(),
                static_bins=False)
        if int(g) or int(s):
            raise RuntimeError(f"reference: {int(g)} + {int(s)} pairs "
                               "dropped by its binning")
        return rgba

    def render(self, camera) -> np.ndarray:
        """(H, W, 4) uint8 rgba on the host."""
        return unpack_rgba8(self.render_packed(camera))
