#!/usr/bin/env python3
"""Drive the PyTorch port (mo_renderer_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

0. Environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions.
1. Build: compile the CUDA kernels from csrc/ with nvcc (one process per
   source, all at once, each with its unit's flags); print each hand
   kernel's registers, stack bytes and static SASS instruction count
   (FP32 arithmetic, special-function, global and shared load and store
   instructions apart), from cuobjdump.
2. Kernels: capture each kernel's inputs from one 1920x1080 frame of the
   asset-free scene on each of the port's four paths (default, reference
   sampling, megakernel, and the texture-stack path on the scene's
   all-slots variant), then hold every CUDA kernel against its plain
   PyTorch version on those same card tensors (the checkerboard
   reconstruct through both of its entries: ``interleave`` takes the
   packed rgba8 frame, ``interleave_present`` the float colour, as the
   frame calls it, and also reports what ``present_pass``'s torch ops
   cost on that colour; each entry has its own launch count, and no
   1080p path launches the packed one), and time both: the median
   over 20 calls of the device time between two CUDA events, with each
   call queued behind a sleep kernel so the host's issue time is not in
   the measurement.  Each kernel's bound is the larger of the bytes it
   must move over 3.35 TB/s and its FP32 operations over 67 TFLOP/s
   (the H100 SXM data sheet), both counted from this run's inputs: the
   raster's candidates are the pixels of the binned triangles' boxes, and
   SSAO's operations are counted per pipe (ssao_flop_equivalents), its
   square roots only for the taps that occlude on this depth plane.
   Then the same for the raster modes, the megakernel and SSAO on a second
   set of inputs that loads them: one default-path, one reference-path and
   one megakernel-path frame of scenes.grid_world(10) (the reference's
   ~52K-triangle stress scene) at 1920x1080, reported as
   ``raster_slim@grid`` etc. with the pair count and the largest per-tile
   run (their launches are those of phase 4's three paths on that scene).
   Then the band forms of the row-sharded frame, each on the same inputs
   cut into 4 bands as ``TileShardedRenderer`` cuts them (the 1088-row
   frame into 4 x 320 rows, the 2048^2 shadow map into 4 x 512):
   ``raster_slim_band`` and ``raster_depth_band`` (K1b/K2b, also
   ``...@grid``) and ``ssao_halo`` (K4b, on the bands' full-rate depth
   with their neighbours' rows as halos).  Each band must equal its plain
   version exactly, and the 4 bands together the whole-frame kernel's
   output bit for bit, from the whole frame's bins and from band-local
   bins; the time is that of the 4 band launches, with each band's own.
   Then the shading pass ``shading`` (K9, ``csrc/shading.cu``: one
   launch, 16 x 32 tiles with their even-grid samples in shared memory)
   on the default path's call and, as ``shading@grid``, on
   grid_world(10)'s (5 lights), held to its plain version at rtol 2e-3 /
   atol 1e-4 per pixel with the packed frame within 1 LSB on < 1% of
   pixels; its bytes count the table rows the samples gather once each.
   Every discrete choice it makes, through the kernel's debug output, is
   held to the plain version's (``shading_choices``: on the even grid the
   table rows and sky flags, at full rate the taps' table rows, a sky
   pixel's environment row, the mask-aware upsample's pick and the PCF
   window's anchor; no PCF factor a tap apart): 0 apart.  Then the
   G-buffer tail ``gbuffer`` (K10, ``csrc/gbuffer.cu``) on the default
   path's call, and against its plain version on each of its input
   sources (GBUFFER_SOURCES: the attr_planes planes, the
   attrs_plane_kernel=False tensors, the megakernel's planes, the stacks
   path, a band of the default path's G-buffer), each plane at rtol 2e-3
   / atol 1e-4 and 0 texel rows apart (through its debug output); the
   same as ``gbuffer@grid`` on grid_world(10)'s calls.  Then the
   reference path's shading pass ``shading_ref`` (K11,
   ``csrc/shading_ref.cu``: one launch, a warp a span of pixels that it
   shades sky pixels first, then lit pixels, each from a list compacted in
   shared memory) on the reference path's call (its G-buffer, SSAO, raw
   2048^2 shadow map, IBL maps), as ``shading_ref@grid`` and as
   ``shading_ref@lit`` (grid_world(10) from ``scenes.lit_camera``, over
   its plane: no pixel is sky), at SHADING_BAR,
   with its PCF
   compares and tap texels, cube faces, mip levels and sample texels
   through its debug output equal to the plain version's
   (``shading_ref_check``); its bytes count the map texels the samples
   read once each.  ``check_shading_ref_options`` holds K11 without IBL,
   without a shadow map, on the UV1 scene under default flags and with a
   sun, a point and a spot light.  Then the reference path's G-buffer
   ``gbuffer_ref`` (K12, ``csrc/gbuffer_ref.cu``: one launch, a warp a
   row span of 32 pixels; phase 1 also prints its dense and strided
   template instances apart) on the reference path's call (K6's planes,
   the scene's tables and texture array, the vertex stage's outputs) and
   as ``gbuffer_ref@grid``, each plane at rtol 2e-3 / atol 1e-4 with its
   texel anchors and UV sets through its debug output equal to the plain
   version's (``gbuffer_ref_check``); its bytes count the vertex and
   material rows and texels the covered pixels touch, once each.
   ``check_gbuffer_ref_options`` holds K12 on the UV1 scene under default
   flags, the all-slots scene, that call without tangents, and the
   ``@lit`` call cut to an odd 1079 x 1917 target (``edge_cut``).  Then
   ``...@lit``: every kernel whose input depends on the camera (K1, K6,
   K8, K3, K7 under the stack overrides, K10 on each source, K12, K4, K5,
   K9, K11, and the band forms K1b and K4b) on the calls of the default,
   reference, megakernel and stack frames of grid_world(10) from
   ``scenes.lit_camera``, each entry reporting its ``sky_pixels`` (every
   entry does) and asserting 0; and ``shading@lit/1025`` and
   ``shading_ref@lit/1025``, K9 and K11 on those calls with 1024 point
   lights of the benchmark's many-light layout
   (``benchmark/scenes/sponza_many_lights.py``) after the scene's sun:
   1025 light rows, two chunks of their shared memory.
   ``check_shading_options`` holds K9 at
   the same bar with 0 choices apart, at 1920x1080, on every knob set of
   the reference's budget matrix (``scenes.BUDGET_BOUNDS`` on
   ``scenes.budget_world``: the checkerboard on and off, PCF divisors
   1/2/4, both u16 layouts, each spec_* branch), the f32 wide-row PCF
   table, no IBL, no shadow and a band of the rows path; then the same
   option sets on the sky-free view (``shading@lit``).
3. Frames at 256x128: the default frame, the reference-path frame
   (fast_sampling=False), the UV1 scene under default flags, the
   megakernel frame (raster_interp_attrs=True, ssao_res_divisor=1), the
   texture-stack frames (stack kernel on, attrs kernel off or on) and
   the frame under each other fast-path option (the two other PCF
   layouts, the specular taps at full rate or unmerged, SSAO without the
   tile kernel), each on the card against the port's CPU frame of the
   same scene, within the golden bar of tests/test_golden.py (mean
   |diff| < 2/255, < 0.5% of channels > 16/255).  The stack kernel must
   launch on the texture-stack frames and nowhere else, also when the
   reference and megakernel paths are given stack_plane_kernel=True.
   Then the row-sharded frame: ``TileShardedRenderer`` at 256x256 (SSAO
   at full rate, checkerboard on and off) on a world of one, its process
   group NCCL, initialised in this process on 127.0.0.1, against the same
   renderer on the CPU (a gloo group of the same world), within the same
   bar; with the checkerboard on, a cube spawned into that world shows in
   the next sharded frame without a rebuild of the band program.  Then
   incremental topology on the tiny scene, the same steps on the card and
   the CPU: a default-texture cube spawn keeps the pack state and equals a
   fresh prepare's frame bit for bit, K2 launches once on the frame after
   it and not on the next, the despawn gives the first frame back bit for
   bit, a spawn with new texture content makes one full prepare; the
   spawned and fallback frames hold the golden bar.  Then the window loop:
   ``run_windowed`` through an OffscreenWindow, 3 frames with a resize to
   384x160 pending before frame 2, the last frame (160, 384, 4) within the
   golden bar of the CPU's; ``present_divisor=2`` presents (64, 128, 4).
   Then ``[3] render pass``: a probe RenderPass sees the padded frame
   (on the card while the frame is captured, not per replay), dims it,
   ``present_pass`` runs and K5 does not launch, ``resize`` reaches
   ``on_swapchain_recreate``, card vs CPU in the golden bar.
   ``[3] sequence``: on each of the four paths and with a pass,
   ``render_sequence_device`` (the frame captured in a CUDA graph and
   replayed per step) over K = 4 poses with the light fixed and K = 3
   with it moving equals the eager ``render_device`` frames bit for bit,
   a second call with the same key captures nothing new; the binning
   kernels list the plain version's runs on the card, and past a small
   capacity the graph's device overflow sum equals the eager sum.
   ``[3] views``: ``MultiViewRenderer`` on the NCCL world of one, 3 views
   equal 3 single-view frames bit for bit, a 3-step x 2-view sequence
   equals per-step views, a spawn shows in the next views.
   ``[3] interactive``: ``render_device`` replays the frame captured in a
   CUDA graph keyed on the layout; on the default, reference, megakernel,
   stacks and rows paths and the default path with an extra pass, at
   256x128, 8 frames through a camera move, an entity move, a spawn, a
   despawn, a light move and a resize each equal the eager
   ``frame_program`` frame bit for bit with the same dropped-pair counts,
   frames returned earlier stay unchanged, the moves, spawn, despawn and
   light capture nothing and the resize captures once; past a 256-pair
   capacity ``check_overflow`` raises with the eager counts.
4. Frames at 1920x1080 through the port's App.run along the reference
   benchmark's small camera orbit, on each of the four paths (the
   texture-stack path on the all-slots scene): finite, not black, sky
   and geometry both present, no bin overflow, and every kernel of the
   path launched during its run (the counts are set to 0 just before each
   path and read just after; they are the captured launches of each
   replayed frame plus the capture's warm-up frame; the reference path
   re-rasterizes the shadow map every frame; a checkerboard frame takes
   one reconstruct launch and never ``present_pass``).  Prints each
   path's steady-state ms/frame replayed, beside the eager frame
   (``eager_frames``) in turns on the same app, then host launch calls
   and device time per frame of both from torch.profiler over two more
   frames.  Then the default, the reference
   and the megakernel path on scenes.grid_world(10) in the same way, a few
   frames each, and ``default@lit``, ``reference@lit`` and
   ``megakernel@lit``, those paths on that scene from
   ``scenes.lit_camera`` (geometry everywhere, no sky).  Then the ``rows``
   path: the 1080p row-sharded frame
   (``TileShardedRenderer``, world of one, ``ssao_res_divisor=1``) along
   the same orbit, and ``rows@grid`` and ``rows@lit`` on the stress
   scene, timed and profiled the same way; they launch the band kernels and no
   whole-frame raster or SSAO kernel.  Then the interactive loop:
   ``window`` and ``window/2``, the default path on the tiny scene through
   ``run_windowed`` and an OffscreenWindow at ``present_divisor`` 1 and 2,
   timed in turns with the eager frame and ``App.run`` on the same app
   and profiled the same way; and ``spawn@grid``, five cube spawns into
   grid_world(10), none of which captures: the medians of the
   ``_sync_topology`` ms, of the first frame after a spawn and of the
   next, and of a full ``prepare`` of the same world.  The ``default``,
   ``reference`` and their ``@grid`` paths also print the eager frame's
   launches and device ms by pass (the functions ``frame_program`` calls,
   wrapped in ``torch.profiler.record_function`` ranges by this script
   only; each hand kernel's device time is added to its pass by kernel
   name), each hand kernel's device ms, and the rest of the frame by the
   op that queued it (the fetch, the frame's own ops); the reference
   paths' G-buffer pass must make K12's one launch.  Then
   ``sequence`` (the default path's 16 orbit poses as one
   ``render_sequence_device`` call, 3 timed calls beside an eager loop
   over the same poses: ms/frame, host launch calls and device kernels per
   frame, device ms and busy share, the static pair capacity beside the
   pair counts), ``sequence@grid`` (8 poses of grid_world(10)) and
   ``views`` (4 views a call through ``MultiViewRenderer``, which replays
   the same captured frame per view: ms per view).
5. Surface: the oracle rasterizer (``kernels/raster_reference``) on the
   card equals K6 (full mode) on the tiny scene's 256x128 rows (ids
   exact, depth within 1e-6); then the port's programs through their
   entry points, each with the launch counts set to 0 just before it and
   read just after (it must launch the default path's kernels and no
   other; the counts go to each kernel's own entry of the kernels line,
   whatever the scene): ``bench.run`` at 1920x1080 per frame and with
   ``seq=16`` (both JSON lines, with the card), ``sponza_scale.main``
   (1080p, 3 frames), ``dynamic_spawn.main`` (1280x720, the despawn
   restores the frame bit for bit), ``multi_view_flythrough.main``
   (3840x2160, 8 views, 8 steps, on the NCCL world of one: one capture)
   and ``eval_configs.main`` on ``ibl_preprocess``, ``sponza_1080p``,
   ``multi_view_4k`` (8 steps) and ``stress_200k_1080p`` (5 frames each;
   exit 0, its JSON printed).  The sky is the synthetic one wherever
   ``resources/`` is absent, and every output names it.

The last two lines are a JSON summary of the kernels and the contract
line {"ok": true, "device": {...}}.  Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# kernel name -> (csrc file, TPU kernel it replaces)
KERNELS = {
    "raster_slim": ("mo_renderer_tpu_torch/csrc/raster.cu",
                    "mo_renderer_tpu/kernels/rasterizer.py:549"),
    "raster_depth": ("mo_renderer_tpu_torch/csrc/raster.cu",
                     "mo_renderer_tpu/kernels/rasterizer.py:549"),
    "attr_planes": ("mo_renderer_tpu_torch/csrc/attr_planes.cu",
                    "mo_renderer_tpu/kernels/attr_planes.py:124"),
    "ssao": ("mo_renderer_tpu_torch/csrc/ssao.cu",
             "mo_renderer_tpu/passes/ssao.py:171"),
    "interleave": ("mo_renderer_tpu_torch/csrc/interleave.cu",
                   "mo_renderer_tpu/kernels/decimate.py:98"),
    "interleave_present": ("mo_renderer_tpu_torch/csrc/interleave.cu",
                           "mo_renderer_tpu/kernels/decimate.py:98"),
    "raster_full": ("mo_renderer_tpu_torch/csrc/raster.cu",
                    "mo_renderer_tpu/kernels/rasterizer.py:549"),
    "raster_attrs": ("mo_renderer_tpu_torch/csrc/raster_attrs.cu",
                     "mo_renderer_tpu/kernels/rasterizer.py:288"),
    "stack_planes": ("mo_renderer_tpu_torch/csrc/stack_planes.cu",
                     "mo_renderer_tpu/kernels/stack_planes.py:66"),
    "raster_slim_band": ("mo_renderer_tpu_torch/csrc/raster.cu",
                         "mo_renderer_tpu/kernels/rasterizer.py:560"),
    "raster_depth_band": ("mo_renderer_tpu_torch/csrc/raster.cu",
                          "mo_renderer_tpu/kernels/rasterizer.py:560"),
    "ssao_halo": ("mo_renderer_tpu_torch/csrc/ssao.cu",
                  "mo_renderer_tpu/passes/ssao.py:176"),
    # no pallas_call: the reference's shading_pass_fast is jnp code that
    # XLA fuses on the TPU
    "shading": ("mo_renderer_tpu_torch/csrc/shading.cu",
                "mo_renderer_tpu/passes/shading.py:717"),
    # no pallas_call either: the reference's _texture_and_assemble and the
    # velocity lines are jnp code that XLA fuses
    "gbuffer": ("mo_renderer_tpu_torch/csrc/gbuffer.cu",
                "mo_renderer_tpu/passes/gbuffer.py:361"),
    # nor here: the reference's shading_pass is jnp code too
    "shading_ref": ("mo_renderer_tpu_torch/csrc/shading_ref.cu",
                    "mo_renderer_tpu/passes/shading.py:149"),
    # nor here: the reference's gbuffer_pass is jnp code too
    "gbuffer_ref": ("mo_renderer_tpu_torch/csrc/gbuffer_ref.cu",
                    "mo_renderer_tpu/passes/gbuffer.py:71"),
}
# K10's input sources: the default path's attr_planes planes, the
# attrs_plane_kernel=False branch's tensors, the megakernel's planes, the
# stacks path (stack_planes planes for the sampled channels) and a band of
# the row-sharded frame; phase 2 holds each against the plain version
GBUFFER_SOURCES = ("planes", "torch", "megakernel", "stacks", "band")
# the band forms: built from the other kernels' captured inputs
BAND_KERNELS = ("raster_slim_band", "raster_depth_band", "ssao_halo")
N_BANDS = 4  # the bands phase 2 cuts the 1080p inputs into

STACKS = {"attrs_plane_kernel": False, "stack_plane_kernel": True}

# triangle setup and binning (csrc/raster_setup.cu), every path's first
# kernels: their launch names; they replace no TPU kernel (the reference's
# triangle_setup, raster_setup.py:122, and bin_triangles, :339, are XLA
# ops)
SETUP_KERNELS = ("tri_setup", "bin_count", "bin_scan", "bin_fill")
SETUP_SOURCE = "mo_renderer_tpu_torch/csrc/raster_setup.cu"
SETUP_REPLACES = ("none: triangle_setup, mo_renderer_tpu/kernels/"
                  "raster_setup.py:122, and bin_triangles, :339 (XLA ops)")

# the port's four paths: EngineConfig overrides, the kernels each runs,
# and the scene variant (scenes.tiny_world keywords)
PATHS = {
    "default": ({}, ("raster_slim", "raster_depth", "attr_planes",
                     "gbuffer", "ssao", "shading", "interleave_present")
                + SETUP_KERNELS, {}),
    "reference": ({"fast_sampling": False},
                  ("raster_full", "raster_depth", "gbuffer_ref", "ssao",
                   "shading_ref") + SETUP_KERNELS, {}),
    "megakernel": ({"raster_interp_attrs": True},
                   ("raster_attrs", "raster_depth", "gbuffer", "ssao",
                    "shading") + SETUP_KERNELS, {}),
    "stacks": (STACKS, ("raster_slim", "raster_depth", "stack_planes",
                        "gbuffer", "ssao", "shading", "interleave_present")
               + SETUP_KERNELS, {"all_slots": True}),
}

# the dense inputs of phase 2: the frames of scenes.grid_world that give
# them (EngineConfig overrides) and the kernels timed on them
GRID_KERNELS = ("raster_slim", "raster_depth", "raster_full", "ssao",
                "raster_attrs", "shading", "gbuffer", "shading_ref",
                "gbuffer_ref")
BAND_GRID_KERNELS = ("raster_slim_band", "raster_depth_band")
# and the three paths phase 4 drives on that scene
GRID_PATHS = {
    "default@grid": PATHS["default"][:2],
    "reference@grid": PATHS["reference"][:2],
    "megakernel@grid": PATHS["megakernel"][:2],
}
# the paths on that scene from scenes.lit_camera, where no pixel is sky (an
# interior's share of lit pixels): phase 4 drives them, and phase 2 holds
# every kernel whose input depends on the camera on their frames' calls
# (``...@lit``, each asserting 0 sky pixels), K9 on every option set too
LIT_PATHS = {f"{path}@lit": PATHS[path][:2]
             for path in ("default", "reference", "megakernel")}
LIT_KERNELS = ("raster_slim", "raster_full", "raster_attrs", "attr_planes",
               "stack_planes", "gbuffer", "gbuffer_ref", "ssao",
               "interleave_present", "shading", "shading_ref",
               "raster_slim_band", "ssao_halo")
# the shading kernels on the @lit calls with 1025 light rows (many_lights)
MANY_LIGHT_KERNELS = ("shading", "shading_ref")
# the row-sharded frame (TileShardedRenderer on a world of one): the
# kernels it runs, and the scene of each of its phase-4 paths
ROWS_OVERRIDES = {"ssao_res_divisor": 1}
ROWS_KERNELS = ("raster_slim_band", "raster_depth_band", "attr_planes",
                "gbuffer", "ssao_halo", "shading",
                "interleave_present") + SETUP_KERNELS
ROWS_PATHS = {"rows": "tiny", "rows@grid": "grid", "rows@lit": "lit"}

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12  # outside the tensor cores

# FP32 operations per unit of work, counted from the kernels' arithmetic
# (multiplies, adds and square roots; an FMA counts two; compares,
# selects and integer work not counted)
RASTER_FLOPS_PER_CANDIDATE = 16  # 3 edges x 4 + the fused depth plane
FULL_FLOPS_PER_PIXEL = 8  # two fused edges and two products, per pixel
ATTRS_FLOPS_PER_PIXEL = 95  # q, qs, 1/qs, 14 channels x 5
ATTR_PLANES_FLOPS_PER_PIXEL = 50
# SSAO in machine operations per pipe, from csrc/ssao.cu: an IEEE square
# root or division is one special-function operation (MUFU) and its FP32
# fix-up
SSAO_FP32_PER_TAP = 2  # the depth difference and its compare
SSAO_FP32_PER_OCCLUDING_TAP = 9 + 6  # both factors, fade, sum; root fix-up
SSAO_MUFU_PER_OCCLUDING_TAP = 1
SSAO_FP32_PER_PIXEL = 14 + 2 * 8  # noise, radius, quantization; 2 divisions
SSAO_MUFU_PER_PIXEL = 2  # the linearization's and the radius's division
SSAO_FP64_PER_PIXEL = 40  # sin in double: reduction and polynomial
STACK_FLOPS_PER_PIXEL = 6  # the four bilinear weights
STACK_FLOPS_PER_PLANE = 11  # 4 scales by 1/255, 4 weights, 3 adds
# K9, from csrc/shading.cu: per lit pixel the view vector, F0, the combine
# and the tonemap; per light Cook-Torrance (square roots, divisions and the
# two powers counted one each); with IBL the SH9 sum, the 13 x 13
# Chebyshev environment BRDF (2 x 13 x 13 multiply-adds), the split sum
# and the upsamples of the even-grid taps; with IBL a sky pixel only the
# mask-aware upsample of the mirror tap; per even-grid tap (mirror, parent
# or a full-rate one) the reflection, the cube face, an RGBE quad and its
# bilinear weights; per PCF sample the light projection and 9 taps over a
# 4 x 4 window
SHADE_FLOPS_PER_PIXEL = 45
SHADE_FLOPS_PER_LIGHT = 150
SHADE_IBL_FLOPS_PER_PIXEL = 950
SHADE_FLOPS_PER_SKY_PIXEL = 20
SHADE_FLOPS_PER_TAP = 80
SHADE_FLOPS_PER_PCF_SAMPLE = 280
# K11, from csrc/shading_ref.cu: per lit pixel the view vector, F0, the
# combine and the tonemap (as K9) and Cook-Torrance per light; with a
# shadow map the light projection and 9 bilinear taps; with IBL two cube
# faces, the reflection, 4 bilinear samples (irradiance, two specular
# levels, the BRDF LUT) and the split sum; a sky pixel its ray, face and
# one bilinear sample
REF_FLOPS_PCF = 30 + 9 * 24
REF_FLOPS_IBL = 300
REF_FLOPS_SKY = 90
SHADING_BAR = ("colour rtol 2e-3 / atol 1e-4 per pixel; packed frame "
               "<= 1 LSB on < 1% of pixels")


def sass_report(path, instances=False):
    """{kernel: {"registers", "stack", "instructions", "fp32", "mufu"}} of
    the hand kernels compiled into ``path`` (the built library, or a
    cubin), from ``cuobjdump``: registers and stack bytes a thread, and the
    static SASS instruction count, of which FP32 arithmetic (FFMA, FMUL,
    FADD), special-function (MUFU), global (LDG, STG) and shared (LDS,
    STS) memory instructions.  A template's instances add up under its
    name, or with ``instances`` each is its own entry, its mangled
    template arguments after the name (``gbuffer_ref_kernel<Lb1>``)."""
    import re
    import shutil
    import subprocess

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"

    def run(flag):
        return subprocess.run([tool, flag, path], capture_output=True,
                              text=True, check=True).stdout

    def name(mangled):
        """The ``..._kernel`` identifier inside a mangled name (its
        length prefix told apart from the digits of a hash before it)."""
        for i in range(len(mangled)):
            for n_digits in (1, 2):
                digits = mangled[i:i + n_digits]
                if not digits.isdigit():
                    continue
                n = int(digits)
                end = i + n_digits + n
                cand = mangled[i + n_digits:end]
                if len(cand) == n and cand.endswith("_kernel"):
                    if instances and mangled[end:end + 1] == "I":
                        args = mangled[end + 1:mangled.index("EE", end)]
                        return f"{cand}<{args}>"
                    return cand
        return mangled

    out = {}

    def entry(mangled):
        return out.setdefault(name(mangled), {
            "registers": 0, "stack": 0, "instructions": 0, "fp32": 0,
            "mufu": 0, "ldg": 0, "stg": 0, "lds": 0, "sts": 0})

    # a template's instances add up under one name; registers: the most
    for m in re.finditer(r"Function (\S+):\s*REG:(\d+) STACK:(\d+)",
                         run("-res-usage")):
        e = entry(m.group(1))
        e["registers"] = max(e["registers"], int(m.group(2)))
        e["stack"] = max(e["stack"], int(m.group(3)))
    cur = None
    for line in run("-sass").splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            cur = entry(m.group(1))
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                     line)
        if m and cur is not None:
            cur["instructions"] += 1
            cur["fp32"] += m.group(1) in ("FFMA", "FMUL", "FADD")
            cur["mufu"] += m.group(1) == "MUFU"
            for op in ("LDG", "STG", "LDS", "STS"):
                cur[op.lower()] += m.group(1) == op
    return out


def ssao_flop_equivalents(n_pixels, n_taps, n_occluding):
    """SSAO's arithmetic on ``n_pixels`` pixels of ``n_taps`` taps, of
    which ``n_occluding`` (pixel, tap) pairs occlude on this run's data,
    in FP32 FLOP at the 67 TFLOP/s peak.  That peak is one FMA (2 FLOP)
    per lane and clock on 128 lanes an SM, and these operations are not
    FMAs, so each costs 2 FLOP of it.  Per SM and clock the card starts
    128 lane-operations in all, 16 on the special-function pipe (1/8 of
    the FP32 rate) and 64 in FP64 (1/2): the slowest of the total and the
    two pipes bounds the kernel."""
    fp32 = (n_pixels * (SSAO_FP32_PER_TAP * n_taps + SSAO_FP32_PER_PIXEL)
            + n_occluding * SSAO_FP32_PER_OCCLUDING_TAP)
    mufu = (n_pixels * SSAO_MUFU_PER_PIXEL
            + n_occluding * SSAO_MUFU_PER_OCCLUDING_TAP)
    fp64 = n_pixels * SSAO_FP64_PER_PIXEL
    return 2 * max(fp32 + mufu + fp64, 8 * mufu, 2 * fp64)


def median_ms(fn, runs=20, sleep_cycles=50_000_000):
    """Median device ms of one call of ``fn``: the call is issued while
    the stream still runs a ~30 ms sleep kernel, so the events bracket
    device work only, not the host's time to issue it."""
    import torch

    fn()  # warm
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_split(fn, runs=20):
    """{kernel: device ms a call} of ``fn`` under torch.profiler, over
    ``runs`` calls after a warm one."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    return {_kernel_label(row.key): row.self_device_time_total / runs / 1e3
            for row in prof.key_averages()
            if row.device_type == torch.autograd.DeviceType.CUDA}


def bound(n_bytes, n_flops):
    """(bound_ms, bound_by): the least time for the bytes and the FP32
    operations at the card's published peaks."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def shading_args(args, kwargs):
    """A recorded ``shading_pass_fast`` call as the 15 positional
    arguments its kernel (``_shading_fast_cuda``) and its plain version
    (``_shading_fast_plain``) take."""
    import inspect

    from mo_renderer_tpu_torch.passes import shading as Sh

    bound = inspect.signature(Sh.shading_pass_fast).bind(*args, **kwargs)
    bound.apply_defaults()
    return tuple(bound.arguments.values())


def shading_compare(k, p):
    """K9's colour against its plain version's at SHADING_BAR: per pixel
    rtol 2e-3 / atol 1e-4, and the packed frame (``present_pass``) within
    1 LSB on fewer than 1% of pixels.  (max |err|, ok, bar)."""
    import torch

    from mo_renderer_tpu_torch.passes.present import present_pass

    diff = torch.where(torch.isnan(k) & torch.isnan(p), 0.0, (k - p).abs())
    err = diff.nan_to_num(nan=float("inf")).max().item()
    close = bool(torch.allclose(k, p, rtol=2e-3, atol=1e-4, equal_nan=True))

    def packed(c):
        return present_pass(c).contiguous().view(torch.uint8).reshape(
            *c.shape[:2], 4).to(torch.int32)

    lsb = (packed(k) - packed(p)).abs().amax(-1)
    frac = (lsb > 0).float().mean().item()
    ok = close and int(lsb.max()) <= 1 and frac < 0.01
    return err, ok, f"{SHADING_BAR} ({frac:.4%} of pixels differ by 1 LSB)"


def shading_choices(args):
    """K9's discrete choices on one call through its debug output, against
    the plain version's on the same call, with the plain version's own
    helpers: on the even grid the table rows the mirror and parent taps
    read and the sky flags, and the PCF factors on the divisor's grid; at
    full rate (``Sh.FAST_DEBUG``) the table rows of the full-rate taps (at
    a sky pixel the environment's), the even-grid sample the mask-aware
    upsample takes, and the PCF window's anchor and factor at divisor 1.
    A PCF factor is a choice apart when it differs by more than 1e-3 (a
    tap moves it by 0.75 / 9).  Returns ({what: (n apart, n held)}, {tap:
    max |err|}) and raises if a tap is outside SHADING_BAR's rtol / atol."""
    import torch

    from mo_renderer_tpu_torch.passes import shading as Sh

    (gbuf, _, rows, s, _, _, params, ibl, div, parent, mirror, merged, cb,
     row_offset, full_height) = args
    _, got = Sh._shading_fast_cuda(*args, debug=True)
    half = Sh.half_res_geometry(gbuf, cb=cb)
    h, w = gbuf.depth.shape
    eye = params["eye_pos"]
    counts, errs = {}, {}

    def close(name, k, p):
        errs[name] = (k - p).abs().max().item() if k.numel() else 0.0
        if not torch.allclose(k, p, rtol=2e-3, atol=1e-4):
            raise AssertionError(f"shading: even-grid {name} differs from "
                                 f"the plain version (max |err| "
                                 f"{errs[name]})")

    def same(name, k, p):
        counts[name] = (int((k != p).sum()), p.numel())

    def pcf(name, k, p):
        counts[name] = (int(((k - p).abs() > 1e-3).sum()), p.numel())

    if ibl is not None and mirror:
        c0h, c1h, sky_h, idx0 = Sh.even_grid_taps(
            half, eye, ibl, params, h, 2 * w if cb else w, merged and parent,
            row_offset, full_height)
        same("mirror rows", got["rows_h"][..., 0], idx0.to(torch.int32))
        same("sky flags", got["skyh"].bool(), sky_h)
        close("mirror tap", got["c0h"], c0h)
        if c1h is not None:
            same("parent rows", got["rows_h"][..., 1], idx0.to(torch.int32))
            close("parent tap", got["c1h"], c1h)
    if ibl is not None and parent and not (mirror and merged):
        c1h, idx1 = Sh.parent_tap(*half[:3], eye, ibl)
        same("parent rows", got["rows_h"][..., 1], idx1.to(torch.int32))
        close("parent tap", got["c1h"], c1h)
    if rows is not None and div > 1:
        pos = half[0][::2, ::2] if div == 4 else half[0]
        pcf("pcf factors", got["pcf"], Sh.calculate_shadow_fast(
            pos, params["light_proj_view"], rows, s))

    # full rate: each FAST_DEBUG channel where the kernel makes the choice
    # (with IBL a sky pixel takes the mirror tap alone), -1 elsewhere
    want = torch.full_like(got["dbg"], -1)
    sky = (gbuf.depth >= 1.0) if ibl is not None \
        else torch.zeros_like(gbuf.depth, dtype=torch.bool)
    lit = ~sky
    if ibl is not None and not mirror:
        want[..., 0] = Sh.mirror_tap_full(gbuf, eye, ibl, params, row_offset,
                                          full_height)[1]
    if ibl is not None and not parent:
        idx1 = Sh.parent_tap(gbuf.position, gbuf.normal, gbuf.orm[..., 1],
                             eye, ibl)[1]
        want[..., 1] = torch.where(lit, idx1, -1)
    if ibl is not None and mirror:
        # _mask_aware on the even samples' own indices, with -1 where it
        # keeps the blend
        hh, wh = half[3].shape

        def nn(a, dy, dx):
            r = Sh._shift(a, dy, dx).repeat_interleave(2, dim=0)
            return (r if cb else r.repeat_interleave(2, dim=1))[:h, :w]
        ids = torch.arange(hh * wh, device=sky.device,
                           dtype=torch.float32).reshape(hh, wh, 1)
        up = torch.full((h, w, 1), -1.0, device=sky.device)
        want[..., 2] = Sh._mask_aware(up, ids, half[3] >= 1.0, sky,
                                      nn)[..., 0].to(torch.int32)
    if rows is not None and div == 1:
        x0, y0 = Sh.pcf_window_anchor(gbuf.position,
                                      params["light_proj_view"], s)[:2]
        want[..., 3] = torch.where(lit, _pack_anchor(x0, y0), -1)
        pcf("pcf factors, full rate", got["pcf"][lit],
            Sh.calculate_shadow_fast(gbuf.position,
                                     params["light_proj_view"], rows, s)[lit])
    for c, name in enumerate(Sh.FAST_DEBUG):
        n_held = int((want[..., c] >= 0).sum())
        if n_held or bool((got["dbg"][..., c] >= 0).any()):
            counts[f"full-rate {name}"] = (
                int((got["dbg"][..., c] != want[..., c]).sum()), n_held)
    return counts, errs


def shading_taps_check(args):
    """``shading_choices`` on one call, raising if any choice is apart.
    Returns what was compared: {what: "n of N" apart}, the taps' max
    |err| and ``choices_apart``, the sum of the counts."""
    counts, errs = shading_choices(args)
    res = {k: f"{n} of {of}" for k, (n, of) in counts.items()}
    res.update({f"{k}_max_abs_err": v for k, v in errs.items()})
    res["choices_apart"] = sum(n for n, _ in counts.values())
    if res["choices_apart"]:
        raise AssertionError(f"shading: discrete choices apart from the "
                             f"plain version: {res}")
    return res


def shading_work(args):
    """(bytes, FP32 operations, what else to report) of K9 on ``args``:
    the depth of every pixel read once and its colour written once, the
    other G-buffer planes and SSAO of the lit pixels (with IBL a sky
    pixel's colour is the sky's: it reads neither) read once, the light
    rows, SH9 and level tables once, and of the specular and PCF tables
    the rows this run's samples gather, each counted once (the unique
    indices, recomputed here with the plain version's helpers)."""
    import torch

    from mo_renderer_tpu_torch.passes import shading as Sh

    (gbuf, _, rows, s, lights, n_lights, params, ibl, div, parent, mirror,
     merged, cb, row_offset, full_height) = args
    h, w = gbuf.depth.shape
    n_px = h * w
    n_l = min(lights.shape[0], n_lights)
    half = Sh.half_res_geometry(gbuf, cb=cb)
    n_even = half[3].numel()
    n_sky = int((gbuf.depth >= 1.0).sum()) if ibl is not None else 0
    n_lit = n_px - n_sky
    n_bytes = (n_px * 4 * (1 + 3) + n_lit * 4 * (5 * 3 + 1)
               + n_l * lights.shape[1] * 4)
    flops = (n_lit * (SHADE_FLOPS_PER_PIXEL + SHADE_FLOPS_PER_LIGHT * n_l)
             + n_sky * SHADE_FLOPS_PER_SKY_PIXEL)
    gathered = {}  # table -> its rows the samples read
    if ibl is not None:
        eye = params["eye_pos"]
        n_bytes += 2 * 4 * ibl.specular_quad.num_levels + 9 * 3 * 4
        flops += n_lit * SHADE_IBL_FLOPS_PER_PIXEL
        # the taps' rows as shading_choices recomputes them; a full-rate
        # parent tap only at the lit pixels
        if mirror:
            mirror_idx = Sh.even_grid_taps(
                half, eye, ibl, params, h, 2 * w if cb else w,
                merged and parent, row_offset, full_height)[3]
        else:
            mirror_idx = Sh.mirror_tap_full(gbuf, eye, ibl, params,
                                            row_offset, full_height)[1]
        table = ("merged" if mirror and parent and merged else "spec")
        gathered[table] = [mirror_idx]
        if parent and not (mirror and merged):
            gathered["spec"].append(Sh.parent_tap(*half[:3], eye, ibl)[1])
        elif not parent:
            gathered["spec"].append(Sh.parent_tap(
                gbuf.position, gbuf.normal, gbuf.orm[..., 1], eye,
                ibl)[1][gbuf.depth < 1.0])
        flops += SHADE_FLOPS_PER_TAP * (
            (n_even if mirror else n_px) + (n_even if parent else n_px))
    if rows is not None:
        pos = gbuf.position if div == 1 else half[0]
        if div == 4:
            pos = pos[::2, ::2]
        x0, y0 = [a.to(torch.int64) for a in Sh.pcf_window_anchor(
            pos, params["light_proj_view"], s)[:2]]
        layout = Sh.pcf_layout(rows, s)
        if layout == Sh.PCF_U16_HALF:
            idx = [((y0 - 1) >> 1) * (s // 2) + ((x0 - 1) >> 1)]
        elif layout == Sh.PCF_U16_FULL:
            idx = [(y0 - 1) * s + x0 - 1]
        else:
            idx = [(y0 - 1) * s + x0 - 1, (y0 + 1) * s + x0 - 1]
        gathered["pcf"] = idx
        flops += pos[..., 0].numel() * SHADE_FLOPS_PER_PCF_SAMPLE
    row_bytes = {"spec": 16, "merged": 32, "pcf": 32}
    unique = {k: int(torch.unique(torch.cat([i.reshape(-1).to(torch.int64)
                                             for i in v])).numel())
              for k, v in gathered.items()}
    n_bytes += sum(row_bytes[k] * n for k, n in unique.items())
    return n_bytes, flops, {"lights": n_l, "sky_pixels": n_sky,
                            "unique_rows": unique}


def many_light_rows(lights, n_rows):
    """``lights``' first row (the scene's sun) and the first ``n_rows -
    1`` point lights of the benchmark's many-light layout over the
    40-unit plane (``benchmark/scenes/sponza_many_lights.py``), as
    GpuLight rows on ``lights``' device."""
    import numpy as np
    import torch

    from benchmark.scenes import sponza_many_lights
    from mo_renderer_tpu_torch.math.transform import Transform
    from mo_renderer_tpu_torch.scene.components import PointLight

    points = sponza_many_lights.points(1024, 20.0)[:n_rows - 1]
    rows = np.stack([PointLight(Transform.from_xyz(*p["position"]),
                                color=p["color"],
                                intensity=p["intensity"]).gpu_light()
                     for p in points])
    return torch.cat([lights[:1], torch.from_numpy(rows).to(
        lights.device)[:, :lights.shape[1]]])


def shading_ref_args(args, kwargs):
    """A recorded ``shading_pass`` call as the 7 positional arguments its
    kernel (``_shading_ref_cuda``) and its plain version
    (``_shading_ref_plain``) take."""
    import inspect

    from mo_renderer_tpu_torch.passes import shading as Sh

    bound = inspect.signature(Sh.shading_pass).bind(*args, **kwargs)
    bound.apply_defaults()
    return tuple(bound.arguments.values())


def _pack_anchor(x0, y0):
    """Texel anchors packed as K11's debug output packs them."""
    import torch

    v = ((y0.to(torch.int64) & 0xFFFF) << 16) | (x0.to(torch.int64) & 0xFFFF)
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def shading_ref_choices(args):
    """The plain version's discrete choices on a ``shading_pass`` call, as
    K11's debug output keeps them (``Sh.REF_DEBUG``: the PCF compare bits
    and beyond_far, the tap anchors, the cube faces, the lower mip level,
    the sample anchors; -1 where not evaluated), recomputed with the plain
    version's own torch ops; and the map texels its samples read, {map:
    (flat texel indices, bytes a texel)}."""
    import torch

    from mo_renderer_tpu_torch.device import sampling as Sm
    from mo_renderer_tpu_torch.kernels import brdf
    from mo_renderer_tpu_torch.passes import shading as Sh

    gbuf, _, smap, _, _, params, ibl = args
    h, w = gbuf.depth.shape
    dev = gbuf.depth.device
    out = torch.full((h, w, len(Sh.REF_DEBUG)), -1, dtype=torch.int32,
                     device=dev)
    sky = (gbuf.depth >= 1.0) if ibl is not None \
        else torch.zeros_like(gbuf.depth, dtype=torch.bool)
    lit = ~sky
    none = torch.tensor(-1, dtype=torch.int32, device=dev)
    texels = {}

    def axis(t, n, n_int=None):
        """The anchor floor(t * n - 0.5) and its two clamped indices."""
        n_int = n if n_int is None else n_int
        x0 = torch.floor(t * n - 0.5).to(torch.int32)
        lo = torch.clamp(x0, min=0), torch.clamp(x0 + 1, min=0)
        if torch.is_tensor(n_int):
            return (x0, *[torch.minimum(i, n_int - 1) for i in lo])
        return (x0, *[torch.clamp(i, max=n_int - 1) for i in lo])

    def sample(u, v, n, where, base=0, n_f=None):
        """A bilinear sample's packed anchor and its four texel rows at the
        pixels ``where``."""
        ax, x0, x1 = axis(u, n if n_f is None else n_f, n)
        ay, y0, y1 = axis(v, n if n_f is None else n_f, n)
        rows = [(base + yy * n + xx)[where] for yy in (y0, y1)
                for xx in (x0, x1)]
        return _pack_anchor(ax, ay), rows

    if smap is not None:
        p = torch.cat([gbuf.position, torch.ones_like(gbuf.position[..., :1])],
                      -1)
        lp = p @ params["light_proj_view"].t()
        wc = torch.where(lp[..., 3].abs() > 1e-20, lp[..., 3], 1.0)
        proj = lp[..., :3] / wc[..., None]
        uv = proj[..., :2] * 0.5 + 0.5
        current = proj[..., 2] - Sh.SHADOW_BIAS
        s = smap.shape[0]
        texel = 1.0 / s
        bits = (proj[..., 2] > 1.0).to(torch.int32) << 9
        rows = []
        for t, (dx, dy) in enumerate(Sh.POISSON):
            tap = torch.stack([uv[..., 0] + dx * texel,
                               uv[..., 1] + dy * texel], dim=-1)
            closest = Sm.sample_bilinear(smap[..., None], tap,
                                         Sm.CLAMP_TO_EDGE)[..., 0]
            bits = bits | ((current > closest).to(torch.int32) << t)
            anchor, r = sample(tap[..., 0], tap[..., 1], s, lit)
            out[..., 1 + t] = torch.where(lit, anchor, none)
            rows += r
        out[..., 0] = torch.where(lit, bits, none)
        texels["shadow"] = (rows, 4)
    if ibl is not None:
        mips = ibl.specular_mips
        nl = mips.num_levels
        sizes, offsets = Sm._level_tables(mips, dev)
        fn, un, vn = Sm.cube_face_uv(gbuf.normal)
        fr, ur, vr = Sm.cube_face_uv(brdf.ibl_reflection_dir(
            gbuf.position, gbuf.normal, params["eye_pos"]))
        fe, ue, ve = Sm.cube_face_uv(Sh._sky_dirs(h, w, params))
        out[..., 10] = torch.where(lit, fn | (fr << 4), fe << 8)
        lod = torch.clamp(gbuf.orm[..., 1] * Sh.MAX_REFLECTION_LOD, 0.0,
                          nl - 1)
        l0 = torch.floor(lod).to(torch.int32)
        l1 = torch.clamp(l0 + 1, max=nl - 1)
        out[..., 11] = torch.where(lit, l0, none)
        n_irr = ibl.irradiance_faces.shape[1]
        n_env = ibl.environment_faces.shape[1]
        got = {"irradiance": sample(un, vn, n_irr, lit, fn * n_irr * n_irr),
               "env": sample(ue, ve, n_env, sky, fe * n_env * n_env)}
        spec_rows = []
        for name, lvl in (("spec0", l0), ("spec1", l1)):
            n = sizes[lvl.to(torch.int64)]
            got[name] = sample(ur, vr, n, lit,
                               offsets[lvl.to(torch.int64)] + fr * n * n,
                               n.to(torch.float32))
            spec_rows += got[name][1]
        v = brdf.normalize(params["eye_pos"] - gbuf.position, eps=1e-20)
        ndotv = torch.clamp(brdf.dot3(gbuf.normal, v), min=0.0)
        lh, lw = ibl.brdf_lut.shape[:2]
        lax, lx0, lx1 = axis(ndotv, lw)
        lay, ly0, ly1 = axis(1.0 - gbuf.orm[..., 1], lh)
        out[..., 15] = torch.where(lit, _pack_anchor(lax, lay), none)
        for name, (anchor, _) in got.items():
            out[..., Sh.REF_DEBUG.index(name)] = torch.where(
                sky if name == "env" else lit, anchor, none)
        texels.update(
            irradiance=(got["irradiance"][1], 12), env=(got["env"][1], 12),
            spec=(spec_rows, 12),
            lut=([(yy * lw + xx)[lit] for yy in (ly0, ly1)
                  for xx in (lx0, lx1)], 8))
    return out, texels


def shading_ref_check(args):
    """K11 against its plain version on one call: (max |err|, ok, bar,
    {what: "n of N" apart}) -- the colour at SHADING_BAR and, through the
    debug output, the PCF taps, tap texels, cube faces, mip levels and
    sample texels that differ; ok needs every count 0."""
    import torch

    from mo_renderer_tpu_torch.passes import shading as Sh

    k, keep = Sh._shading_ref_cuda(*args, debug=True)
    err, ok, bar = shading_compare(k, Sh._shading_ref_plain(*args))
    want, _ = shading_ref_choices(args)
    got = keep["dbg"]
    pcf = (got[..., 0] ^ want[..., 0]) & 0x3FF
    n_pcf = int((want[..., 0] >= 0).sum())
    counts = {
        "pcf_taps": (int(sum(((pcf >> t) & 1).sum() for t in range(10))),
                     10 * n_pcf),
        "tap_texels": (int((got[..., 1:10] != want[..., 1:10]).sum()),
                       9 * n_pcf),
    }
    for c, name in ((10, "faces"), (11, "levels"),
                    (slice(12, None), "texels")):
        counts[name] = (int((got[..., c] != want[..., c]).sum()),
                        int((want[..., c] >= 0).sum()))
    ok = ok and all(n == 0 for n, _ in counts.values())
    return err, ok, bar, {k: f"{n} of {of}" for k, (n, of) in counts.items()}


def shading_ref_work(args):
    """(bytes, FP32 operations, what else to report) of K11 on ``args``:
    the depth of every pixel read and its colour written once, the
    G-buffer planes and SSAO of the lit pixels (with IBL a sky pixel reads
    neither), the light rows and camera once, and of each map the texels
    this run's samples read, each once (their unique flat indices)."""
    import torch

    gbuf, _, smap, lights, n_lights, _, ibl = args
    n_px = gbuf.depth.numel()
    n_sky = int((gbuf.depth >= 1.0).sum()) if ibl is not None else 0
    n_lit = n_px - n_sky
    n_l = min(lights.shape[0], n_lights)
    n_bytes = (n_px * 4 * (1 + 3) + n_lit * 4 * (5 * 3 + 1)
               + n_l * lights.shape[1] * 4 + 4 * 32)
    flops = n_lit * (SHADE_FLOPS_PER_PIXEL + SHADE_FLOPS_PER_LIGHT * n_l)
    if smap is not None:
        flops += n_lit * REF_FLOPS_PCF
    if ibl is not None:
        flops += n_lit * REF_FLOPS_IBL + n_sky * REF_FLOPS_SKY
    unique = {}
    for name, (rows, size) in shading_ref_choices(args)[1].items():
        unique[name] = int(torch.unique(torch.cat(
            [r.reshape(-1).to(torch.int64) for r in rows])).numel())
        n_bytes += unique[name] * size
    return n_bytes, flops, {"lights": n_l, "sky_pixels": n_sky,
                            "unique_texels": unique}


def tail_source(tri, z, src, params, scene, slot_map, stack_kernel=False):
    """Which of GBUFFER_SOURCES a ``gbuffer_tail`` call's inputs are (the
    band is made from the default path's call in phase 2)."""
    if src.mat_plane is not None:
        return "megakernel"
    if stack_kernel:
        return "stacks"
    # attr_planes' (C, H, W) planes, permuted: channels H*W apart
    return "planes" if src.world_pos.stride(-1) != 1 else "torch"


def tail_call_args(args, kwargs):
    """A recorded ``gbuffer_tail`` call as the 8 positional arguments its
    kernel (``_gbuffer_tail_cuda``) and plain version take."""
    import inspect

    from mo_renderer_tpu_torch.passes import gbuffer as GB

    bound = inspect.signature(GB.gbuffer_tail).bind(*args, **kwargs)
    bound.apply_defaults()
    tri, z, src, params, scene, slot_map, stack_kernel = \
        bound.arguments.values()
    return (tri, z, src, params["proj_view"], params["prev_proj_view"],
            scene, slot_map, stack_kernel)


def band_tail_call(seen):
    """The ``gbuffer_tail`` call of one of 4 bands of the default path's
    G-buffer (the one with the most covered pixels), as the row-sharded
    frame makes it: the band's rows of the visibility planes, its first
    row as ``y0``."""
    import mo_renderer_tpu_torch.passes.gbuffer as GB

    (tri, z, *rest), kw = seen["gbuffer_pass_fast"]
    hb = tri.shape[0] // 4 // 2 * 2
    b = max(range(4), key=lambda b: int((tri[b * hb:(b + 1) * hb] >= 0)
                                        .sum()))
    tri, z = tri[b * hb:], z[b * hb:]
    calls = []
    tail = GB.gbuffer_tail

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return tail(*args, **kwargs)

    GB.gbuffer_tail = record
    try:
        GB.gbuffer_pass_fast(tri[:hb], z[:hb], *rest,
                             **{**kw, "y0": b * hb})
    finally:
        GB.gbuffer_tail = tail
    return calls[0]


GBUFFER_BAR = ("each plane rtol 2e-3 / atol 1e-4, mask equal, depth passed "
               "through; 0 texel rows differ")
GBUFFER_FLOPS_PER_PIXEL = 270  # velocity, texel anchor, 11 channels, TBN


def gbuffer_compare(k, p):
    """K10's G-buffer against its plain version's: (max |err|, ok, bar)."""
    import torch

    from mo_renderer_tpu_torch.passes import gbuffer as GB

    err, ok = 0.0, bool(torch.equal(k.mask, p.mask)) and k.depth is p.depth
    for f in GB.GBUFFER_OUT:
        a, b = getattr(k, f), getattr(p, f)
        ok = ok and a.shape == b.shape and bool(
            torch.allclose(a, b, rtol=2e-3, atol=1e-4, equal_nan=True))
        diff = torch.where(torch.isnan(a) & torch.isnan(b), 0.0,
                           (a - b).abs())
        err = max(err, diff.nan_to_num(nan=float("inf")).max().item())
    return err, ok, GBUFFER_BAR


def gbuffer_rows(args):
    """The texture-stack rows of the plain version's bilinear anchors on a
    ``gbuffer_tail`` call, -1 where nothing is gathered (uncovered pixels,
    no sampled slot, the stack_planes kernel's path)."""
    import torch

    from mo_renderer_tpu_torch.assets import materials as M
    from mo_renderer_tpu_torch.passes import gbuffer as GB

    tri, _, src, _, _, scene, slot_map, stack_kernel = args
    none = torch.full_like(tri, -1)
    if stack_kernel or all(p < 0 for p in slot_map):
        return none
    used = M.fast_used_cols(slot_map)
    mat = src.mat_cols
    if mat is None:
        mat = scene.materials.index_select(
            1, GB._column_index(used, tri.device))[
                torch.round(src.mat_plane).to(torch.int64)]
    idx, _, _ = GB._stack_anchor(GB._vec(src.uv0),
                                 mat[..., used.index(M.MAT_STACK_BASE)],
                                 mat[..., used.index(M.MAT_STACK_SIZE)])
    return torch.where(tri >= 0, idx, none)


def gbuffer_check(args):
    """K10 against its plain version on one call: (max |err|, ok, bar,
    the texel rows that differ) -- the rows through the debug output."""
    from mo_renderer_tpu_torch.passes import gbuffer as GB

    k, keep = GB._gbuffer_tail_cuda(*args, debug=True)
    err, ok, bar = gbuffer_compare(k, GB._gbuffer_tail_plain(*args))
    want = gbuffer_rows(args)
    n = int((keep["row_out"] != want).sum())
    return err, ok and n == 0, bar, f"{n} of {int((want >= 0).sum())}"


def random_tail_call(source, slot_map, device, seed=0, h=16, w=48):
    """A ``gbuffer_tail`` call (its 8 positional arguments) on random inputs
    laid out as ``source`` (one of GBUFFER_SOURCES) has them: 6 materials
    with texture-stack entries of 2 to 16 texels a side, random RGBA8 quads,
    UVs in [-2, 3) (the REPEAT wrap both ways), handedness -1, 0 or 1,
    about one pixel in 8 uncovered, material ids with some exact halves
    (rounding half to even).  Made with numpy from ``seed``."""
    import types

    import numpy as np
    import torch

    from mo_renderer_tpu_torch.assets import materials as M

    rng = np.random.default_rng(seed)
    used = M.fast_used_cols(slot_map)
    sizes = np.array([4, 8, 16, 2, 8, 4])
    bases = np.concatenate([[0], np.cumsum(sizes ** 2)[:-1]])
    n_rows = int((sizes ** 2).sum())
    mats = rng.uniform(0.0, 1.0, (len(sizes), M.MATERIAL_STRIDE))
    mats[:, M.MAT_STACK_BASE] = bases
    mats[:, M.MAT_STACK_SIZE] = sizes
    mats = mats.astype(np.float32)

    def quads(width):
        return rng.integers(-2 ** 31, 2 ** 31, (n_rows, width),
                            dtype=np.int64).astype(np.int32)

    hh = h + 4 if source == "band" else h  # a band: rows 2.. of a frame
    tri = rng.integers(-1, 7, (hh, w)).astype(np.int32)
    mat_id = rng.integers(0, len(sizes), (hh, w))
    mat_f = mat_id + rng.choice([0.0, 0.25, -0.25, 0.5, -0.5], (hh, w))
    mat_f = np.clip(mat_f, 0.0, len(sizes) - 1).astype(np.float32)
    mat_id = np.rint(mat_f).astype(np.int64)  # what torch.round picks
    geo = rng.normal(size=(12, hh, w)).astype(np.float32)
    uv = rng.uniform(-2.0, 3.0, (2, hh, w)).astype(np.float32)
    handed = rng.choice([-1.0, 0.0, 1.0], (hh, w)).astype(np.float32)
    cols = mats[mat_id][..., list(used)].transpose(2, 0, 1)
    # projections whose w row keeps every point in front of the camera
    # (w in about [0.6, 1.4]), as a frame's do
    pv = rng.normal(size=(2, 4, 4))
    pv[:, 3, :3] *= 0.1
    pv[:, 3, 3] = 1.0
    pv = pv.astype(np.float32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    scene = types.SimpleNamespace(
        materials=t(mats), texture_stack_a=t(quads(8)),
        texture_stack_b=t(quads(8)), texture_stack_c=t(quads(4)))
    from mo_renderer_tpu_torch.passes import gbuffer as GB

    if source in ("planes", "band"):
        # attr_planes' layout: wp, n, t, bt, uv, mat_id, handed, columns
        planes = t(np.concatenate([geo, uv, mat_f[None], handed[None],
                                   cols]))

        def vec(a, b):
            return planes[a:b].permute(1, 2, 0)

        src = GB.TailInputs(vec(0, 3), vec(3, 6), vec(6, 9), vec(9, 12),
                            vec(12, 14), planes[15],
                            mat_cols=vec(16, planes.shape[0]))
        if source == "band":  # views of rows 2 .. h + 2
            src = GB.TailInputs(
                *[getattr(src, f)[2:h + 2] for f in (
                    "world_pos", "n_in", "t_in", "bt_in", "uv0", "handed")],
                mat_cols=src.mat_cols[2:h + 2])
    elif source in ("torch", "stacks"):
        # the attrs_plane_kernel=False branch: (H, W, k) tensors, the
        # material columns a slice of the gathered rows
        row = t(np.concatenate([geo, uv, handed[None], cols, uv],
                               ).transpose(1, 2, 0))
        src = GB.TailInputs(row[..., 0:3], row[..., 3:6], row[..., 6:9],
                            row[..., 9:12], row[..., 12:14], row[..., 14],
                            mat_cols=row[..., 15:15 + len(used)])
    else:
        planes = [t(p) for p in np.concatenate([geo, uv])]
        src = GB.TailInputs(tuple(planes[0:3]), tuple(planes[3:6]),
                            tuple(planes[6:9]), tuple(planes[9:12]),
                            tuple(planes[12:14]), t(np.abs(handed)),
                            handed_abs=False, mat_plane=t(mat_f))
    tri_t = t(tri)[2:h + 2] if source == "band" else t(tri)
    z = t(rng.uniform(0.0, 1.0, tri_t.shape).astype(np.float32))
    return (tri_t, z, src, t(pv[0]), t(pv[1]), scene, tuple(slot_map),
            source == "stacks")


def gbuffer_work(args):
    """(bytes, FP32 operations, covered pixels) of K10 on ``args``: the
    ids of every pixel read, the attribute channels and material columns
    of the covered pixels (or their material ids, and the used columns of
    the table once), the stack rows this run gathers (each row's quads
    once) or the stack_planes planes, the outputs written once."""
    import torch

    from mo_renderer_tpu_torch.assets import materials as M
    from mo_renderer_tpu_torch.passes import gbuffer as GB

    tri, _, src, _, _, scene, slot_map, stack_kernel = args
    n_px = tri.numel()
    covered = int((tri >= 0).sum())
    n_mat = len(M.fast_used_cols(slot_map))
    n_sampled = sum(1 for p in slot_map if p >= 0)
    n_bytes = 4 * n_px + 4 * 32 + covered * 4 * GB.N_GEO
    if src.mat_cols is not None:
        n_bytes += covered * 4 * n_mat
    else:
        n_bytes += covered * 4 + scene.materials.shape[0] * 4 * n_mat
    if stack_kernel:
        n_planes = sum(len(c) for k, c in enumerate(
            (GB.SLOT_CHANNELS)) if slot_map[k] >= 0)
        n_bytes += covered * 4 * n_planes
    elif n_sampled:
        rows = gbuffer_rows(args)
        n_rows = int(torch.unique(rows[rows >= 0]).numel())
        n_bytes += n_rows * 16 * n_sampled
    n_bytes += n_px * (4 * 17 + 1)
    return n_bytes, covered * GBUFFER_FLOPS_PER_PIXEL, covered


GBUFFER_REF_BAR = ("each plane rtol 2e-3 / atol 1e-4, mask equal, depth "
                   "passed through; 0 texel anchors or UV sets differ")
# K12, from csrc/gbuffer_ref.cu: per covered pixel the perspective
# correction (3 products, 2 adds, 3 divisions), 24 interpolated channels
# (5 each), 5 slots' texel coordinates (10 each) and 12 bilinear channels
# (13 each), the factors and srgb_to_linear, three normalizations and the
# TBN sum, and the velocity
GBUFFER_REF_FLOPS_PER_PIXEL = 420


def random_ref_inputs(seed=0, h=24, w=32, n_layers=4, size=8, slot_uv=None,
                      tangent=None):
    """Numpy inputs of ``gbuffer_pass`` (the reference sampling path's
    G-buffer) aimed at its discontinuities, made from ``seed``: {"tri",
    "z", "b0", "b1"} planes, a scene {"indices", "uv0", "uv1",
    "tri_mesh", "mesh_material", "materials", "textures"} and the vertex
    stage's outputs {"inv_w", "world_pos", ..., "has_tangent"}.

    - Vertices 0-2 have 1/w = 1e-20 and one ulp above and below (the |qs|
      > 1e-20 guard: triangles 0-2 put them at corner 0).
    - Vertices 3-8 have UVs on two texel centres, one ulp above and one
      below, in both UV sets, some shifted by whole periods (REPEAT past
      0 and 1), and triangles 3-8 one material; the other UVs are uniform
      in [-2, 3).
    - Pixels (0, 0..8) are triangles 0-8 at b = (1, 0, 0): their
      interpolated values are corner 0's exactly.
    - A material slot picks its UV set from 0.0, -0.0 (both UV set 0),
      1.0 and -1.0, or all from ``slot_uv`` (0 or 1); layers are floats
      that truncate; ``tangent`` sets every has_tangent (else random).
    - About a quarter of the pixels are uncovered (tri -1)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_verts, n_tris, n_meshes, n_mats = 40, 16, 5, 4
    f32 = np.float32
    indices = rng.integers(0, n_verts, (n_tris, 3)).astype(np.int32)
    indices[:9, 0] = np.arange(9)
    inv_w = rng.uniform(0.2, 2.0, n_verts).astype(f32)
    guard = f32(1e-20)
    inv_w[:3] = [guard, np.nextafter(guard, f32(1)),
                 np.nextafter(guard, f32(0))]
    uv = rng.uniform(-2.0, 3.0, (2, n_verts, 2)).astype(f32)
    k = rng.integers(0, size, (2, 2, 2))
    period = rng.choice([-2, -1, 0, 1, 2], (2, 2, 2))
    centre = ((k + 0.5) / size + period).astype(f32)
    uv[:, 3:5] = centre
    uv[:, 5:7] = np.nextafter(centre, f32(np.inf))
    uv[:, 7:9] = np.nextafter(centre, f32(-np.inf))
    tri = rng.integers(0, n_tris, (h, w)).astype(np.int32)
    tri[rng.uniform(size=(h, w)) < 0.25] = -1
    r0 = rng.uniform(0.0, 1.0, (h, w))
    b0 = r0.astype(f32)
    b1 = (rng.uniform(0.0, 1.0, (h, w)) * (1.0 - r0)).astype(f32)
    tri[0, :9], b0[0, :9], b1[0, :9] = np.arange(9), 1.0, 0.0
    mats = rng.uniform(0.0, 1.0, (n_mats, 48)).astype(f32)
    mats[:, 0:5] = rng.integers(0, n_layers, (n_mats, 5)) + rng.choice(
        [0.0, 0.25, 0.75], (n_mats, 5))
    if slot_uv is None:
        mats[:, 5:10] = rng.choice([0.0, -0.0, 1.0, -1.0], (n_mats, 5))
    else:
        mats[:, 5:10] = slot_uv
    has_tangent = (rng.uniform(size=n_verts) < 0.5 if tangent is None
                   else np.full(n_verts, tangent))

    def clip():
        c = rng.normal(size=(n_verts, 4)).astype(f32)
        c[:, 3] = rng.uniform(0.5, 2.0, n_verts)
        return c

    tri_mesh = rng.integers(0, n_meshes, n_tris).astype(np.int32)
    tri_mesh[3:9] = tri_mesh[3]  # one material: the anchors line up
    return {
        "tri": tri, "z": rng.uniform(0.0, 1.0, (h, w)).astype(f32),
        "b0": b0, "b1": b1,
        "scene": {
            "indices": indices, "uv0": uv[0], "uv1": uv[1],
            "tri_mesh": tri_mesh,
            "mesh_material": (rng.permutation(n_meshes) % n_mats).astype(
                np.int32),
            "materials": mats,
            "textures": rng.integers(0, 256, (n_layers, size, size, 4),
                                     dtype=np.uint8)},
        "vs": {
            "inv_w": inv_w,
            **{name: rng.normal(size=(n_verts, 3)).astype(f32) for name in (
                "world_pos", "world_normal", "world_tangent",
                "world_bitangent")},
            "clip": clip(), "prev_clip": clip(),
            "has_tangent": has_tangent},
    }


def ref_call(inputs, device):
    """``random_ref_inputs``' arrays as the 6 positional arguments of
    ``gbuffer_pass`` (and of its kernel and plain version) on
    ``device``."""
    import types

    import torch

    def t(a):
        return torch.from_numpy(a).to(device)

    return (t(inputs["tri"]), t(inputs["z"]), t(inputs["b0"]),
            t(inputs["b1"]),
            types.SimpleNamespace(**{k: t(v) for k, v in
                                     inputs["scene"].items()}),
            types.SimpleNamespace(**{k: t(v) for k, v in
                                     inputs["vs"].items()}))


def gbuffer_ref_choices(args):
    """The plain version's discrete choices on a ``gbuffer_pass`` call, as
    K12's debug output keeps them (``GB.REF_DEBUG``: each slot's flat
    texel anchor after the wrap, then the UV-set bits; -1 where
    uncovered), from the (layer, uv) each slot's sampler got in a run of
    ``_gbuffer_ref_plain``; and the flat indices of the texels its taps
    read at the covered pixels."""
    import torch

    from mo_renderer_tpu_torch.assets import materials as M
    from mo_renderer_tpu_torch.device import sampling as Sm
    from mo_renderer_tpu_torch.passes import gbuffer as GB

    tri, _, _, _, scene, _ = args
    seen = []
    sample = Sm.sample_array_bilinear

    def record(tex, layer, uv, mode):
        seen.append((layer, uv))
        return sample(tex, layer, uv, mode)

    Sm.sample_array_bilinear = record
    try:
        GB._gbuffer_ref_plain(*args)
    finally:
        Sm.sample_array_bilinear = sample
    covered = tri >= 0
    s = scene.textures.shape[1]
    out = torch.full((*tri.shape, len(GB.REF_DEBUG)), -1, dtype=torch.int32,
                     device=tri.device)
    rows = []
    for k, (layer, uv) in enumerate(seen):
        x0, y0, _, _ = Sm._floor_fract(uv, s, s)
        base = layer.to(torch.int32) * (s * s)
        xs = [Sm.wrap_index(x0 + d, s, Sm.REPEAT) for d in (0, 1)]
        ys = [Sm.wrap_index(y0 + d, s, Sm.REPEAT) for d in (0, 1)]
        out[..., k] = torch.where(covered, base + ys[0] * s + xs[0], -1)
        rows += [(base + yy * s + xx)[covered] for yy in ys for xx in xs]
    t = torch.clamp(tri, min=0).to(torch.int64)
    mat_id = scene.mesh_material.to(torch.int64)[
        scene.tri_mesh.to(torch.int64)[t]]
    uv_cols = scene.materials[:, M.MAT_BASE_COLOR_UV:M.MAT_EMISSIVE_UV + 1]
    set1 = (uv_cols != 0.0).to(torch.int32)[mat_id]
    bits = sum(set1[..., k] << k for k in range(5))
    out[..., len(seen)] = torch.where(covered, bits, -1)
    return out, rows


def gbuffer_ref_check(args):
    """K12 against its plain version on one call: (max |err|, ok, bar,
    {what: "n of N" apart}) -- the planes at GBUFFER_REF_BAR and, through
    the debug output, the texel anchors and UV sets that differ; ok needs
    both counts 0."""
    from mo_renderer_tpu_torch.passes import gbuffer as GB

    k, keep = GB._gbuffer_ref_cuda(*args, debug=True)
    err, ok, _ = gbuffer_compare(k, GB._gbuffer_ref_plain(*args))
    want, _ = gbuffer_ref_choices(args)
    got = keep["dbg"]
    n = int((want[..., -1] >= 0).sum())
    apart = {"texel_anchors": (int((got[..., :-1] != want[..., :-1]).sum()),
                               (got.shape[-1] - 1) * n),
             "uv_sets": (int((got[..., -1] != want[..., -1]).sum()), n)}
    ok = ok and all(m == 0 for m, _ in apart.values())
    return err, ok, GBUFFER_REF_BAR, {w: f"{m} of {of}" for w, (m, of)
                                      in apart.items()}


def gbuffer_ref_work(args):
    """(bytes, FP32 operations, what else to report) of K12 on ``args``:
    the ids of every pixel read and its 17 output floats and mask byte
    written once; the barycentrics of the covered pixels; the index row
    and mesh id of each triangle they show, the rows of the vertices of
    those triangles (1/w, 4 x 3 + 2 x 4 + 2 x 2 attribute floats,
    has_tangent), the material row (20 columns) of each material they
    show, and the texels their taps read, each once."""
    import torch

    from mo_renderer_tpu_torch.passes import gbuffer as GB

    tri, _, _, _, scene, _ = args
    covered = tri >= 0
    n_px, n_cov = tri.numel(), int(covered.sum())
    tris = torch.unique(tri[covered]).to(torch.int64)
    verts = torch.unique(scene.indices.to(torch.int64)[tris])
    mats = torch.unique(scene.mesh_material.to(torch.int64)[
        scene.tri_mesh.to(torch.int64)[tris]])
    texels = int(torch.unique(torch.cat(
        [r.reshape(-1) for r in gbuffer_ref_choices(args)[1]])).numel())
    vert_bytes = 4 * (1 + 4 * 3 + 2 * 4 + 2 * 2) + 1
    n_bytes = (n_px * (4 + 4 * 17 + 1) + n_cov * 8
               + tris.numel() * 4 * (3 + 1) + verts.numel() * vert_bytes
               + mats.numel() * (4 * GB.REF_MAT_COLS + 4) + texels * 4)
    return n_bytes, n_cov * GBUFFER_REF_FLOPS_PER_PIXEL, {
        "covered": n_cov, "triangles": tris.numel(),
        "vertices": verts.numel(), "materials": mats.numel(),
        "unique_texels": texels}


def capture_inputs(cfg, device, frames, want):
    """Render one frame per entry of ``frames`` -- (EngineConfig
    overrides, world factory, camera factory) -- and record what each
    kernel wrapper got (the first call per kernel: the eager warm-up of
    the frame's capture, statically binned as the graph is).  Returns
    {kernel: (args, kwargs)}; raises unless every kernel of ``want`` was
    called."""
    import mo_renderer_tpu_torch.passes.frame_graph as FG
    import mo_renderer_tpu_torch.passes.gbuffer as GB
    from mo_renderer_tpu_torch import Renderer

    seen = {}
    originals = {
        (FG, "rasterize"): FG.rasterize,
        (FG, "rasterize_attrs"): FG.rasterize_attrs,
        (GB, "attr_planes"): GB.attr_planes,
        (FG, "ssao_pass_tiles"): FG.ssao_pass_tiles,
        (FG, "reconstruct_present"): FG.reconstruct_present,
        (GB, "stack_planes"): GB.stack_planes,
        (FG, "shading_pass_fast"): FG.shading_pass_fast,
        (FG, "shading_pass"): FG.shading_pass,
        (GB, "gbuffer_tail"): GB.gbuffer_tail,
        (FG, "gbuffer_pass_fast"): FG.gbuffer_pass_fast,
        (FG, "gbuffer_pass"): FG.gbuffer_pass,
    }

    def recorder(key, fn):
        def wrapped(*args, **kw):
            name = key
            if key == "raster":
                name = ("raster_depth" if kw.get("depth_only") else
                        "raster_slim" if kw.get("slim") else "raster_full")
            elif key == "gbuffer":
                name = f"gbuffer/{tail_source(*args, **kw)}"
            seen.setdefault(name, (args, kw))
            return fn(*args, **kw)
        return wrapped

    FG.rasterize = recorder("raster", originals[(FG, "rasterize")])
    FG.rasterize_attrs = recorder(
        "raster_attrs", originals[(FG, "rasterize_attrs")])
    GB.attr_planes = recorder("attr_planes", originals[(GB, "attr_planes")])
    FG.ssao_pass_tiles = recorder(
        "ssao", originals[(FG, "ssao_pass_tiles")])
    FG.reconstruct_present = recorder(
        "interleave_present", originals[(FG, "reconstruct_present")])
    GB.stack_planes = recorder(
        "stack_planes", originals[(GB, "stack_planes")])
    FG.shading_pass_fast = recorder(
        "shading", originals[(FG, "shading_pass_fast")])
    FG.shading_pass = recorder("shading_ref", originals[(FG, "shading_pass")])
    GB.gbuffer_tail = recorder("gbuffer", originals[(GB, "gbuffer_tail")])
    FG.gbuffer_pass_fast = recorder(
        "gbuffer_pass_fast", originals[(FG, "gbuffer_pass_fast")])
    FG.gbuffer_pass = recorder("gbuffer_ref", originals[(FG, "gbuffer_pass")])
    try:
        for overrides, make_world, make_camera in frames:
            pcfg = dataclasses.replace(cfg, **overrides)
            world = make_world()
            world.insert_resource(make_camera(pcfg))
            renderer = Renderer(pcfg, device)
            renderer.prepare(world)
            renderer.render(world)
    finally:
        for (mod, attr), fn in originals.items():
            setattr(mod, attr, fn)
    missing = set(want) - set(seen)
    if missing:
        raise RuntimeError(f"the frames never called {sorted(missing)}")
    return seen


def check_kernels(cfg, device):
    """Phase 2: each CUDA kernel against its plain version on the card, on
    the inputs of the four paths' frames of the tiny scene and, for the
    raster modes, the megakernel and SSAO, of the stress scene."""
    import torch

    from mo_renderer_tpu_torch import scenes
    from mo_renderer_tpu_torch.kernels import attr_planes as AP
    from mo_renderer_tpu_torch.kernels import raster_setup as RS
    from mo_renderer_tpu_torch.kernels import rasterizer as R
    from mo_renderer_tpu_torch.kernels import stack_planes as SP
    from mo_renderer_tpu_torch.parallel import tile_sharding as TS
    from mo_renderer_tpu_torch.passes import checkerboard as CB
    from mo_renderer_tpu_torch.passes import gbuffer as GB
    from mo_renderer_tpu_torch.passes import present as P
    from mo_renderer_tpu_torch.passes import shading as Sh
    from mo_renderer_tpu_torch.passes import ssao as S

    results = {}

    def bytes_of(x):
        return x.contiguous().view(torch.uint8).to(torch.int32)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def exact(a, b):
        return (a.double() - b.double()).abs().max().item()

    def live_pairs(binned):
        return int(binned.tile_count.sum())

    def raster_inputs(binned):
        # the pairs in the runs: a statically binned frame's slots past
        # them are never read
        return nbytes(binned.tri_data, binned.tile_start, binned.tile_count,
                      binned.bbox) + 4 * live_pairs(binned)

    def candidates(binned):
        """(triangle, pixel) tests this run's data needs: the pixels of
        every binned triangle's bounding box."""
        bb = binned.bbox.to(torch.int64)
        live = (binned.tri_data[:, RS.COL_VALID] > 0) & (bb[:, 0] <= bb[:, 2])
        area = (bb[:, 2] - bb[:, 0] + 1) * (bb[:, 3] - bb[:, 1] + 1)
        return int(torch.where(live, area, 0).sum())

    def no_geometry(p):
        """The pixels a frame's raster output (ids, depth, ...) leaves
        without geometry (depth 1): the sky."""
        return int((p[1] >= 1.0).sum())

    def run_stats(binned):
        return {"pairs": live_pairs(binned),
                "slots": binned.pair_tri.shape[0],
                "max_tile_count": int(binned.tile_count.max())}

    # each case: kernel, plain, cmp -> (max_abs_err, ok, bar), shape,
    # bytes moved, FP32 operations, and what else to report
    def raster(seen, mode):
        (binned,), kw = seen[f"raster_{mode}"]
        w, h = kw["width"], kw["height"]
        stats = run_stats(binned)
        shape = (f"{h}x{w}, {stats['pairs']} pairs, largest run "
                 f"{stats['max_tile_count']}")
        n_out = {"depth": 1, "slim": 2, "full": 4}[mode]
        flops = candidates(binned) * RASTER_FLOPS_PER_CANDIDATE
        if mode == "full":
            flops += FULL_FLOPS_PER_PIXEL * w * h

        def cmp(k, p):
            err = exact(k[1], p[1])
            ok = err == 0.0
            if mode != "depth":
                ok = ok and bool(torch.equal(k[0], p[0]))
            if mode == "full":
                err = max(err, exact(k[2], p[2]), exact(k[3], p[3]))
                ok = ok and err <= 1e-6
            bar = {"depth": "depth exact", "slim": "ids and depth exact",
                   "full": "ids and depth exact, b0/b1 atol 1e-6"}[mode]
            return err, ok, bar
        return dict(
            kernel=lambda: R._raster_cuda(binned, w, h, mode),
            plain=lambda: R._raster_plain(binned, w, h, mode),
            cmp=cmp, shape=shape,
            bytes=raster_inputs(binned) + n_out * 4 * w * h, flops=flops,
            extra=stats, sky=None if mode == "depth" else no_geometry,
        )

    def raster_attrs(seen):
        (binned,), kw = seen["raster_attrs"]
        w, h, attr_rows = kw["width"], kw["height"], kw["attr_rows"]

        def cmp(k, p):
            ids = torch.equal(k[0], p[0])
            flat = torch.equal(k[2][R.N_INTERP:], p[2][R.N_INTERP:])
            z_err = exact(k[1], p[1])
            err = max(z_err, exact(k[2][:R.N_INTERP], p[2][:R.N_INTERP]))
            close = bool(torch.allclose(k[2], p[2], rtol=2e-3, atol=1e-4))
            return err, ids and flat and z_err <= 1e-6 and close, (
                "ids, mat, handedness exact; z atol 1e-6; "
                "planes rtol 2e-3 / atol 1e-4")
        covered = None

        def plain():
            nonlocal covered
            out = R._raster_attrs_plain(binned, attr_rows, w, h)
            covered = int((out[0] >= 0).sum())
            return out
        out = plain()
        flops = (candidates(binned) * RASTER_FLOPS_PER_CANDIDATE
                 + ATTRS_FLOPS_PER_PIXEL * covered)
        n_in = raster_inputs(binned) + nbytes(attr_rows)
        return dict(
            kernel=lambda: R._raster_attrs_cuda(binned, attr_rows, w, h),
            plain=plain, cmp=cmp,
            shape=f"{h}x{w}, {live_pairs(binned)} pairs, "
            f"{binned.tri_data.shape[1]} + {attr_rows.shape[1]}-float rows "
            f"-> {out[2].shape[0]} planes",
            bytes=n_in + (2 + out[2].shape[0]) * 4 * w * h, flops=flops,
            extra=run_stats(binned), sky=no_geometry,
        )

    def attr(seen):
        (tri, attrs, pv), kw = seen["attr_planes"]
        args = (tri, attrs, pv, kw["n_mat"], kw["full_wh"], kw["cb"], 0)
        n_out = AP.n_planes(kw["n_mat"])

        def cmp(k, p):
            err = (k - p).abs().max().item()
            ok = bool(torch.allclose(k, p, rtol=2e-3, atol=1e-4,
                                     equal_nan=True))
            return err, ok, "rtol 2e-3 / atol 1e-4"
        return dict(
            kernel=lambda: AP._attr_planes_cuda(*args),
            plain=lambda: AP._attr_planes_plain(*args),
            cmp=cmp, shape=f"{tuple(tri.shape)} -> {n_out} planes",
            bytes=nbytes(tri, attrs, pv) + n_out * 4 * tri.numel(),
            flops=ATTR_PLANES_FLOPS_PER_PIXEL * tri.numel(),
            sky=lambda p: int((tri < 0).sum()),
        )

    def occluding_taps(depth, near, far):
        """How many (pixel, tap) pairs occlude (centre more than 0.001 of
        linear depth behind the tap, read as the plain version reads it):
        the taps whose compare takes a square root."""
        h, w = depth.shape
        offs, _, edges = S._tables(w, S.NUM_LEVELS, depth.device)[:3]
        d_lin = S._linear_depth(depth, near, far)
        iy = torch.arange(h, device=depth.device)[:, None]
        ix = torch.arange(w, device=depth.device)[None, :]
        lvl = (S._radii(d_lin, w, h)[0][..., None] > edges).sum(-1)
        n = 0
        for t in range(offs.shape[1]):
            o = offs[lvl, t].to(torch.int64)
            tap = d_lin[torch.clamp(iy + o[..., 1], 0, h - 1),
                        torch.clamp(ix + o[..., 0], 0, w - 1)]
            n += int((d_lin - tap > 0.001).sum())
        return n

    def ssao(seen):
        (depth,), kw = seen["ssao"]
        args = (depth, S.NUM_LEVELS, 0, kw["near"], kw["far"])
        n_taps = max(len(t) for t in S._ssao_tap_table(
            depth.shape[1], S.NUM_LEVELS)[1])

        def cmp(k, p):
            err = (k - p).abs().max().item()
            frac = (k != p).float().mean().item()
            return err, err <= 1.01 / 255 and frac < 0.002, (
                f"<= 1.01/255 on < 0.2% of pixels ({frac:.5%} differ)")
        n_occluding = occluding_taps(depth, kw["near"], kw["far"])
        return dict(
            kernel=lambda: S._ssao_cuda(*args),
            plain=lambda: S._ssao_plain(*args),
            cmp=cmp, shape=f"{tuple(depth.shape)}, "
            f"{n_occluding / (n_taps * depth.numel()):.1%} of taps occlude",
            bytes=2 * nbytes(depth),
            flops=ssao_flop_equivalents(depth.numel(), n_taps, n_occluding),
            extra={"occluding_taps": n_occluding},
            sky=lambda p: int((depth >= 1.0).sum()),
        )

    def interleave(seen, fused):
        """K5's two entries on the frame's shaded colour: the fused one as
        the frame calls it, the packed one on ``present_pass`` of it."""
        (color, tri), _ = seen["interleave_present"]
        cb = color if fused else P.present_pass(color)
        extra = {}
        if fused:
            # what the fused entry took in: present_pass's torch launches
            extra["present_pass_ms"] = median_ms(
                lambda: P.present_pass(color))

        def cmp(k, p):
            err = (bytes_of(k) - bytes_of(p)).abs().max().item()
            return err, err == 0, "exact"

        def plain():
            return CB._reconstruct_plain(
                P.present_pass(color) if fused else cb, tri)
        return dict(
            kernel=lambda: CB._reconstruct_cuda(cb, tri), plain=plain,
            cmp=cmp, shape=f"{tuple(cb.shape)} {cb.dtype} -> "
            f"{tuple(tri.shape)}",
            bytes=nbytes(cb, tri, tri), flops=0, extra=extra,
            sky=lambda p: int((tri < 0).sum()),
        )

    def stack(seen):
        (idx, fx, fy, groups, spec), _ = seen["stack_planes"]
        args = (idx, fx, fy, groups, spec)
        # the sky of the same frame: its G-buffer tail's triangle ids
        tri = tail_call_args(*seen["gbuffer/stacks"])[0]
        widths = "/".join(str(g.shape[1]) for g in groups)

        def cmp(k, p):
            err = exact(k, p)
            return err, err <= 1e-6, "exact expected, atol 1e-6"
        # each input read once (the group tables whole), each plane
        # written once
        return dict(
            kernel=lambda: SP._stack_planes_cuda(*args),
            plain=lambda: SP._stack_planes_plain(*args),
            cmp=cmp, shape=f"{tuple(idx.shape)}, groups {widths} wide "
            f"({groups[0].shape[0]} rows) -> {len(spec)} planes",
            bytes=nbytes(idx, fx, fy, *groups) + len(spec) * 4 * idx.numel(),
            flops=(STACK_FLOPS_PER_PIXEL + STACK_FLOPS_PER_PLANE * len(spec))
            * idx.numel(), sky=lambda p: int((tri < 0).sum()),
        )

    def listed(binned):
        """The triangle ids of the runs (the capacity's slots past them
        are never read)."""
        return binned.pair_tri[:live_pairs(binned)].to(torch.int64)

    def band_inputs(binned, n_rows):
        """Bytes a band launch must read: the rows and boxes of the
        triangles in its runs, its pairs, its bin rows' run entries."""
        n_tri = int(torch.unique(listed(binned)).numel())
        return (n_tri * (4 * RS.TRI_STRIDE + 16) + 4 * live_pairs(binned)
                + 8 * n_rows * binned.n_tiles_x)

    def band_candidates(binned, y0, y1):
        """(triangle, pixel) tests of a band: the pixels of the boxes of
        the triangles in its runs, inside its rows."""
        ids = torch.unique(listed(binned))
        bb = binned.bbox[ids].to(torch.int64)
        rows = (bb[:, 3].clamp(max=y1 - 1) - bb[:, 1].clamp(min=y0) + 1)
        cols = bb[:, 2] - bb[:, 0] + 1
        return int((rows.clamp(min=0) * cols.clamp(min=0)).sum())

    split_depth = {}  # the 4 slim bands' depth, SSAO's input in bands

    def raster_band(seen, mode):
        """K1b/K2b: the captured frame's raster cut into N_BANDS bands as
        TileShardedRenderer cuts it (the shadow map into whole bin rows)."""
        (binned,), kw = seen[f"raster_{mode}"]
        w, h = kw["width"], kw["height"]
        if mode == "slim":
            step = TS.band_rows(cfg, N_BANDS)
        elif TS.shadow_bands_divisible(cfg, N_BANDS):
            step = N_BANDS * R.BIN_H
        else:
            raise AssertionError(f"a {h}^2 shadow map does not split into "
                                 f"{N_BANDS} bands of whole bin rows")
        split = -(-h // step) * step
        rows = split // N_BANDS // R.BIN_H  # bin rows of a band
        hb = rows * R.BIN_H
        setup = RS.TriangleSetup(binned.tri_data, binned.bbox)
        grid = dict(tile_h=R.BIN_H, tile_w=R.BIN_W,
                    n_tiles_x=binned.n_tiles_x, n_tiles_y=split // R.BIN_H,
                    binned_cap=binned.pair_tri.shape[0])
        local = [RS.bin_triangles(setup, **grid, band_row0=b * rows,
                                  band_tile_rows=rows)
                 for b in range(N_BANDS)]

        def launch(fn, bins_list):
            return [fn(bins, w, hb, mode, b * rows)
                    for b, bins in enumerate(bins_list)]

        # the bands together are the whole-frame kernel's output, from the
        # whole frame's bins (over the split canvas) and from band-local
        # bins; rows past the frame are background
        whole = R._raster_cuda(binned, w, h, mode)
        whole_bins = RS.bin_triangles(setup, **grid)
        for what, bins_list in (("whole-frame", [whole_bins] * N_BANDS),
                                ("band-local", local)):
            out = launch(R._raster_band_cuda, bins_list)
            z = torch.cat([o[1] for o in out])
            same = torch.equal(z[:h], whole[1]) and bool((z[h:] == 1).all())
            if mode == "slim":
                tri = torch.cat([o[0] for o in out])
                same = (same and torch.equal(tri[:h], whole[0])
                        and bool((tri[h:] == -1).all()))
            if not same:
                raise AssertionError(
                    f"raster_{mode}_band: {N_BANDS} bands from {what} bins "
                    "differ from the whole-frame kernel")
        if mode == "slim":
            split_depth["z"] = z

        def cmp(k, p):
            err = max(exact(a[1], b[1]) for a, b in zip(k, p))
            ok = err == 0.0 and (mode == "depth" or all(
                torch.equal(a[0], b[0]) for a, b in zip(k, p)))
            return err, ok, (f"ids and depth exact in each band; the "
                             f"{N_BANDS} bands = the whole-frame kernel")
        n_out = 1 if mode == "depth" else 2
        sky = None
        if mode == "slim":  # rows past the frame are no part of it
            def sky(p):
                return no_geometry((None, torch.cat([o[1] for o in p])[:h]))
        band_ms = [median_ms(functools.partial(
            R._raster_band_cuda, bins, w, hb, mode, b * rows))
            for b, bins in enumerate(local)]
        return dict(
            kernel=lambda: launch(R._raster_band_cuda, local),
            plain=lambda: launch(R._raster_plain, local), cmp=cmp,
            shape=f"{N_BANDS} x {hb}x{w} of {h}x{w}",
            bytes=sum(band_inputs(bins, rows) for bins in local)
            + N_BANDS * n_out * 4 * w * hb,
            flops=RASTER_FLOPS_PER_CANDIDATE * sum(
                band_candidates(bins, b * hb, (b + 1) * hb)
                for b, bins in enumerate(local)),
            extra={"pairs": sum(live_pairs(b) for b in local),
                   "band_rows": hb, "band_ms": band_ms}, sky=sky,
        )

    def ssao_halo(seen):
        """K4b: SSAO of the 4 slim bands' full-rate depth, each band with
        its neighbours' rows as halos (edge rows replicated outside)."""
        z = split_depth["z"]
        h_frame = seen["raster_slim"][1]["height"]
        near, far = seen["ssao"][1]["near"], seen["ssao"][1]["far"]
        n_rows, w = z.shape
        hb, hr = n_rows // N_BANDS, S.ssao_halo_rows(w)
        ext = torch.cat([z[:1].expand(hr, w), z, z[-1:].expand(hr, w)])
        bands = [(z[b * hb: (b + 1) * hb],
                  (ext[b * hb: b * hb + hr].contiguous(),
                   ext[(b + 1) * hb + hr: (b + 1) * hb + 2 * hr]
                   .contiguous()))
                 for b in range(N_BANDS)]

        def kernel():
            return [S._ssao_halo_cuda(band, halo, S.NUM_LEVELS, b * hb, near,
                                      far)
                    for b, (band, halo) in enumerate(bands)]

        def plain():
            return [S._ssao_plain(band, S.NUM_LEVELS, b * hb, near, far, halo)
                    for b, (band, halo) in enumerate(bands)]
        whole = S._ssao_cuda(z, S.NUM_LEVELS, 0, near, far)
        if not torch.equal(torch.cat(kernel()), whole):
            raise AssertionError(f"ssao_halo: {N_BANDS} bands differ from "
                                 "the whole-image kernel")

        def cmp(k, p):
            err = max(exact(a, b) for a, b in zip(k, p))
            return err, err == 0.0, (f"exact in each band; the {N_BANDS} "
                                     "bands = the whole-image kernel")
        n_taps = max(len(t) for t in S._ssao_tap_table(w, S.NUM_LEVELS)[1])
        n_occluding = occluding_taps(z, near, far)
        return dict(
            kernel=kernel, plain=plain, cmp=cmp,
            shape=f"{N_BANDS} x ({hb}+2x{hr})x{w}, "
            f"{n_occluding / (n_taps * z.numel()):.1%} of taps occlude",
            bytes=N_BANDS * 4 * w * (2 * hb + 2 * hr),
            flops=ssao_flop_equivalents(z.numel(), n_taps, n_occluding),
            extra={"occluding_taps": n_occluding, "band_rows": hb,
                   "halo_rows": hr,
                   # the whole-image kernel on the same plane, one launch
                   "whole_image_ms": median_ms(functools.partial(
                       S._ssao_cuda, z, S.NUM_LEVELS, 0, near, far))},
            sky=lambda p: int((z[:h_frame] >= 1.0).sum()),
        )

    def shading(seen):
        """K9 on the frame's own call (the checkerboard domain, the PCF
        table and divisor, the spec flags and the lights it was given)."""
        args = shading_args(*seen["shading"])
        n_bytes, n_flops, extra = shading_work(args)
        extra["choices"] = shading_taps_check(args)
        print(f"[2] shading choices apart: {extra['choices']}", flush=True)
        gbuf = args[0]
        return dict(
            kernel=lambda: Sh._shading_fast_cuda(*args),
            plain=lambda: Sh._shading_fast_plain(*args),
            cmp=shading_compare,
            shape=f"{tuple(gbuf.depth.shape)} (cb {args[12]}), PCF "
            f"{tuple(args[2].shape)} {args[2].dtype} / {args[8]}, "
            f"{extra['lights']} light(s)",
            bytes=n_bytes, flops=n_flops, extra=extra,
        )

    def shading_ref(seen):
        """K11 on the reference path's call (its G-buffer, SSAO, raw
        shadow map, IBL maps and lights), with its discrete choices through
        the debug output (``shading_ref_check``)."""
        args = shading_ref_args(*seen["shading_ref"])
        err, ok, bar, apart = shading_ref_check(args)
        print(f"[2] shading_ref choices apart: {apart}", flush=True)
        if not ok:
            raise AssertionError(f"shading_ref: kernel disagrees with its "
                                 f"plain version (max |err| {err}, {apart})")
        n_bytes, n_flops, extra = shading_ref_work(args)
        extra["apart"] = apart
        gbuf = args[0]
        return dict(
            kernel=lambda: Sh._shading_ref_cuda(*args),
            plain=lambda: Sh._shading_ref_plain(*args),
            cmp=shading_compare,
            shape=f"{tuple(gbuf.depth.shape)}, shadow "
            f"{tuple(args[2].shape)}, {extra['lights']} light(s)",
            bytes=n_bytes, flops=n_flops, extra=extra,
        )

    def gbuffer(seen):
        """K10 on the default path's call; on every source's call (the
        band's from the default path's) against its plain version with the
        texel rows through the debug output, reported as ``sources``."""
        calls = {src: tail_call_args(*seen[f"gbuffer/{src}"])
                 for src in GBUFFER_SOURCES if f"gbuffer/{src}" in seen}
        calls["band"] = tail_call_args(*band_tail_call(seen))
        sources = {}
        for src, a in calls.items():
            err, ok, bar, rows = gbuffer_check(a)
            sources[src] = {"shape": list(a[0].shape), "max_abs_err": err,
                            "texel_rows_differ": rows,
                            "sky_pixels": int((a[0] < 0).sum())}
            print(f"[2] gbuffer {src}: {tuple(a[0].shape)}, max |err| "
                  f"{err:.3g} ({bar}), texel rows differ: {rows}",
                  flush=True)
            if not ok:
                raise AssertionError(f"gbuffer {src}: kernel disagrees "
                                     f"with its plain version (max |err| "
                                     f"{err}, texel rows differ {rows})")
        args = calls["planes"]
        n_bytes, n_flops, covered = gbuffer_work(args)
        return dict(
            kernel=lambda: GB._gbuffer_tail_cuda(*args),
            plain=lambda: GB._gbuffer_tail_plain(*args),
            cmp=gbuffer_compare,
            shape=f"{tuple(args[0].shape)}, {covered} covered, slot map "
            f"{args[6]}",
            bytes=n_bytes, flops=n_flops,
            extra={"covered": covered, "sources": sources},
            sky=lambda p: sources["planes"]["sky_pixels"],
        )

    def gbuffer_ref(seen):
        """K12 on the reference path's call (K6's planes, the scene's
        tables and texture array, the vertex stage's outputs), with its
        texel anchors and UV sets through the debug output
        (``gbuffer_ref_check``)."""
        args, _ = seen["gbuffer_ref"]
        err, ok, bar, apart = gbuffer_ref_check(args)
        print(f"[2] gbuffer_ref choices apart: {apart}", flush=True)
        if not ok:
            raise AssertionError(f"gbuffer_ref: kernel disagrees with its "
                                 f"plain version (max |err| {err}, {apart})")
        n_bytes, n_flops, extra = gbuffer_ref_work(args)
        extra["apart"] = apart
        return dict(
            kernel=lambda: GB._gbuffer_ref_cuda(*args),
            plain=lambda: GB._gbuffer_ref_plain(*args),
            cmp=lambda k, p: (*gbuffer_compare(k, p)[:2], GBUFFER_REF_BAR),
            shape=f"{tuple(args[0].shape)}, {extra['covered']} covered, "
            f"{extra['triangles']} triangles, texture array "
            f"{tuple(args[4].textures.shape)}",
            bytes=n_bytes, flops=n_flops, extra=extra,
            sky=lambda p: int((args[0] < 0).sum()),
        )

    def many_lights(name, seen):
        """K9 or K11 on its ``@lit`` call with 1025 light rows
        (``many_light_rows``): the light loop at two chunks."""
        ref = name == "shading_ref"
        args = list(shading_ref_args(*seen["shading_ref"]) if ref
                    else shading_args(*seen["shading"]))
        at = 3 if ref else 4
        args[at], args[at + 1] = many_light_rows(args[at], 1025), 1025
        args = tuple(args)
        n_bytes, n_flops, extra = (shading_ref_work if ref
                                   else shading_work)(args)
        kernel, plain = ((Sh._shading_ref_cuda, Sh._shading_ref_plain)
                         if ref else
                         (Sh._shading_fast_cuda, Sh._shading_fast_plain))
        return dict(
            kernel=lambda: kernel(*args), plain=lambda: plain(*args),
            cmp=shading_compare,
            shape=f"{tuple(args[0].depth.shape)}, {extra['lights']} "
            "light rows", bytes=n_bytes, flops=n_flops, extra=extra,
            plain_runs=1)

    case_of = {
        "raster_slim": functools.partial(raster, mode="slim"),
        "raster_depth": functools.partial(raster, mode="depth"),
        "attr_planes": attr, "ssao": ssao,
        "interleave": functools.partial(interleave, fused=False),
        "interleave_present": functools.partial(interleave, fused=True),
        "raster_full": functools.partial(raster, mode="full"),
        "raster_attrs": raster_attrs, "stack_planes": stack,
        "raster_slim_band": functools.partial(raster_band, mode="slim"),
        "raster_depth_band": functools.partial(raster_band, mode="depth"),
        "ssao_halo": ssao_halo,  # after raster_slim_band: its depth
        "shading": shading,
        "gbuffer": gbuffer,
        "shading_ref": shading_ref,
        "gbuffer_ref": gbuffer_ref,
    }
    # K10's sources: each path's own, and the attrs_plane_kernel=False
    # branch on its own (the stacks path is that branch with K7)
    tail_want = {f"gbuffer/{src}" for src in GBUFFER_SOURCES[:4]}
    seen = capture_inputs(
        cfg, device,
        [(overrides, functools.partial(scenes.tiny_world, **scene_kw),
          scenes.camera) for overrides, _, scene_kw in PATHS.values()]
        + [({"attrs_plane_kernel": False}, scenes.tiny_world,
            scenes.camera)],
        set(KERNELS) - {"interleave", "gbuffer", *BAND_KERNELS} | tail_want,
    )
    cases = {name: build(seen) for name, build in case_of.items()}
    seen = capture_inputs(
        cfg, device,
        [(overrides, scenes.grid_world, scenes.grid_camera)
         for overrides, _ in GRID_PATHS.values()]
        + [(overrides, scenes.grid_world, scenes.grid_camera)
           for overrides in ({"attrs_plane_kernel": False}, STACKS)],
        set(GRID_KERNELS) - {"gbuffer"} | tail_want,
    )
    for name in GRID_KERNELS + BAND_GRID_KERNELS:
        # the plain raster walks 4096 pairs x 4096 pixels at a time: a few
        # timed calls are enough
        cases[f"{name}@grid"] = {**case_of[name](seen), "plain_runs": 3}
    seen = capture_inputs(
        cfg, device,
        [(overrides, scenes.grid_world, scenes.lit_camera)
         for overrides in [o for o, _ in LIT_PATHS.values()]
         + [{"attrs_plane_kernel": False}, STACKS]],
        set(LIT_KERNELS) - {"gbuffer", *BAND_KERNELS} | tail_want,
    )
    for name in LIT_KERNELS:
        cases[f"{name}@lit"] = {**case_of[name](seen), "plain_runs": 3}
    for name in MANY_LIGHT_KERNELS:
        cases[f"{name}@lit/1025"] = many_lights(name, seen)

    # what the events read for a kernel that does next to nothing
    one = torch.zeros(1, device=device)
    print(f"[2] floor of the timing: a 1-element add reads "
          f"{median_ms(lambda: one.add_(1.0)):.4f} ms", flush=True)
    for name, case in cases.items():
        kern, plain = case["kernel"], case["plain"]
        k_out, p_out = kern(), plain()
        torch.cuda.synchronize()
        err, ok, bar = case["cmp"](k_out, p_out)
        extra = case.get("extra", {})
        if case.get("sky") is not None:
            extra["sky_pixels"] = case["sky"](p_out)
        del k_out, p_out
        ms = median_ms(kern)
        plain_ms = median_ms(plain, runs=case.get("plain_runs", 20))
        n_bytes, n_flops = case["bytes"], case["flops"]
        bound_ms, bound_by = bound(n_bytes, n_flops)
        print(f"[2] {name:17s} {case['shape']}: max |err| {err:.3g} ({bar}) "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms by {bound_by} ({n_bytes / 1e6:.2f} MB, "
              f"{n_flops / 1e6:.1f} MFLOP) {extra}", flush=True)
        if not ok:
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version (max |err| {err}, bar: {bar})")
        skies = [extra.get("sky_pixels")] + [
            v["sky_pixels"] for v in extra.get("sources", {}).values()]
        if name.endswith("@lit") and any(n != 0 for n in skies):
            raise AssertionError(f"{name}: {skies} sky pixels, want none")
        results[name] = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            # no single PyTorch call computes any of these functions
            "library_ms": None, **extra,
        }
    return results


def shading_option_calls(cfg, device, lit=False):
    """K9's calls beyond the paths' own, {what: the 15 arguments}: each
    knob set of ``scenes.BUDGET_BOUNDS`` and the full-rate frame on the
    port's twin of the reference's budget scene (checkerboard on and off,
    PCF divisors 1/2/4, u16 windows at every texel and at even texels,
    each spec_* branch, half-rate SSAO), then the production knob set's
    call with the f32 wide-row PCF table, without IBL, without shadow, and
    its second of 4 bands as the rows path shades it (views of the band's
    G-buffer rows, its first row, the frame's height).  ``lit``: the same
    on scenes.grid_world(10) from scenes.lit_camera.  ``cfg`` gives the
    frame size."""
    import mo_renderer_tpu_torch.passes.frame_graph as FG
    from mo_renderer_tpu_torch import Renderer, scenes
    from mo_renderer_tpu_torch.passes.gbuffer import GBuffer
    from mo_renderer_tpu_torch.scene.scene_buffers import find_shadow_light

    base = dataclasses.replace(cfg, checkerboard=False, ssao_res_divisor=1)
    world = scenes.grid_world() if lit else scenes.budget_world()
    camera = scenes.lit_camera if lit else scenes.camera
    r = Renderer(base, device)
    r.prepare(world)
    light_pv, _ = find_shadow_light(world)
    params = FG.build_camera_params(camera(base), light_pv, device)
    ibl = r.ibl.maps()
    production = scenes.budget_config(base, (4, True, True, True, True, 2,
                                             True))
    configs = {str(k): scenes.budget_config(base, k) for k in
               (scenes.BUDGET_ORACLE, *scenes.BUDGET_BOUNDS)}
    configs["production, pcf_u16=False"] = dataclasses.replace(
        production, pcf_u16=False)
    calls = {}
    shade = FG.shading_pass_fast

    def record(*args, **kwargs):
        calls[what] = shading_args(args, kwargs)
        return shade(*args, **kwargs)

    FG.shading_pass_fast = record
    try:
        for what, c in configs.items():
            FG.frame_program(
                r.scene, ibl, params, cfg=c, pad_w=r.pad_w, pad_h=r.pad_h,
                binned_cap=r._binned_cap, has_shadow_light=True,
                slot_map=r._slot_map, n_lights=r._n_lights, fast=True)
    finally:
        FG.shading_pass_fast = shade
    prod = list(calls[str((4, True, True, True, True, 2, True))])
    calls["production, no IBL"] = tuple(prod[:7] + [None] + prod[8:])
    calls["production, no shadow"] = tuple(prod[:2] + [None] + prod[3:])
    # the rows path's band: views of the G-buffer and SSAO rows
    gbuf, h = prod[0], prod[0].depth.shape[0]
    hb = h // 4 // 2 * 2
    band = GBuffer(*[getattr(gbuf, f.name)[hb:2 * hb]
                     for f in dataclasses.fields(gbuf)])
    calls["production, band 2 of 4"] = tuple(
        [band, prod[1][hb:2 * hb]] + prod[2:13] + [hb, h])
    return calls


def check_shading_options(cfg, device, lit=False):
    """Phase 2, K9 beyond the paths' own calls (``shading_option_calls``):
    the kernel against its plain version at SHADING_BAR, with 0 discrete
    choices apart (``shading_choices``: on the even grid and at full
    rate), on every option set its callers pass; ``lit``: on the sky-free
    view, each call with 0 sky pixels (asserted).  Every call is held
    before a failure raises; returns the number of option sets held."""
    from mo_renderer_tpu_torch.passes import shading as Sh

    tag = "shading@lit" if lit else "shading"
    calls = shading_option_calls(cfg, device, lit)
    layouts = set()
    failed = []
    for what, args in calls.items():
        k = Sh._shading_fast_cuda(*args)
        p = Sh._shading_fast_plain(*args)
        err, ok, bar = shading_compare(k, p)
        if args[2] is not None:
            layouts.add(Sh.pcf_layout(args[2], args[3]))
        counts = shading_choices(args)[0]
        apart = sum(n for n, _ in counts.values())
        n_sky = int((args[0].depth >= 1.0).sum())
        shown = {c: f"{n} of {of}" for c, (n, of) in counts.items()}
        print(f"[2] {tag} {what}: {tuple(k.shape)}, {n_sky} sky pixels, "
              f"max |err| {err:.3g} ({bar}); choices apart {apart}: {shown}",
              flush=True)
        if not ok or apart or (lit and n_sky):
            failed.append(what)
    if failed:
        raise AssertionError(f"{tag}: kernel disagrees with its plain "
                             f"version, or a call has sky, on {failed}")
    if layouts != {Sh.PCF_U16_HALF, Sh.PCF_U16_FULL, Sh.PCF_F32_WIDE}:
        raise AssertionError(f"shading: PCF layouts held {layouts}")
    return len(calls)


def lights_world():
    """scenes.tiny_world with a point light and a spot light beside its
    sun: three lights of the three kinds."""
    from mo_renderer_tpu_torch import scenes
    from mo_renderer_tpu_torch.math.transform import Transform
    from mo_renderer_tpu_torch.scene.components import PointLight, SpotLight

    world = scenes.tiny_world()
    world.spawn((PointLight(Transform.from_xyz(-1.5, 1.5, 1.0),
                            (1.0, 0.6, 0.3), 6.0),))
    world.spawn((SpotLight(
        Transform.from_xyz(0.5, 3.0, 1.5).looking_at((0.0, 0.0, 0.0)),
        (0.4, 0.7, 1.0), 12.0, exponent=8.0),))
    return world


def check_shading_ref_options(cfg, device):
    """Phase 2, K11 beyond the paths' own calls, each against its plain
    version at SHADING_BAR with 0 PCF taps, faces, levels or texels apart
    (``shading_ref_check``): the tiny scene's reference call without IBL
    and without a shadow map, the UV1 scene under default flags (which
    takes the reference path), and a sun, a point and a spot light.
    ``cfg`` gives the frame size; returns the number of calls held."""
    from mo_renderer_tpu_torch import scenes

    calls = {}
    for what, overrides, make_world in (
            ("reference", {"fast_sampling": False}, scenes.tiny_world),
            ("UV1 scene, default flags", {},
             functools.partial(scenes.tiny_world, uv1=True)),
            ("sun, point and spot light", {"fast_sampling": False},
             lights_world)):
        seen = capture_inputs(cfg, device,
                              [(overrides, make_world, scenes.camera)],
                              {"shading_ref"})
        calls[what] = shading_ref_args(*seen["shading_ref"])
    ref = calls.pop("reference")
    calls["no IBL"] = ref[:6] + (None,)
    calls["no shadow"] = ref[:2] + (None,) + ref[3:]
    for what, args in calls.items():
        err, ok, bar, apart = shading_ref_check(args)
        print(f"[2] shading_ref {what}: {tuple(args[0].depth.shape)}, "
              f"{min(args[3].shape[0], args[4])} light(s), max |err| "
              f"{err:.3g} ({bar}); apart {apart}", flush=True)
        if not ok:
            raise AssertionError(f"shading_ref {what}: kernel disagrees "
                                 f"with its plain version (max |err| {err}, "
                                 f"{apart})")
    return len(calls)


def edge_cut(args):
    """A ``gbuffer_pass`` call cut to a target 9 rows and 3 columns short
    of its own (1079 x 1917 of a 1088 x 1920 call): H and W odd, so
    neither is a multiple of K12's 32-pixel spans, its two-row tiles or a
    4-float vector, and most spans start off a 16-byte boundary.  The planes are views
    of the call's, read through their strides."""
    tri, z, b0, b1, scene, vs = args
    h, w = tri.shape[0] - 9, tri.shape[1] - 3
    return (tri[:h, :w], z[:h, :w], b0[:h, :w], b1[:h, :w], scene, vs)


def check_gbuffer_ref_options(cfg, device):
    """Phase 2, K12 beyond the paths' own calls, each against its plain
    version at GBUFFER_REF_BAR with 0 texel anchors or UV sets apart
    (``gbuffer_ref_check``): the UV1 scene under default flags (which
    takes the reference path), the all-slots scene on the reference path
    (five sampled slots, a mesh with tangents), that call with every
    has_tangent cleared (the tiny scene's own call has no tangents), and
    the reference path's call on scenes.grid_world(10) from
    scenes.lit_camera cut at an odd edge (``edge_cut``: the staged
    stores' element-by-element tail).  ``cfg`` gives the frame size;
    returns the number of calls held."""
    import torch

    from mo_renderer_tpu_torch import scenes

    calls = {}
    for what, overrides, make_world, camera in (
            ("UV1 scene, default flags", {},
             functools.partial(scenes.tiny_world, uv1=True), scenes.camera),
            ("all slots", {"fast_sampling": False},
             functools.partial(scenes.tiny_world, all_slots=True),
             scenes.camera),
            ("@lit at an odd edge", {"fast_sampling": False},
             scenes.grid_world, scenes.lit_camera)):
        seen = capture_inputs(cfg, device, [(overrides, make_world, camera)],
                              {"gbuffer_ref"})
        calls[what] = seen["gbuffer_ref"][0]
    calls["@lit at an odd edge"] = edge_cut(calls["@lit at an odd edge"])
    *planes, scene, vs = calls["all slots"]
    calls["all slots, no tangent"] = (*planes, scene, dataclasses.replace(
        vs, has_tangent=torch.zeros_like(vs.has_tangent)))
    for what, args in calls.items():
        tri, scene, vs = args[0], args[4], args[5]
        covered = tri >= 0
        corner0 = scene.indices.to(torch.int64)[
            torch.clamp(tri, min=0).to(torch.int64)][..., 0]
        tangents = int((vs.has_tangent[corner0] & covered).sum())
        choices, _ = gbuffer_ref_choices(args)
        uv1 = int(((choices[..., -1] > 0) & covered).sum())
        err, ok, bar, apart = gbuffer_ref_check(args)
        print(f"[2] gbuffer_ref {what}: {tuple(tri.shape)}, "
              f"{int(covered.sum())} covered, {tangents} with tangents, "
              f"{uv1} sampling UV set 1, max |err| {err:.3g} ({bar}); "
              f"apart {apart}", flush=True)
        if not ok:
            raise AssertionError(f"gbuffer_ref {what}: kernel disagrees "
                                 f"with its plain version (max |err| {err}, "
                                 f"{apart})")
    return len(calls)


def setup_binning_cases(device):
    """The main path's tilings of ``scenes.grid_world(10)`` (51,802
    triangles) from ``scenes.lit_camera`` (no sky pixel, as in the walk):
    {name: (setup source, inputs, the setup's other arguments, bin
    keywords)} -- the 1080p frame from the packed corners, the 2048^2
    light view (shadow bias, no cull), the reference path's 1080p frame
    from the vertex stage's clip and the indices, the 4K frame, a band of
    the 1080p frame (the 9 of its 34 bin rows with the most pairs), and
    the 1080p frame under a capacity below its pair count."""
    from mo_renderer_tpu_torch import Renderer, scenes
    from mo_renderer_tpu_torch.config import EngineConfig
    from mo_renderer_tpu_torch.kernels import raster_setup as RS
    from mo_renderer_tpu_torch.kernels import rasterizer as R
    from mo_renderer_tpu_torch.passes.vertex_stage import run_vertex_stage

    cases = {}
    for tag, w, h in (("1080p", 1920, 1080), ("4k", 3840, 2160)):
        cfg = EngineConfig(width=w, height=h)
        world = scenes.grid_world(10)
        world.insert_resource(scenes.lit_camera(cfg))
        r = Renderer(cfg, device)
        r.prepare(world)
        params, _ = r.frame_params(world)
        sc = r.scene

        def grid(pw, ph, cap=r._binned_cap, **kw):
            return dict(tile_h=R.BIN_H, tile_w=R.BIN_W,
                        n_tiles_x=-(-pw // R.BIN_W),
                        n_tiles_y=-(-ph // R.BIN_H), binned_cap=cap, **kw)

        attrs = (sc.tri_attrs, params["proj_view"])
        # tri_valid, width, height, cull, depth bias (const, slope), w_eps
        frame = (sc.tri_valid, r.pad_w, r.pad_h, True, 0.0, 0.0, 1e-6)
        cases[f"frame@{tag}"] = (RS.SRC_ATTRS, attrs, frame,
                                 grid(r.pad_w, r.pad_h))
        if tag != "1080p":
            continue
        s = cfg.shadow_map_size
        cases[f"shadow@{s}"] = (
            RS.SRC_ATTRS, (sc.tri_attrs, params["light_proj_view"]),
            (sc.tri_valid, s, s, False, cfg.shadow_depth_bias_const,
             cfg.shadow_depth_bias_slope, 1e-6), grid(s, s))
        vs = run_vertex_stage(sc, params["proj_view"],
                              params["prev_proj_view"],
                              params["light_proj_view"])
        cases["reference@1080p"] = (RS.SRC_INDEXED, (vs.clip, sc.indices),
                                    frame, grid(r.pad_w, r.pad_h))
        setup = RS.triangle_setup_from_attrs(sc.tri_attrs, sc.tri_valid,
                                             params["proj_view"], r.pad_w,
                                             r.pad_h)
        counts = RS.bin_triangles(setup, **grid(r.pad_w, r.pad_h)).tile_count
        total = int(counts.sum())
        rows = counts.reshape(-1, -(-r.pad_w // R.BIN_W)).sum(1).tolist()
        row0 = max(range(len(rows) - 8), key=lambda y: sum(rows[y:y + 9]))
        cases["band@1080p"] = (RS.SRC_ATTRS, attrs, frame,
                               grid(r.pad_w, r.pad_h, band_row0=row0,
                                    band_tile_rows=9))
        cases["capped@1080p"] = (RS.SRC_ATTRS, attrs, frame,
                                 grid(r.pad_w, r.pad_h, cap=total // 2))
    return cases


def _bins_equal(a, b):
    """Two binnings list the same runs, boxes and dropped count."""
    import torch

    n = int(b.tile_count.sum())
    return (torch.equal(a.bbox, b.bbox)
            and torch.equal(a.tile_start, b.tile_start)
            and torch.equal(a.tile_count, b.tile_count)
            and a.pair_tri.shape == b.pair_tri.shape
            and torch.equal(a.pair_tri[:n], b.pair_tri[:n])
            and int(a.overflow) == int(b.overflow))


def check_setup_binning(device, timing=True):
    """Phase 2: ``tri_setup_kernel`` and the three binning kernels against
    their plain versions (the torch ops, run on the card) on
    ``setup_binning_cases``: rows and boxes bit for bit, and the
    binnings' boxes, runs and dropped counts.  With ``timing``, each
    case's median device ms of the kernels and of the plain versions,
    and the byte bound (inputs read once, outputs written once).  Returns
    {case: result}."""
    import torch

    from mo_renderer_tpu_torch.kernels import raster_setup as RS

    results = {}
    for name, (src, inputs, args, bins) in setup_binning_cases(
            device).items():
        k = RS._setup_cuda(src, inputs, *args)
        p = RS._setup_plain(src, inputs, *args)
        if not (torch.equal(k.tri_data.view(torch.int32),
                            p.tri_data.view(torch.int32))
                and torch.equal(k.bbox, p.bbox)):
            raise AssertionError(f"tri_setup {name}: rows or boxes differ "
                                 "from the plain version")
        grid = (bins["tile_h"], bins["tile_w"], bins["n_tiles_x"],
                bins["n_tiles_y"], bins["binned_cap"],
                bins.get("band_row0"), bins.get("band_tile_rows"))
        b = RS._bin_plain(p, *grid)
        if not _bins_equal(RS._bin_cuda(p, *grid), b):
            raise AssertionError(f"binning {name}: boxes, runs or dropped "
                                 "count differ from the plain version")
        t = args[0].shape[0]
        n_tiles = bins["n_tiles_x"] * bins["n_tiles_y"]
        res = {"triangles": t, "tiles": n_tiles,
               "pairs_listed": int(b.tile_count.sum()),
               "dropped": int(b.overflow),
               "binned_cap": bins["binned_cap"], "bit_equal": True}
        if timing:
            in_bytes = {RS.SRC_ATTRS: 36, RS.SRC_INDEXED: 12 + 3 * 16,
                        RS.SRC_CORNERS: 48}[src] + 1
            setup_bytes = t * (in_bytes + 4 * RS.TRI_STRIDE + 16)
            # rows' columns 0..5 and 15 and the boxes in, the boxes, the
            # pairs and the run table out
            bin_bytes = (t * (7 * 4 + 16 + 16) + 4 * res["pairs_listed"]
                         + 8 * n_tiles)
            res.update({
                "tri_setup_ms": median_ms(
                    lambda: RS._setup_cuda(src, inputs, *args)),
                "tri_setup_plain_ms": median_ms(
                    lambda: RS._setup_plain(src, inputs, *args)),
                "binning_ms": median_ms(lambda: RS._bin_cuda(p, *grid)),
                "binning_plain_ms": median_ms(
                    lambda: RS._bin_plain(p, *grid)),
                "binning_split_ms": device_split(
                    lambda: RS._bin_cuda(p, *grid)),
                "tri_setup_bound_ms": bound(setup_bytes, 0)[0],
                "binning_bound_ms": bound(bin_bytes, 0)[0],
                "library_ms": None,
            })
        results[name] = res
        print(f"[2] setup+binning {name}: {json.dumps(res)}", flush=True)
    return results


def check_small_frames(device):
    """Phase 3: the 256x128 frames on the card vs on the CPU; the stack
    kernel launches on the card exactly where the config and the path
    call for it."""
    from mo_renderer_tpu_torch import Renderer, scenes
    from mo_renderer_tpu_torch.kernels import _build

    stack_on = {"stack_plane_kernel": True}
    # what -> (overrides, scene variant, the stack kernel runs)
    cases = {
        "default": ({}, {}, False),
        "reference path": ({"fast_sampling": False}, {}, False),
        "UV1 scene": ({}, {"uv1": True}, False),
        "megakernel": ({"raster_interp_attrs": True,
                        "ssao_res_divisor": 1}, {}, False),
        "texture-stack": (STACKS, {"all_slots": True}, True),
        "both plane kernels": ({"attrs_plane_kernel": True, **stack_on},
                               {"all_slots": True}, True),
        "reference path, stack kernel on": (
            {"fast_sampling": False, **stack_on}, {"all_slots": True},
            False),
        "megakernel, stack kernel on": (
            {"raster_interp_attrs": True, "ssao_res_divisor": 1, **stack_on},
            {"all_slots": True}, False),
        "pcf_u16=False": ({"pcf_u16": False}, {}, False),
        "pcf_half_anchor=False": ({"pcf_half_anchor": False}, {}, False),
        "spec_parent_mip_half_res=False": (
            {"spec_parent_mip_half_res": False}, {}, False),
        "spec_merged_trilinear=False": (
            {"spec_merged_trilinear": False}, {}, False),
        "spec_mirror_half_res=False, checkerboard=False": (
            {"spec_mirror_half_res": False, "checkerboard": False}, {},
            False),
        "ssao_pallas=False": ({"ssao_pallas": False}, {}, False),
    }
    for what, (overrides, scene_kw, k7) in cases.items():
        frames = []
        for dev in (device, "cpu"):
            cfg = scenes.tiny_config(**overrides)
            world = scenes.tiny_world(**scene_kw)
            world.insert_resource(scenes.camera(cfg))
            r = Renderer(cfg, dev)
            r.prepare(world)
            before = _build.LAUNCHES["stack_planes"]
            frames.append(r.render(world))
            launched = _build.LAUNCHES["stack_planes"] > before
            if launched != (k7 and dev == device):
                raise AssertionError(
                    f"256x128 {what} frame on {dev}: the stack kernel "
                    f"{'launched' if launched else 'did not launch'}")
        gpu, cpu = frames
        if gpu.shape != (128, 256, 4):
            raise AssertionError(f"256x128 frame has shape {gpu.shape}")
        golden_bar(f"256x128 {what} frame", gpu, cpu)


def golden_bar(what, gpu, cpu):
    """Card frame against CPU frame: mean |diff| < 2/255 and fewer than
    0.5% of channels above 16/255 (tests/test_golden.py:99-107)."""
    import numpy as np

    if gpu.shape != cpu.shape:
        raise AssertionError(f"{what}: card frame {gpu.shape}, CPU frame "
                             f"{cpu.shape}")
    diff = np.abs(gpu.astype(np.int32) - cpu.astype(np.int32))[..., :3]
    mean, big = diff.mean(), (diff > 16).mean()
    print(f"[3] {what}, card vs CPU: max |diff| {diff.max()} LSB, mean "
          f"{mean:.4f} LSB, {big:.4%} of channels > 16 (bar: mean < 2, "
          "< 0.5%)", flush=True)
    if not (mean < 2.0 and big < 0.005):
        raise AssertionError(f"{what}: the card frame misses the golden bar")


def _cube(x, y, z, **kw):
    from mo_renderer_tpu_torch.assets.procedural import procedural_model
    from mo_renderer_tpu_torch.math.transform import Transform

    return (Transform.from_xyz(x, y, z), procedural_model("cube", **kw))


def check_topology(device):
    """Phase 3, incremental topology at 256x128 on the tiny scene, the same
    steps on the card and on the CPU: a default-texture cube spawned into
    the default path is incremental (no prepare, the same pack state) and
    its frame equals a fresh prepare's bit for bit; the shadow raster (K2)
    runs once on the frame after the spawn and not on the next; the
    despawn gives the first frame back bit for bit; a spawn with new
    texture content falls back to one full prepare.  The spawned and the
    fallback frames hold the golden bar against the CPU's."""
    import numpy as np

    from mo_renderer_tpu_torch import Renderer, scenes
    from mo_renderer_tpu_torch.kernels import _build

    cfg = scenes.tiny_config()
    frames = {}
    for dev in (device, "cpu"):
        world = scenes.tiny_world()
        world.insert_resource(scenes.camera(cfg))
        r = Renderer(cfg, dev)
        r.prepare(world)
        f0 = r.render(world)
        pack = r.scene._host_pack
        entity = world.spawn(_cube(0.6, 0.3, 0.9, base_color=(0.2, 0.9, 0.2,
                                                              1.0)))
        _build.reset_launches()
        f1 = r.render(world)
        k2_first = _build.LAUNCHES["raster_depth"]
        if r._prepare_count != 1 or r.scene._host_pack is not pack:
            raise AssertionError(f"{dev}: the default-texture spawn ran a "
                                 "full prepare")
        if np.array_equal(f0, f1):
            raise AssertionError(f"{dev}: the spawned cube is not rendered")
        if dev != "cpu":
            _build.reset_launches()
            f1_again = r.render(world)
            k2_next = _build.LAUNCHES["raster_depth"]
            if (k2_first, k2_next) != (1, 0):
                raise AssertionError(
                    f"shadow raster launches {k2_first} on the frame after "
                    f"the spawn and {k2_next} on the next (want 1, 0)")
            fresh = Renderer(cfg, dev)
            fresh.prepare(world)
            if not (np.array_equal(f1, fresh.render(world))
                    and np.array_equal(f1, f1_again)):
                raise AssertionError("the incremental spawn's card frame "
                                     "differs from a fresh prepare's")
        world.despawn(entity)
        if not np.array_equal(r.render(world), f0) or r._prepare_count != 1:
            raise AssertionError(f"{dev}: the despawn did not give the "
                                 "pre-spawn frame back incrementally")
        world.spawn(_cube(-0.8, 0.3, 0.8, mr_gradient=True))
        f3 = r.render(world)
        if r._prepare_count != 2:
            raise AssertionError(f"{dev}: new texture content made "
                                 f"{r._prepare_count - 1} prepares, want 1")
        frames[dev] = (f1, f3)
    print(f"[3] topology on {device}: spawn incremental and equal to a "
          "fresh prepare bit for bit, K2 1 then 0 launches, despawn gives "
          "the first frame back, new texture content 1 prepare", flush=True)
    for i, what in enumerate(("spawned", "fallback")):
        golden_bar(f"256x128 {what} frame", frames[device][i],
                   frames["cpu"][i])


def check_window_loop(device):
    """Phase 3, the window loop: ``run_windowed`` through an
    OffscreenWindow for 3 frames of the tiny scene at 256x128, with a
    resize to 384x160 pending before frame 2, on the card and on the CPU;
    the last frame presented has the new size and holds the golden bar.
    Then ``present_divisor=2`` presents the card frame's even rows and
    columns, (64, 128, 4)."""
    import numpy as np

    from mo_renderer_tpu_torch import App, scenes
    from mo_renderer_tpu_torch.app.window import OffscreenWindow, run_windowed

    def make_app(dev):
        app = App.new(config=scenes.tiny_config(), device=dev)
        app.world = scenes.tiny_world()
        app.insert_resource(scenes.camera(app.config))
        return app

    last = {}
    for dev in (device, "cpu"):
        app = make_app(dev)
        shapes = []

        class Resizing(OffscreenWindow):
            def present(self, frame):
                super().present(frame)
                shapes.append(frame.shape)
                if len(shapes) == 1:
                    self.pending_resize = (384, 160)

        window = Resizing(256, 128)
        shown = run_windowed(app, window=window, max_frames=3)
        want = [(128, 256, 4), (160, 384, 4), (160, 384, 4)]
        if shown != 3 or shapes != want:
            raise AssertionError(f"{dev}: window loop showed {shown} frames "
                                 f"of {shapes}, want {want}")
        last[dev] = window.frame
    golden_bar("window loop, last frame after the resize to 384x160",
               last[device], last["cpu"])

    app = make_app(device)
    window = OffscreenWindow(256, 128)
    run_windowed(app, window=window, max_frames=1, present_divisor=2)
    full = app.renderer.render(app.world)
    if window.frame.shape != (64, 128, 4) or not np.array_equal(
            window.frame, full[::2, ::2]):
        raise AssertionError(f"present_divisor=2 presented "
                             f"{window.frame.shape}, not the full frame's "
                             "even rows and columns (64, 128, 4)")
    print("[3] window loop, present_divisor=2: (64, 128, 4), the full "
          "frame's even rows and columns", flush=True)


def check_sharded_frames(device, group, cpu_group):
    """Phase 3, the row-sharded frame: TileShardedRenderer at 256x256 on
    the card (``group``, NCCL) against the same on the CPU (``cpu_group``,
    gloo), checkerboard on and off; the band kernels launch on the card.
    With the checkerboard on, a cube spawned into the same world shows in
    the next sharded frame, incrementally (the band program is kept), on
    both."""
    import numpy as np

    from mo_renderer_tpu_torch import scenes
    from mo_renderer_tpu_torch.kernels import _build
    from mo_renderer_tpu_torch.parallel import TileShardedRenderer

    for cb in (True, False):
        frames, spawned = [], []
        for dev, g in ((device, group), ("cpu", cpu_group)):
            cfg = scenes.tiny_config(height=256, checkerboard=cb,
                                     **ROWS_OVERRIDES)
            world = scenes.tiny_world()
            world.insert_resource(scenes.camera(cfg))
            ts = TileShardedRenderer(cfg, g, dev)
            ts.prepare(world)
            _build.reset_launches()
            frames.append(ts.render(world).astype(np.int32))
            idle = [k for k in ("raster_slim_band", "raster_depth_band",
                                "ssao_halo") if not _build.LAUNCHES[k]]
            if dev == device and idle:
                raise AssertionError(f"256x256 sharded frame: {idle} did "
                                     "not launch")
            if cb:
                program = ts._frame_fn
                world.spawn(_cube(0.6, 0.3, 0.9,
                                  base_color=(0.2, 0.9, 0.2, 1.0)))
                spawned.append(ts.render(world))
                if (np.array_equal(spawned[-1], frames[-1])
                        or ts._frame_fn is not program
                        or ts._inner._prepare_count != 1):
                    raise AssertionError(
                        f"{dev}: the sharded spawn is not visible or "
                        "rebuilt the band program")
        gpu, cpu = frames
        if gpu.shape != (256, 256, 4):
            raise AssertionError(f"sharded frame has shape {gpu.shape}")
        golden_bar(f"256x256 row-sharded frame (world of {group.size}, "
                   f"checkerboard {cb})", gpu, cpu)
        if cb:
            golden_bar("256x256 row-sharded frame after a spawn (band "
                       "program kept)", *spawned)


def check_render_pass(device):
    """Phase 3, the RenderPass API at 256x128 on the tiny scene, on the
    card and on the CPU: a probe pass records the context's shapes and
    halves the colour.  The context is at the padded frame size, the frame
    is dimmed, ``present_pass`` runs once and the checkerboard reconstruct
    (K5) does not launch (a pass switches the checkerboard off); ``resize``
    reaches ``on_swapchain_recreate``.  On the card the pass runs while
    the frame is captured (twice: the warm-up and the capture) and not at
    the replay.  The card frame holds the golden bar against the CPU's."""
    import mo_renderer_tpu_torch.passes.frame_graph as FG
    from mo_renderer_tpu_torch import Renderer, RenderPass, scenes
    from mo_renderer_tpu_torch.kernels import _build

    class Probe(RenderPass):
        def __init__(self):
            self.seen, self.sizes = [], []

        def render(self, ctx):
            self.seen.append(tuple(tuple(x.shape[:2]) for x in (
                ctx["color"], ctx["ssao"], ctx["gbuffer"].depth)))
            return dict(ctx, color=ctx["color"] * 0.5)

        def on_swapchain_recreate(self, window_size):
            self.sizes.append(window_size)

    present_pass, calls = FG.present_pass, []

    def counted_present_pass(color):
        calls.append(color.shape)
        return present_pass(color)

    frames = {}
    FG.present_pass = counted_present_pass
    try:
        for dev in (device, "cpu"):
            cfg = scenes.tiny_config()
            world = scenes.tiny_world()
            world.insert_resource(scenes.camera(cfg))
            probe = Probe()
            r = Renderer(cfg, dev, extra_passes=[probe])
            r.prepare(world)
            plain = Renderer(cfg, dev)
            plain.prepare(world)
            full = plain.render(world)
            _build.reset_launches()
            calls.clear()
            frames[dev] = r.render(world)
            pad = (r.pad_h, r.pad_w)
            k5 = (_build.LAUNCHES["interleave"]
                  + _build.LAUNCHES["interleave_present"])
            # on the card the pass and present_pass run while the frame is
            # captured (the warm-up, the capture), not at the replay
            runs = 2 if dev == device else 1
            if probe.seen != [(pad, pad, pad)] * runs:
                raise AssertionError(f"{dev}: the pass saw {probe.seen}, "
                                     f"want the padded frame {pad} {runs} "
                                     "time(s)")
            if len(calls) != runs or k5:
                raise AssertionError(f"{dev}: present_pass ran {len(calls)} "
                                     f"times and K5 launched {k5} times "
                                     f"(want {runs} and 0)")
            if not (frames[dev][..., :3].astype(int).sum()
                    < 0.6 * full[..., :3].astype(int).sum()):
                raise AssertionError(f"{dev}: the pass did not dim the frame")
            r.resize(384, 160)
            if probe.sizes != [(384, 160)]:
                raise AssertionError(f"{dev}: resize reached "
                                     f"on_swapchain_recreate with "
                                     f"{probe.sizes}")
    finally:
        FG.present_pass = present_pass
    print(f"[3] render pass: the probe saw {probe.seen[0]} (the padded "
          "frame) on the card (at the capture: warm-up and graph) and the "
          "CPU (once), present_pass ran as often, K5 0 launches, resize "
          "reached on_swapchain_recreate (384, 160)", flush=True)
    golden_bar("256x128 frame with a probe pass", frames[device],
               frames["cpu"])


def eager_render_device(r, world):
    """``Renderer.render_device`` as it ran before its frame was captured:
    the same host side (topology, transforms, params, the shadow memo, whose
    recompute replays its graph on a card), then ``frame_program`` op by
    op.  What phases 3 and 4 hold the replayed frame to."""
    from mo_renderer_tpu_torch.scene.scene_buffers import refresh_transforms

    r._sync_topology(world)
    r.scene = refresh_transforms(r.scene)
    params, has_light = r.frame_params(world)
    quads = r._cached_shadow_quads(params.host_field("light_proj_view"),
                                   params["light_proj_view"], has_light)
    rgba, overflow = r._frame(params, quads, has_light)
    r._note_overflow(overflow)
    return rgba


def eager_rows_render_device(ts, world):
    """``TileShardedRenderer.render_device`` before its frame was
    captured: the same host side, then the band program op by op with
    the bands' counts summed on the device."""
    from mo_renderer_tpu_torch.scene.scene_buffers import refresh_transforms

    inner = ts._inner
    inner._sync_topology(world)
    if inner._prepare_count != ts._prepared_at:
        ts._rebuild_frame_fn()
    inner.scene = refresh_transforms(inner.scene)
    params, has_light = inner.frame_params(world)
    rgba, overflow = ts._frame(params, has_light)
    inner._note_overflow(overflow)
    return rgba


@contextlib.contextmanager
def eager_frames(renderer):
    """Over the block, ``renderer.render_device`` (which ``render``,
    ``App.run`` and ``run_windowed`` call) is the eager frame of
    ``eager_render_device`` / ``eager_rows_render_device``."""
    from mo_renderer_tpu_torch.parallel import TileShardedRenderer

    eager = (eager_rows_render_device
             if isinstance(renderer, TileShardedRenderer)
             else eager_render_device)
    renderer.render_device = functools.partial(eager, renderer)
    try:
        yield
    finally:
        del renderer.render_device


@contextlib.contextmanager
def nccl_world_of_one():
    """An NCCL ``torch.distributed`` world of one in this process (on
    127.0.0.1, a free port): its rank group, destroyed after the block."""
    import torch.distributed as dist

    from mo_renderer_tpu_torch.parallel import make_rank_group

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        yield make_rank_group()
    finally:
        dist.destroy_process_group()


# phase 3 ``[3] interactive``: path -> (EngineConfig overrides, scene
# variant, extra passes, row-sharded)
INTERACTIVE = {
    "default": ({}, {}, False, False),
    "reference": ({"fast_sampling": False}, {}, False, False),
    "megakernel": ({"raster_interp_attrs": True}, {}, False, False),
    "stacks": (STACKS, {"all_slots": True}, False, False),
    "rows": (ROWS_OVERRIDES, {}, False, True),
    "default+pass": ({}, {}, True, False),
}


def check_interactive(device, group, paths=tuple(INTERACTIVE)):
    """Phase 3, the interactive frame replayed from its CUDA graph, at
    256x128 on the tiny scene: on each of ``paths`` (the four single-device
    paths, ``rows`` through ``TileShardedRenderer`` on ``group`` and the
    default path with an extra pass), 8 ``render_device`` frames with,
    before each, nothing, a camera move, an entity move, a cube spawn, its
    despawn, a light move, a camera move and a resize to 320x160.  Each
    replayed frame equals the eager ``frame_program`` frame on the same
    state bit for bit (``renderer._frame`` / the band program), and its
    dropped-pair counts the eager counts; a recomputed
    memoized shadow table equals ``shadow_program``'s.  The frames returned
    earlier are unchanged at the end.  Captures: one frame graph (and one
    shadow graph where the shadow is memoized) on the first frame, none
    for the moves, the spawn, the despawn or the light, one frame graph
    for the resize; no full prepare.  Then, under ``binned_cap=256`` (below
    the pair count), two frames: the pending counts equal the eager
    frames' counts, and ``check_overflow`` raises with them."""
    import numpy as np
    import torch

    from mo_renderer_tpu_torch import Renderer, RenderPass, scenes
    from mo_renderer_tpu_torch.assets.model import Model
    from mo_renderer_tpu_torch.math.transform import Transform
    from mo_renderer_tpu_torch.parallel import TileShardedRenderer
    from mo_renderer_tpu_torch.passes.frame_graph import shadow_program
    from mo_renderer_tpu_torch.scene.camera import Camera
    from mo_renderer_tpu_torch.scene.components import DirectionalLight

    class Dim(RenderPass):
        def render(self, ctx):
            return dict(ctx, color=ctx["color"] * 0.5)

    def move_camera(world):
        camera = world.resource(Camera)
        camera.transform.translation = (
            np.asarray(camera.transform.translation) + np.float32(
                [0.1, 0.0, 0.05])).astype(np.float32)
        camera.refresh_view()

    def move_entity(world):
        t = next(iter(world.query(Transform, Model)))[0]
        t.translation = (np.asarray(t.translation)
                         + np.float32([0.2, 0.0, 0.0])).astype(np.float32)

    def move_light(world):
        next(lt for lt in world.query(DirectionalLight)
             if lt.is_shadow_caster).shadow_width += 0.5

    def build(path, **overrides):
        base, scene_kw, with_pass, rows = INTERACTIVE[path]
        cfg = scenes.tiny_config(**{**base, **overrides})
        world = scenes.tiny_world(**scene_kw)
        world.insert_resource(scenes.camera(cfg))
        if rows:
            ren = TileShardedRenderer(cfg, group, device)
            inner = ren._inner
        else:
            ren = inner = Renderer(cfg, device,
                                   extra_passes=[Dim()] if with_pass else ())
        ren.prepare(world)
        return ren, inner, world, rows

    def eager(ren, inner, world, rows, check_table=True):
        """The eager frame and counts on the state the replay just saw
        (the host side is cached: nothing is recomputed)."""
        params, has_light = inner.frame_params(world)
        if rows:
            rgba, counts = ren._frame(params, has_light)
            return rgba, counts.tolist(), None
        quads = inner._cached_shadow_quads(
            params.host_field("light_proj_view"), params["light_proj_view"],
            has_light)
        rgba, counts = inner._frame(params, quads, has_light)
        if quads is not None and check_table:
            table, _ = shadow_program(
                inner.scene, params["light_proj_view"], cfg=inner.config,
                binned_cap=inner._binned_cap)
            if not torch.equal(table, quads):
                raise AssertionError(f"{path}: the shadow graph's table "
                                     "differs from shadow_program's")
        return rgba, counts.tolist(), quads

    def spawn(world):
        world.cube = world.spawn(_cube(0.6, 0.3, 0.9,
                                       base_color=(0.2, 0.9, 0.2, 1.0)))

    steps = (("first", None), ("camera", move_camera),
             ("entity", move_entity), ("spawn", spawn),
             ("despawn", lambda w: w.despawn(w.cube)),
             ("light", move_light), ("camera", move_camera),
             ("resize", None))
    for path in paths:
        ren, inner, world, rows = build(path)
        kept, memo = [], False
        for what, update in steps:
            if update is not None:
                update(world)
            if what == "resize":
                ren.resize(320, 160)
                world.resource(Camera).resize((320, 160))
            captures = (ren._captures, inner._shadow_captures)
            frame = ren.render_device(world)
            kept.append((frame, frame.clone()))
            got = inner._pending_overflow[-1].tolist()
            want, counts, quads = eager(ren, inner, world, rows)
            memo = memo or quads is not None
            if not torch.equal(frame, want) or got != counts:
                raise AssertionError(
                    f"{path}, {what}: the replayed frame (counts {got}) "
                    f"differs from the eager frame (counts {counts})")
            new = (ren._captures - captures[0],
                   inner._shadow_captures - captures[1])
            expect = {"first": (1, int(quads is not None)),
                      "resize": (1, 0)}.get(what, (0, 0))
            if new != expect:
                raise AssertionError(f"{path}, {what}: {new} new (frame, "
                                     f"shadow) captures, want {expect}")
        if inner._prepare_count != 1:
            raise AssertionError(f"{path}: {inner._prepare_count - 1} full "
                                 "re-prepares")
        if not all(torch.equal(f, c) for f, c in kept):
            raise AssertionError(f"{path}: a frame returned earlier changed")
        ren.check_overflow()
        graph, n_captures = ren._graph, ren._captures

        # past the capacity: the counts on the device equal the eager ones
        ren, inner, world, rows = build(path, binned_cap=256)
        total = np.zeros(2, np.int64)
        for i in range(2):
            if i:
                move_camera(world)
            shadow_before = inner._shadow_captures, inner._shadow_key
            ren.render_device(world)
            _, counts, quads = eager(ren, inner, world, rows,
                                     check_table=False)
            total += counts
            if quads is not None and shadow_before[1] != inner._shadow_key:
                _, ovf = shadow_program(
                    inner.scene, inner.frame_params(world)[0][
                        "light_proj_view"], cfg=inner.config,
                    binned_cap=inner._binned_cap)
                total[1] += int(ovf)
        pending = np.sum([o.tolist() for o in inner._pending_overflow],
                         axis=0)
        if not (np.array_equal(pending, total) and total[0] > 0):
            raise AssertionError(f"{path}: past a 256-pair cap the replayed "
                                 f"counts {pending.tolist()} differ from the "
                                 f"eager counts {total.tolist()}")
        try:
            ren.check_overflow()
        except RuntimeError as err:
            if f"{total[0]} G-buffer and {total[1]} shadow" not in str(err):
                raise AssertionError(f"{path}: check_overflow raised "
                                     f"{err!r}, want the eager counts "
                                     f"{total.tolist()}") from err
        else:
            raise AssertionError(f"{path}: check_overflow did not raise "
                                 "past the capacity")
        print(f"[3] interactive, {path}: 8 replayed render_device frames "
              f"(camera, entity, spawn, despawn, light, camera, resize) "
              f"equal the eager frames bit for bit and their counts, "
              f"{'the memoized shadow table equals shadow_program' if memo else 'shadow in the frame'}"
              f"; frames kept are unchanged; {n_captures} frame graphs "
              f"captured (first, resize), "
              f"{'1 shadow graph' if memo else 'no shadow graph'}, 0 for "
              f"the moves, spawn, despawn and light; replay launches "
              f"{graph.launches}; past a 256-pair cap the device counts "
              f"{total.tolist()} equal the eager counts and check_overflow "
              "raises with them", flush=True)


def check_sequences(device):
    """Phase 3, camera-path sequences at 256x128 on the tiny scene: on each
    of the four paths and with a probe pass, ``render_sequence_device``
    over K = 4 poses with the light fixed (the memoized shadow) and K = 3
    with it moving per step (a shadow per step, in the graph) equals the
    eager frames (``eager_render_device``) bit for bit; a second call with
    the same key captures nothing new.  On the default path also: the
    binning kernels list the plain version's runs on the card (the frame
    and the shadow map), and with a capacity below the pair count the
    graph's device overflow sum equals the eager frames' sum."""
    import numpy as np
    import torch

    from mo_renderer_tpu_torch import Renderer, RenderPass, scenes
    from mo_renderer_tpu_torch.kernels import raster_setup as RS
    from mo_renderer_tpu_torch.kernels.rasterizer import BIN_H, BIN_W
    from mo_renderer_tpu_torch.passes.frame_graph import build_camera_params
    from mo_renderer_tpu_torch.scene.camera import Camera
    from mo_renderer_tpu_torch.scene.components import DirectionalLight
    from mo_renderer_tpu_torch.scene.scene_buffers import find_shadow_light

    class Dim(RenderPass):
        def render(self, ctx):
            return dict(ctx, color=ctx["color"] * 0.5)

    def steps(r, world, n, light_step):
        camera = world.resource(Camera)
        light = next(lt for lt in world.query(DirectionalLight)
                     if lt.is_shadow_caster)
        base = np.asarray(camera.transform.translation, np.float64).copy()
        width = light.shadow_width
        params, eager = [], []
        for i in range(n):
            camera.transform.translation = (
                base + np.array([0.1 * i, 0.0, 0.0])).astype(np.float32)
            camera.refresh_view()
            light.shadow_width = width + light_step * i
            light_pv, _ = find_shadow_light(world)
            params.append(build_camera_params(camera, light_pv, r.device))
            eager.append(eager_render_device(r, world).clone())
        camera.transform.translation = base.astype(np.float32)
        camera.refresh_view()
        light.shadow_width = width
        return params, torch.stack(eager)

    cases = {name: (overrides, scene_kw, ())
             for name, (overrides, _, scene_kw) in PATHS.items()}
    cases["probe pass"] = ({}, {}, (Dim(),))
    for what, (overrides, scene_kw, passes) in cases.items():
        cfg = scenes.tiny_config(**overrides)
        world = scenes.tiny_world(**scene_kw)
        world.insert_resource(scenes.camera(cfg))
        r = Renderer(cfg, device, extra_passes=passes)
        r.prepare(world)
        out = []
        for n, light_step in ((4, 0.0), (3, 0.5)):
            params, eager = steps(r, world, n, light_step)
            before = r._captures
            frames = r.render_sequence_device(world, params)
            again = r.render_sequence_device(world, params)
            r.check_overflow()
            if not (torch.equal(frames, eager) and torch.equal(again, eager)):
                raise AssertionError(
                    f"{what}: the replayed sequence (K = {n}, light "
                    f"{'moving' if light_step else 'fixed'}) differs from "
                    "the eager frames")
            if r._captures - before > 1:
                raise AssertionError(f"{what}: a second call with the same "
                                     "key captured again")
            out.append(f"K={n} light {'moving' if light_step else 'fixed'}:"
                       f" equal, {r._captures - before} new capture(s) over "
                       "two calls")
        print(f"[3] sequence, {what}: {'; '.join(out)}; {r._captures} "
              f"captures, captured launches "
              f"{r._graph.launches if r._graph else None}",
              flush=True)

    # the default path's binning and overflow on the card
    cfg = scenes.tiny_config()
    world = scenes.tiny_world()
    world.insert_resource(scenes.camera(cfg))
    r = Renderer(cfg, device)
    r.prepare(world)
    params, _ = r.frame_params(world)
    s = cfg.shadow_map_size
    setups = {
        "frame": (RS.triangle_setup_from_attrs(
            r.scene.tri_attrs, r.scene.tri_valid, params["proj_view"],
            r.pad_w, r.pad_h), r.pad_w, r.pad_h),
        "shadow": (RS.triangle_setup_from_attrs(
            r.scene.tri_attrs, r.scene.tri_valid, params["light_proj_view"],
            s, s, cull_backface=False), s, s),
    }
    for what, (setup, w, h) in setups.items():
        grid = (BIN_H, BIN_W, -(-w // BIN_W), -(-h // BIN_H), r._binned_cap,
                None, None)
        plain = RS._bin_plain(setup, *grid)
        if not (_bins_equal(RS._bin_cuda(setup, *grid), plain)
                and int(plain.overflow) == 0):
            raise AssertionError(f"the binning kernels' runs of the {what} "
                                 "differ from the plain version's")
        print(f"[3] binning of the 256x128 {what} on the card: "
              f"{int(plain.tile_count.sum())} pairs in {r._binned_cap} "
              "slots, the runs equal the plain version's", flush=True)
    small = Renderer(scenes.tiny_config(binned_cap=256), device)
    small.prepare(world)
    params, _ = steps(small, world, 3, 0.5)
    small._pending_overflow.clear()
    eager = np.sum([small._frame(p, None, True)[1].tolist() for p in params],
                   axis=0)
    small.render_sequence_device(world, params)
    got = np.array(small._pending_overflow.pop().tolist())
    small._pending_overflow.clear()
    if not np.array_equal(got, eager):
        raise AssertionError(f"the graph's overflow sum {got} differs from "
                             f"the eager frames' {eager}")
    print(f"[3] sequence overflow past a 256-pair cap (3 steps, moving "
          f"light): device sum {got.tolist()} equals the eager sum",
          flush=True)


def check_views(device, group):
    """Phase 3, ``MultiViewRenderer`` at 256x128 on ``group`` (the NCCL
    world of one): 3 views equal 3 single-view frames bit for bit; a
    3-step x 2-view sequence equals per-step ``render_views_device`` bit
    for bit; a spawned cube shows in the next views."""
    import numpy as np
    import torch

    from mo_renderer_tpu_torch import Renderer, scenes
    from mo_renderer_tpu_torch.parallel import MultiViewRenderer
    from mo_renderer_tpu_torch.passes.frame_graph import build_camera_params
    from mo_renderer_tpu_torch.scene.scene_buffers import find_shadow_light

    cfg = scenes.tiny_config()
    world = scenes.tiny_world()
    world.insert_resource(scenes.camera(cfg))
    mv = MultiViewRenderer(cfg, group, device)
    mv.prepare(world)
    cams = [scenes.camera(cfg, a) for a in (0.0, 1.0, 2.0)]
    views = mv.render_views(cams, world)
    single = Renderer(cfg, device)
    single.prepare(world)
    for i, cam in enumerate(cams):
        world.insert_resource(cam)
        if not np.array_equal(views[i], single.render(world)):
            raise AssertionError(f"view {i} differs from the single-view "
                                 "frame")
    world.insert_resource(scenes.camera(cfg))
    light_pv, _ = find_shadow_light(world)
    rigs = [[scenes.camera(cfg, 0.4 * s + 1.5 * i) for i in range(2)]
            for s in range(3)]
    seq = mv.render_view_sequence_device(
        [[build_camera_params(c, light_pv, device) for c in rig]
         for rig in rigs], world)
    for s, rig in enumerate(rigs):
        if not torch.equal(seq[s], mv.render_views_device(rig, world)):
            raise AssertionError(f"view sequence step {s} differs from "
                                 "render_views_device")
    mv.check_overflow()
    cam = scenes.camera(cfg)
    before = mv.render_views([cam], world)
    world.spawn(_cube(0.6, 0.3, 0.9, base_color=(0.2, 0.9, 0.2, 1.0)))
    if np.array_equal(before, mv.render_views([cam], world)):
        raise AssertionError("the spawned cube is not in the next views")
    print(f"[3] views on a world of {group.size}: 3 views equal 3 "
          f"single-view frames bit for bit, a 3-step x 2-view sequence "
          f"{tuple(seq.shape)} equals per-step views bit for bit, a spawn "
          "shows in the next views", flush=True)


def profile_frames(run, n_frames=2):
    """torch.profiler over ``run(n_frames)`` (which renders that many
    frames): (host launch calls per frame -- kernel launches, graph
    launches and the runtime's copies and fills --, device ms per frame,
    kernels and copies)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run(n_frames)
        torch.cuda.synchronize()
    calls, device_us = 0, 0.0
    for row in prof.key_averages():
        if row.key in HOST_CALL_ROWS:
            calls += row.count
        # only the device's own rows (kernels, copies): an op's row and
        # its runtime launch's row repeat the same kernel time
        if row.device_type == torch.autograd.DeviceType.CUDA:
            device_us += row.self_device_time_total
    return calls / n_frames, device_us / 1e3 / n_frames


def run_full_frame(device, line, path, n_frames, group=None, warmup=3):
    """Phase 4: one path's 1080p frame through App.run, on the tiny scene
    or (the ``...@grid`` paths) on the stress scene; the ``rows`` paths
    through TileShardedRenderer on ``group``; each frame fetched to the
    host as App.run does.  ``render_device`` replays the captured frame
    (the first warm-up frame captures it); ms/frame is timed in turns with
    the eager frame on the same app (``eager_frames``: replay, eager,
    replay, eager, ``n_frames`` frames a turn), and both are profiled for
    host launch calls and device ms per frame.  The launch counts are set
    to 0 before the warm-up and hold the replayed frames' launches (and
    the capture's warm-up frame): the eager turns give theirs back."""
    import numpy as np
    import torch

    import mo_renderer_tpu_torch.passes.frame_graph as FG
    from mo_renderer_tpu_torch import App, scenes
    from mo_renderer_tpu_torch.config import EngineConfig
    from mo_renderer_tpu_torch.kernels import _build
    from mo_renderer_tpu_torch.parallel import TileShardedRenderer
    from mo_renderer_tpu_torch.parallel import tile_sharding as TS

    lit = path in LIT_PATHS or ROWS_PATHS.get(path) == "lit"
    grid = path in GRID_PATHS or ROWS_PATHS.get(path) == "grid"
    if path in ROWS_PATHS:
        overrides, kernels = ROWS_OVERRIDES, ROWS_KERNELS
    elif grid or lit:
        overrides, kernels = {**GRID_PATHS, **LIT_PATHS}[path]
    else:
        overrides, kernels, scene_kw = PATHS[path]
    if grid or lit:
        make_world = scenes.grid_world
        make_camera = scenes.lit_camera if lit else scenes.grid_camera
    else:
        make_world = functools.partial(
            scenes.tiny_world, **({} if path in ROWS_PATHS else scene_kw))
        make_camera = scenes.camera
    cfg = EngineConfig(width=1920, height=1080, **overrides)
    if path in ROWS_PATHS:
        world = make_world()
        world.insert_resource(make_camera(cfg))
        orbit = scenes.orbit_system(warmup + 4 * n_frames + 4)
        ts = TileShardedRenderer(cfg, group, device)
        ts.prepare(world)
        renderer, present_module, top = ts._inner, TS, ts

        def run(n):
            frame = None
            for _ in range(n):
                orbit(world)
                frame = ts.render(world)
            return frame
    else:
        app = App.new(config=cfg, device=device)
        app.world = make_world()
        app.insert_resource(make_camera(cfg))
        app.add_runtime_system(scenes.orbit_system(warmup + 4 * n_frames
                                                   + 4))
        app.resumed()
        world, renderer, present_module = app.world, app.renderer, FG
        top = renderer

        def run(n):
            return app.run(num_frames=n)

    def eager(n):
        # the eager frame launches the same kernels: take its counts back
        before = dict(_build.LAUNCHES)
        with eager_frames(top):
            out = run(n)
        _build.LAUNCHES.update(before)
        return out

    def ms_per_frame(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(n_frames)  # render() syncs every frame
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n_frames, out

    # a checkerboard frame is quantised inside the reconstruct kernel: it
    # must not go through present_pass's torch ops as well
    present_calls = 0
    present_pass = present_module.present_pass

    def counted_present_pass(color):
        nonlocal present_calls
        present_calls += 1
        return present_pass(color)

    _build.reset_launches()
    present_module.present_pass = counted_present_pass
    turns = {"replay": [], "eager": []}
    try:
        run(warmup)
        for _ in range(2):
            ms, frame = ms_per_frame(run)
            turns["replay"].append(ms)
            turns["eager"].append(ms_per_frame(eager)[0])
    finally:
        present_module.present_pass = present_pass
    counts = dict(_build.LAUNCHES)
    replayed = warmup + 2 * n_frames
    renderer.check_overflow()
    calls, device_ms = profile_frames(run)
    eager_calls, eager_device_ms = profile_frames(eager)
    if path in BY_PASS_PATHS:
        profiled = profile_passes(eager)
        print_passes(path, profiled, line)
        gbuffer_launches = profiled[0]["G-buffer (K3/K7/K10/K12)"][0]
        if path.startswith("reference") and gbuffer_launches != 1:
            raise AssertionError(f"{path}: the G-buffer pass made "
                                 f"{gbuffer_launches} launches a frame, "
                                 "want K12's one")
    ms = statistics.median(turns["replay"])

    rgb = frame[..., :3]
    covered = _covered_fraction(renderer, world, cfg)
    how = (f"TileShardedRenderer, world of {group.size}"
           if path in ROWS_PATHS else "App.run")
    print(f"[4] {path} 1920x1080 frame: shape {frame.shape}, max "
          f"{rgb.max()}, mean {rgb.mean():.2f}, covered fraction "
          f"{covered:.4f}, launches over {replayed} replayed frames and "
          f"{top._captures} capture(s) {counts}", flush=True)
    print(f"[4] {path} steady state ({how}, host fetch each frame): "
          f"replayed {ms:.3f} ms/frame (turns "
          f"{'; '.join(f'{t:.3f}' for t in turns['replay'])}), eager frame "
          f"in turns {'; '.join(f'{t:.3f}' for t in turns['eager'])}, "
          f"{n_frames} frames a turn; on {line}", flush=True)
    print(f"[4] {path} profile (2 frames, torch.profiler): replayed "
          f"{calls:.1f} host launch calls/frame, {device_ms:.3f} ms/frame of "
          f"device time ({device_ms / ms:.1%} of the unprofiled frame); "
          f"eager {eager_calls:.0f} host launch calls/frame, "
          f"{eager_device_ms:.3f} ms/frame of device time; captured launches "
          f"{top._graph.launches}", flush=True)
    if frame.shape != (1080, 1920, 4) or frame.dtype != np.uint8:
        raise AssertionError(f"frame {frame.shape} {frame.dtype}")
    if rgb.max() == 0:
        raise AssertionError("black frame")
    if lit and covered != 1.0:
        raise AssertionError(f"covered fraction {covered}: {path} has "
                             "geometry everywhere")
    if not lit and not 0.0 < covered < 1.0:
        raise AssertionError(f"covered fraction {covered}: need sky and "
                             "geometry")
    if top._captures != 1:
        raise AssertionError(f"{path}: {top._captures} captures, want 1")
    _check_launches(path, kernels, counts)
    # every frame's launches are the graph's, plus the capture's warm-up
    want = {k: (replayed + 1) * n for k, n in top._graph.launches.items()}
    shadow = getattr(renderer._shadow_graph, "launches", {})
    for k, n in shadow.items():  # the memoized shadow: once
        want[k] = want.get(k, 0) + n + 1
    got = {k: v for k, v in counts.items() if v}
    if got != want:
        raise AssertionError(f"{path}: launches {got}, want the captured "
                             f"launches per replayed frame {want}")
    if "interleave_present" in kernels and (
            top._graph.launches.get("interleave_present") != 1
            or present_calls):
        raise AssertionError(
            f"{path}: a checkerboard frame takes one reconstruct launch and "
            f"no present_pass, got {top._graph.launches} captured and "
            f"{present_calls} present_pass calls")
    if (overrides.get("fast_sampling") is False
            and top._graph.launches.get("raster_depth") != 1):
        raise AssertionError("the reference path must re-raster the shadow "
                             "map every frame")
    return counts, ms, top._graph.launches


# the paths whose eager frame phase 4 breaks down by pass
BY_PASS_PATHS = ("default", "default@grid", "reference", "reference@grid")

# the functions frame_program calls, by the pass they belong to: phase 4
# wraps them (in chip_smoke.py only) in torch.profiler ranges to break a
# frame's launches and device time down by pass
PASS_FUNCTIONS = {
    "vertex stage": ("run_vertex_stage", "pack_raster_attr_rows"),
    "shadow (K2)": ("shadow_map_from_clip", "shadow_program"),
    "triangle setup": ("triangle_setup_from_attrs", "triangle_setup"),
    "binning": ("_bin",),
    "raster (K1/K2/K6/K8)": ("rasterize", "rasterize_attrs"),
    "decimate": ("decimate_cols",),
    "G-buffer (K3/K7/K10/K12)": ("gbuffer_pass_fast", "gbuffer_pass",
                                 "gbuffer_pass_from_planes"),
    "SSAO (K4)": ("ssao_pass_tiles", "ssao_pass", "_pad_edge", "_even_grid",
                  "_upsample_to_cb", "_upsample_pow2"),
    "shading": ("shading_pass_fast", "shading_pass"),
    "present (K5)": ("reconstruct_present", "present_pass"),
}
LAUNCH_ROWS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx")
# what a host launch call is: a kernel launch, a graph launch, or a copy
# or fill the runtime queues (staging copies, the clone, the fetch)
HOST_CALL_ROWS = LAUNCH_ROWS + ("cudaGraphLaunch", "cudaMemcpyAsync",
                                "cudaMemsetAsync")


def _kernel_label(name):
    """A device kernel's name without its parameter list: a hand kernel
    keeps its template arguments (raster_kernel<0, false> is K2, <1, ...>
    K1, <2, ...> K6)."""
    import re

    m = re.search(r"(\w+_kernel)(<.*?>)?(?=\()", name)
    return m.group(1) + (m.group(2) or "") if m else name


def profile_passes(run, n_frames=2):
    """torch.profiler over ``run(n_frames)`` with each function of
    ``PASS_FUNCTIONS`` wrapped in a ``record_function`` range: ({pass:
    (kernel launches per frame, device ms per frame)}, {hand kernel: device
    ms per frame}, {what: device ms per frame} of the rest of the frame),
    each pass counted without the passes it calls (the shadow's binning
    and raster count as binning and raster).  A hand kernel's launch from
    C is a launch row inside its pass's range, but the profiler attaches
    its device time to no event: it is added to the pass that
    ``PASS_HAND_KERNELS`` names by the kernel's name.  "rest of the frame"
    is the device work of the ops outside every range (the frame's own
    ops, the params upload, the fetch), broken down by the op that queued
    it (a copy or fill by its own name: the fetch is a device-to-host
    Memcpy)."""
    import collections

    import torch

    import mo_renderer_tpu_torch.passes.frame_graph as FG

    def ranged(name, fn):
        def call(*args, **kwargs):
            with torch.profiler.record_function(f"pass::{name}"):
                return fn(*args, **kwargs)
        return call

    saved = {}
    for name, fns in PASS_FUNCTIONS.items():
        for fn in fns:
            saved[fn] = getattr(FG, fn)
            setattr(FG, fn, ranged(name, saved[fn]))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    try:
        with torch.profiler.profile(activities=acts) as prof:
            run(n_frames)
            torch.cuda.synchronize()
    finally:
        for fn, orig in saved.items():
            setattr(FG, fn, orig)

    def tally(evt, top):
        """(launches, device us) under ``evt``, without nested passes."""
        if not top and evt.name.startswith("pass::"):
            return 0, 0.0
        n = 1 if evt.name in LAUNCH_ROWS else 0
        us = sum(k.duration for k in evt.kernels)
        for child in evt.cpu_children:
            cn, cus = tally(child, False)
            n, us = n + cn, us + cus
        return n, us

    events = prof.events()
    by_pass = {name: [0, 0.0] for name in PASS_FUNCTIONS}
    for evt in events:
        if evt.name.startswith("pass::"):
            n, us = tally(evt, True)
            by_pass[evt.name[len("pass::"):]][0] += n
            by_pass[evt.name[len("pass::"):]][1] += us
    total_n = sum(1 for e in events if e.name in LAUNCH_ROWS)
    total_us = sum(k.duration for e in events for k in e.kernels)
    attached = {k.name for e in events for k in e.kernels}
    hand = collections.Counter()
    for e in events:
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and e.name not in attached
                and any(k in e.name for k in HAND_KERNELS)):
            hand[_kernel_label(e.name)] += e.time_range.elapsed_us()
    for name, kernels in PASS_HAND_KERNELS.items():
        us = sum(v for k, v in hand.items() if any(h in k for h in kernels))
        by_pass[name][1] += us
        total_us += us
    by_pass["rest of the frame"] = [
        total_n - sum(v[0] for v in by_pass.values()),
        total_us - sum(v[1] for v in by_pass.values())]
    rest = collections.Counter()

    def outside(evt):
        if evt.name.startswith("pass::"):
            return
        for k in evt.kernels:
            rest[k.name if k.name.startswith(("Memcpy", "Memset"))
                 else evt.name] += k.duration
        for child in evt.cpu_children:
            outside(child)

    for evt in events:
        if evt.cpu_parent is None:
            outside(evt)

    def per_frame(counts):
        return {k: us / 1e3 / n_frames for k, us in counts.most_common()}

    return ({name: (n / n_frames, us / 1e3 / n_frames)
             for name, (n, us) in by_pass.items()},
            per_frame(hand), per_frame(rest))


def print_passes(path, profiled, line):
    by_pass, hand, rest = profiled
    total_n = sum(n for n, _ in by_pass.values())
    total_ms = sum(ms for _, ms in by_pass.values())
    rows = "; ".join(f"{name} {n:.0f} / {ms:.3f}"
                     for name, (n, ms) in by_pass.items())
    print(f"[4] {path} by pass (torch.profiler ranges, 2 frames; kernel "
          f"launches / device ms per frame): {rows}; total {total_n:.0f} / "
          f"{total_ms:.3f}; on {line}", flush=True)
    print(f"[4] {path} hand kernels (device ms per frame): "
          + "; ".join(f"{k} {ms:.4f}" for k, ms in hand.items()), flush=True)
    top = list(rest.items())[:REST_ROWS]
    others = sum(rest.values()) - sum(ms for _, ms in top)
    print(f"[4] {path} rest of the frame by op (device ms per frame): "
          + "; ".join(f"{k} {ms:.4f}" for k, ms in top)
          + f"; {len(rest) - len(top)} others {others:.4f}", flush=True)


# the rest of the frame's largest entries phase 4 prints by name
REST_ROWS = 8
# profiles of a sequence call whose record lacks a replay's kernels, at most
PROFILE_ATTEMPTS = 3
# the __global__ functions of csrc/, as the profiler names their launches
HAND_KERNELS = ("raster_kernel", "raster_attrs_kernel", "attr_planes_kernel",
                "ssao_kernel", "reconstruct_kernel", "stack_planes_kernel",
                "shade_kernel", "gbuffer_kernel", "shade_ref_kernel",
                "gbuffer_ref_kernel", "tri_setup_kernel", "bin_count_kernel",
                "bin_scan_kernel", "bin_fill_kernel")
# the pass each hand kernel's device time is added to, by its name (each
# launches from C inside that pass's range; the shadow's raster runs in the
# raster pass)
PASS_HAND_KERNELS = {
    "raster (K1/K2/K6/K8)": ("raster_kernel", "raster_attrs_kernel"),
    "G-buffer (K3/K7/K10/K12)": ("attr_planes_kernel", "stack_planes_kernel",
                                 "gbuffer_kernel", "gbuffer_ref_kernel"),
    "SSAO (K4)": ("ssao_kernel",),
    "shading": ("shade_kernel", "shade_ref_kernel"),
    "present (K5)": ("reconstruct_kernel",),
    "triangle setup": ("tri_setup_kernel",),
    "binning": ("bin_count_kernel", "bin_scan_kernel", "bin_fill_kernel"),
}


def profile_graph_calls(run):
    """torch.profiler over one ``run()`` of a sequence: (host launch calls
    -- kernel launches and graph launches --, kernels that ran on the
    device, of them the hand kernels of csrc/, device kernel us,
    memcpy/memset device us, the call's own wall ms, synced, under the
    profiler, {device kernel name: runs})."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    host, kernels, hand, kernel_us, copy_us = 0, 0, 0, 0.0, 0.0
    by_name = {}
    for row in prof.key_averages():
        if row.key in LAUNCH_ROWS + ("cudaGraphLaunch",):
            host += row.count
        if row.device_type == torch.autograd.DeviceType.CUDA:
            if row.key.startswith(("Memcpy", "Memset")):
                copy_us += row.self_device_time_total
            else:
                kernels += row.count
                kernel_us += row.self_device_time_total
                by_name[row.key] = by_name.get(row.key, 0) + row.count
                if any(k in row.key for k in HAND_KERNELS):
                    hand += row.count
    return host, kernels, hand, kernel_us, copy_us, wall_ms, by_name


def run_sequence_path(device, line, path, n_steps, n_calls=3):
    """Phase 4, ``sequence`` / ``sequence@grid``: the default path at
    1920x1080 on the tiny scene (or scenes.grid_world(10)) along the
    orbit of ``run_full_frame``, ``n_steps`` poses as one
    ``render_sequence_device`` call: the first call captures the frame in
    a CUDA graph; then ``n_calls`` timed calls (each synced; ms/frame is
    the call's wall time / ``n_steps``), beside an eager loop over the
    same poses (``Renderer._frame``, no fetch).  Frames equal the eager
    ones bit for bit.  One more call under torch.profiler gives host
    launch calls, device ms per frame and the busy share of that call's
    own wall time; a 2-step call of the same graph under the profiler
    gives kernels per frame and holds the hand kernels it saw run to the
    counters (the profiler's record of a call of ~45K kernels has come
    back short at times, with the counters unchanged).  The counts are set to 0
    just before the first call and hold the sequence calls' launches
    only: the eager loop's are taken back after each turn.
    Also prints the static pair capacity beside the pair counts of the
    frame (first pose) and of the 2048^2 shadow map."""
    import numpy as np
    import torch

    from mo_renderer_tpu_torch import Renderer, scenes
    from mo_renderer_tpu_torch.config import EngineConfig
    from mo_renderer_tpu_torch.kernels import _build
    from mo_renderer_tpu_torch.kernels.raster_setup import (
        triangle_setup_from_attrs,
    )
    from mo_renderer_tpu_torch.passes.frame_graph import (
        _bin,
        build_camera_params,
    )
    from mo_renderer_tpu_torch.scene.camera import Camera
    from mo_renderer_tpu_torch.scene.scene_buffers import find_shadow_light

    grid = path.endswith("@grid")
    cfg = EngineConfig(width=1920, height=1080)
    world = scenes.grid_world(10) if grid else scenes.tiny_world()
    world.insert_resource((scenes.grid_camera if grid else scenes.camera)(
        cfg))
    r = Renderer(cfg, device)
    r.prepare(world)
    orbit = scenes.orbit_system(n_steps)
    light_pv, has_light = find_shadow_light(world)
    params = []
    for _ in range(n_steps):
        orbit(world)
        params.append(build_camera_params(world.resource(Camera), light_pv,
                                          device))

    def eager():
        # the eager loop launches the same kernels: take its counts back,
        # so the sequence's counts show what the graph replays
        before = dict(_build.LAUNCHES)
        frames = torch.stack([r._frame(p, quads, has_light)[0]
                              for p in params])
        _build.LAUNCHES.update(before)
        return frames

    def wall_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    def sequence():
        return r.render_sequence_device(world, params)

    _build.reset_launches()
    capture_ms, frames = wall_ms(sequence)
    quads, _ = r._sequence_shadow(world, params)  # the call's memo
    eager_frames = eager()
    if not torch.equal(frames, eager_frames):
        raise AssertionError(f"{path}: replayed frames differ from the "
                             "eager frames")
    turns = {"sequence": [], "eager": []}
    for _ in range(n_calls):
        turns["sequence"].append(wall_ms(sequence)[0] / n_steps)
        turns["eager"].append(wall_ms(eager)[0] / n_steps)
    r.check_overflow()
    counts = dict(_build.LAUNCHES)
    host, _, _, kernel_us, copy_us, prof_ms, _ = profile_graph_calls(
        sequence)
    # the counts grow by the captured launches at each replay: hold them
    # to the hand kernels the profiler saw run in a 2-step call.  The
    # profiler's record of such a call has come back without one replay's
    # kernels, with the counts and the frames right; such a call is
    # profiled again, at most PROFILE_ATTEMPTS times, each printed; an
    # earlier profile must lack exactly one replay's hand kernels
    # (_check_short_profiles) and the kernels line keeps how many it took
    attempts = []
    for _ in range(PROFILE_ATTEMPTS):
        out = []
        before = sum(_build.LAUNCHES.values())
        _, kernels, hand, _, _, _, by_name = profile_graph_calls(
            lambda: out.append(r.render_sequence_device(world, params[:2])))
        counted = sum(_build.LAUNCHES.values()) - before
        attempts.append((kernels, hand, counted, by_name))
        print(f"[4] {path} profile {len(attempts)}: {kernels} device "
              f"kernels, {hand} hand kernels against {counted} counted",
              flush=True)
        if not torch.equal(out[0], eager_frames[:2]):
            raise AssertionError(f"{path}: the profiled 2-step call's "
                                 "frames differ from the eager frames")
        if hand == counted:
            break
    _check_short_profiles(path, attempts)
    ms = statistics.median(turns["sequence"])
    ms = statistics.median(turns["sequence"])
    device_ms = kernel_us / 1e3 / n_steps

    # the static capacity against the pair counts at this size
    p0 = params[0]
    s = cfg.shadow_map_size
    pairs = {}
    for what, pv, w, h, cull in (("frame", p0["proj_view"], r.pad_w,
                                  r.pad_h, True),
                                 ("shadow", p0["light_proj_view"], s, s,
                                  False)):
        setup = triangle_setup_from_attrs(r.scene.tri_attrs,
                                          r.scene.tri_valid, pv, w, h,
                                          cull_backface=cull)
        b = _bin(setup, w, h, r._binned_cap)
        pairs[what] = int(b.tile_count.sum()) + int(b.overflow)
    rgb = frames[-1].cpu().numpy().view(np.uint8)
    print(f"[4] {path} 1920x1080, {n_steps} steps per call "
          f"({r.scene.indices.shape[0]} triangle rows): first call "
          f"(capture included) {capture_ms:.3f} ms; ms/frame "
          f"{'; '.join(f'{t:.3f}' for t in turns['sequence'])} (CUDA graph "
          f"replay, the call's wall time / {n_steps}), eager loop over the "
          f"same poses in turns {'; '.join(f'{t:.3f}' for t in turns['eager'])}"
          f"; profile (one call): {host / n_steps:.1f} host launch "
          f"calls/frame, {device_ms:.3f} ms/frame of device kernel time (+ "
          f"{copy_us / 1e3 / n_steps:.3f} ms copies; busy share "
          f"{kernel_us / 1e3 / prof_ms:.1%} of that call's wall time, "
          f"{prof_ms / n_steps:.3f} ms/frame under the profiler); a 2-step "
          f"call: {kernels / 2:.0f} kernels/frame on the device, {hand} hand "
          f"kernels against {counted} counted (profile {len(attempts)} of at "
          f"most {PROFILE_ATTEMPTS}); captured launches "
          f"{r._graph.launches}; pair capacity {r._binned_cap}, pairs"
          f" frame {pairs['frame']}, shadow {pairs['shadow']}; launches "
          f"{counts}; on {line}", flush=True)
    if rgb.max() == 0:
        raise AssertionError(f"{path}: black frame")
    if r._captures != 1:
        raise AssertionError(f"{path}: {r._captures} captures, want 1")
    if max(pairs.values()) > r._binned_cap:
        raise AssertionError(f"{path}: the pair count passes the static "
                             "capacity")
    # the eager warm-up before the capture launches every kernel too:
    # each must also be in the graph, but for the memoized shadow's K2
    outside = {"raster_depth"} if quads is not None else set()
    missing = [k for k in PATHS["default"][1]
               if k not in outside and not r._graph.launches.get(k)]
    if missing:
        raise AssertionError(f"{path}: kernels missing from the captured "
                             f"graph: {missing}")
    _check_launches(path, PATHS["default"][1], counts)
    return counts, ms, len(attempts)


def _check_short_profiles(path, attempts):
    """The 2-step profiles of ``run_sequence_path``, in order: (device
    kernels, hand kernels, counted launches, {kernel name: runs}).  The
    last must see as many hand kernels as were counted; every earlier one
    must lack exactly one of the two replays' hand kernels, of each kernel
    alike (half the runs of each hand kernel name), and see no kernel more
    often than the last."""
    _, hand, counted, full = attempts[-1]
    if hand != counted:
        raise AssertionError(f"{path}: the profiler saw {hand} hand kernels "
                             f"run in a 2-step call, the counts grew by "
                             f"{counted} ({len(attempts)} profiles)")
    is_hand = [k for k in full if any(h in k for h in HAND_KERNELS)]
    for i, (_, _, _, seen) in enumerate(attempts[:-1], 1):
        halved = all(2 * seen.get(k, 0) == full[k] for k in is_hand)
        if not halved or any(n > full.get(k, 0) for k, n in seen.items()):
            raise AssertionError(
                f"{path}: profile {i} of a 2-step call lacks other kernels "
                f"than one replay's: {seen} against {full}")


def run_views_path(device, line, group, n_views=4, n_calls=3):
    """Phase 4, ``views``: ``MultiViewRenderer`` on ``group`` (a world of
    one) renders ``n_views`` orbit views of the tiny scene at 1920x1080
    per call, left on the device (the Renderer's captured frame replayed
    per view; the warm-up call captures it); ms per view (the call's wall
    time, synced, / views), ``n_calls`` calls after the warm-up."""
    import torch

    from mo_renderer_tpu_torch import scenes
    from mo_renderer_tpu_torch.config import EngineConfig
    from mo_renderer_tpu_torch.kernels import _build
    from mo_renderer_tpu_torch.parallel import MultiViewRenderer

    cfg = EngineConfig(width=1920, height=1080)
    world = scenes.tiny_world()
    world.insert_resource(scenes.camera(cfg))
    _build.reset_launches()
    mv = MultiViewRenderer(cfg, group, device)
    mv.prepare(world)
    cams = [scenes.camera(cfg, 0.3 * i) for i in range(n_views)]
    mv.render_views_device(cams, world)
    times = []
    for _ in range(n_calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        block = mv.render_views_device(cams, world)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / n_views)
    mv.check_overflow()
    counts = dict(_build.LAUNCHES)
    if tuple(block.shape) != (n_views, cfg.height, cfg.width):
        raise AssertionError(f"views: block {tuple(block.shape)}")
    print(f"[4] views 1920x1080: {n_views} views per call on a world of "
          f"{group.size}, ms/view {'; '.join(f'{t:.3f}' for t in times)} "
          f"(the call's wall time, synced, / {n_views}; CUDA graph replay, "
          f"left on the device); launches {counts}; on {line}", flush=True)
    _check_launches("views", PATHS["default"][1], counts)
    return counts, statistics.median(times)


def _check_launches(path, kernels, counts):
    idle = [k for k in kernels if counts[k] == 0]
    if idle:
        raise AssertionError(f"{path}: kernels never launched: {idle}")
    stray = [k for k, v in counts.items() if v and k not in kernels]
    if stray:
        raise AssertionError(f"{path}: launched kernels of other paths: "
                             f"{stray}")


def run_spawn_path(device, line, n_spawns=5, warmup=3):
    """Phase 4, ``spawn@grid``: the default path on scenes.grid_world(10)
    at 1920x1080 through App, with ``n_spawns`` default-texture cubes
    spawned one at a time.  For each: the wall ms of
    ``Renderer._sync_topology`` (the incremental repack, device work
    synchronised), of the first frame after it (the re-bake of the
    per-triangle rows and the shadow re-raster included) and of the next,
    steady-state frame; K2 must launch once on the first and not on the
    next.  Then the wall ms of a full ``prepare`` of the same world (what
    a spawn cost before the repack was incremental).  Medians."""
    import torch

    from mo_renderer_tpu_torch import App, scenes
    from mo_renderer_tpu_torch.config import EngineConfig
    from mo_renderer_tpu_torch.kernels import _build

    cfg = EngineConfig(width=1920, height=1080)
    app = App.new(config=cfg, device=device)
    app.world = scenes.grid_world(10)
    app.insert_resource(scenes.grid_camera(cfg))
    app.resumed()
    r, world = app.renderer, app.world
    app.run(num_frames=warmup)

    def wall_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    _build.reset_launches()
    captures = (r._captures, r._shadow_captures)
    sync_ms, first_ms, steady_ms = [], [], []
    for i in range(n_spawns):
        world.spawn(_cube(-4.8 + 2.4 * i, 2.5, 0.0,
                          base_color=(1.0, 1.0, 0.0, 1.0)))
        sync_ms.append(wall_ms(lambda: r._sync_topology(world)))
        if r._prepare_count != 1:
            raise AssertionError(f"spawn@grid: spawn {i} ran a full prepare")
        k2 = _build.LAUNCHES["raster_depth"]
        first_ms.append(wall_ms(app.render_frame))
        k2_first = _build.LAUNCHES["raster_depth"] - k2
        steady_ms.append(wall_ms(app.render_frame))
        k2_next = _build.LAUNCHES["raster_depth"] - k2 - k2_first
        if (k2_first, k2_next) != (1, 0):
            raise AssertionError(
                f"spawn@grid: shadow raster launches {k2_first} on the "
                f"frame after spawn {i} and {k2_next} on the next (want 1, 0)")
    counts = dict(_build.LAUNCHES)
    r.check_overflow()
    if (r._captures, r._shadow_captures) != captures:
        raise AssertionError(f"spawn@grid: the spawns captured: (frame, "
                             f"shadow) captures {captures} -> "
                             f"{(r._captures, r._shadow_captures)}")
    _check_launches("spawn@grid", PATHS["default"][1], counts)
    prepare_ms = [wall_ms(lambda: r.prepare(world)) for _ in range(5)]
    med = {"sync_topology_ms": statistics.median(sync_ms),
           "first_frame_ms": statistics.median(first_ms),
           "steady_frame_ms": statistics.median(steady_ms),
           "prepare_ms": statistics.median(prepare_ms)}
    print(f"[4] spawn@grid 1920x1080 ({r.scene.indices.shape[0]} triangle "
          f"rows): {n_spawns} cube spawns, _sync_topology "
          f"{med['sync_topology_ms']:.3f} ms (median of "
          f"{[round(t, 3) for t in sync_ms]}), first frame after a spawn "
          f"{med['first_frame_ms']:.3f} ms ({[round(t, 3) for t in first_ms]})"
          f", next frame {med['steady_frame_ms']:.3f} ms "
          f"({[round(t, 3) for t in steady_ms]}); full prepare of the same "
          f"world {med['prepare_ms']:.3f} ms "
          f"({[round(t, 3) for t in prepare_ms]}); no capture for the "
          f"{n_spawns} spawns; launches {counts}; on {line}", flush=True)
    return counts, med


def run_window_path(device, line, divisor, n_frames=8, warmup=3):
    """Phase 4, ``window`` and ``window/2``: the 1080p default path on the
    tiny scene through ``run_windowed`` and an OffscreenWindow along the
    orbit, at ``present_divisor`` 1 or 2: ms/frame (the host fetch of the
    presented frame included), in turns with ``App.run`` on the same app
    (window, App.run, App.run, window; the launch counts are those of the
    warm-up and the first window turn), then launches and device ms per
    frame from torch.profiler over two more window frames."""
    import torch

    from mo_renderer_tpu_torch import App, scenes
    from mo_renderer_tpu_torch.app.window import OffscreenWindow, run_windowed
    from mo_renderer_tpu_torch.config import EngineConfig
    from mo_renderer_tpu_torch.kernels import _build

    path = "window" if divisor == 1 else f"window/{divisor}"
    cfg = EngineConfig(width=1920, height=1080)
    app = App.new(config=cfg, device=device)
    app.world = scenes.tiny_world()
    app.insert_resource(scenes.camera(cfg))
    app.add_runtime_system(scenes.orbit_system(warmup + 4 * n_frames))
    window = OffscreenWindow(1920, 1080)

    def run(n):
        return run_windowed(app, window=window, max_frames=n,
                            present_divisor=divisor)

    def ms_per_frame(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(n_frames)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n_frames

    def eager(n):
        before = dict(_build.LAUNCHES)
        with eager_frames(app.renderer):
            run(n)
        _build.LAUNCHES.update(before)

    _build.reset_launches()
    run(warmup)
    turns = {"window": [ms_per_frame(run)], "eager": [ms_per_frame(eager)]}
    counts = dict(_build.LAUNCHES)
    turns["app"] = [ms_per_frame(lambda n: app.run(num_frames=n))]
    turns["window"].append(ms_per_frame(run))
    turns["eager"].append(ms_per_frame(eager))
    ms = statistics.mean(turns["window"])
    app_ms = statistics.mean(turns["app"])
    calls, device_ms = profile_frames(run)
    want = (-(-1080 // divisor), -(-1920 // divisor), 4)
    print(f"[4] {path} 1920x1080 (present_divisor {divisor}): presents "
          f"{window.frame.shape}, {ms:.3f} ms/frame replayed (run_windowed, "
          f"OffscreenWindow; turns {[round(t, 3) for t in turns['window']]})"
          f", the eager frame in turns "
          f"{[round(t, 3) for t in turns['eager']]}, App.run on the same app "
          f"{app_ms:.3f} ms/frame, {n_frames} frames a turn, on {line}; "
          f"profile (2 frames): {calls:.1f} host launch calls/frame, "
          f"{device_ms:.3f} ms/frame of device time; "
          f"{app.renderer._captures} capture(s); launches {counts}",
          flush=True)
    if window.frame.shape != want:
        raise AssertionError(f"{path}: presented {window.frame.shape}, want "
                             f"{want}")
    if window.frame[..., :3].max() == 0:
        raise AssertionError(f"{path}: black frame")
    _check_launches(path, PATHS["default"][1], counts)
    return counts, ms


def _covered_fraction(renderer, world, cfg):
    """Share of the frame's pixels covered by geometry (depth < 1)."""
    from mo_renderer_tpu_torch.kernels.raster_setup import (
        triangle_setup_from_attrs,
    )
    from mo_renderer_tpu_torch.kernels.rasterizer import rasterize
    from mo_renderer_tpu_torch.passes.frame_graph import _bin

    params, _ = renderer.frame_params(world)
    setup = triangle_setup_from_attrs(
        renderer.scene.tri_attrs, renderer.scene.tri_valid,
        params["proj_view"], renderer.pad_w, renderer.pad_h,
    )
    tri, _, _, _ = rasterize(_bin(setup, renderer.pad_w, renderer.pad_h,
                                  renderer._binned_cap),
                             width=renderer.pad_w, height=renderer.pad_h,
                             slim=True)
    return (tri[: cfg.height, : cfg.width] >= 0).float().mean().item()


@contextlib.contextmanager
def _env(**values):
    """The environment variables ``values`` set over the block, the old
    values back after it."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def check_oracle(device):
    """Phase 5: the oracle rasterizer (``kernels/raster_reference``) on
    the card against K6 (full mode) on the same rows: the tiny scene's
    256x128 setup; ids exactly equal, depth within 1e-6."""
    from mo_renderer_tpu_torch import Renderer, scenes
    from mo_renderer_tpu_torch.kernels import raster_setup as RS
    from mo_renderer_tpu_torch.kernels.raster_reference import (
        rasterize_reference,
    )
    from mo_renderer_tpu_torch.kernels.rasterizer import rasterize
    from mo_renderer_tpu_torch.passes.frame_graph import _bin

    cfg = scenes.tiny_config()
    world = scenes.tiny_world()
    world.insert_resource(scenes.camera(cfg))
    r = Renderer(cfg, device)
    r.prepare(world)
    params, _ = r.frame_params(world)
    setup = RS.triangle_setup_from_attrs(
        r.scene.tri_attrs, r.scene.tri_valid, params["proj_view"],
        cfg.width, cfg.height)
    binned = _bin(setup, cfg.width, cfg.height, r._binned_cap)
    tri, z, _, _ = rasterize(binned, width=cfg.width, height=cfg.height)
    o_tri, o_z, _, _ = rasterize_reference(setup, cfg.width, cfg.height)
    covered = float((o_tri >= 0).float().mean())
    mism = int((tri != o_tri).sum())
    dz = float((z - o_z).abs().max())
    if mism or dz > 1e-6 or not 0.1 < covered < 0.95:
        raise AssertionError(f"oracle vs K6: {mism} id mismatches, depth "
                             f"max |diff| {dz}, covered {covered:.3f}")
    print(f"[5] oracle: rasterize_reference on the card equals K6 (full "
          f"mode) on the tiny scene's {setup.tri_data.shape[0]} rows at "
          f"{cfg.width}x{cfg.height}: 0 id mismatches, depth max |diff| "
          f"{dz:.3g}, {covered:.3f} covered", flush=True)


def check_surface(device, line):
    """Phase 5 (after the oracle): the port's programs, each driven through
    its entry point on the card with the launch counts set to 0 just
    before it and read just after: ``bench.run`` at 1920x1080 per frame
    and with ``seq=16``; the examples ``sponza_scale.main`` (1080p, 3
    frames), ``dynamic_spawn.main`` (1280x720; the despawn must restore
    the frame bit for bit) and ``multi_view_flythrough.main`` (3840x2160,
    8 views, 8 steps, on the initialised NCCL world of one: one capture,
    however many steps); ``eval_configs.main`` on ``ibl_preprocess``,
    ``sponza_1080p``, ``multi_view_4k`` (8 steps) and
    ``stress_200k_1080p``, 5 timed frames each: exit 0, every config that
    ran succeeded.  Each path must launch the default path's kernels and
    no other.  Returns {path: launch counts}."""
    import tempfile

    from mo_renderer_tpu_torch import bench, eval_configs
    from mo_renderer_tpu_torch.config import EngineConfig
    from mo_renderer_tpu_torch.examples import (
        dynamic_spawn,
        multi_view_flythrough,
        sponza_scale,
    )
    from mo_renderer_tpu_torch.kernels import _build

    kernels = PATHS["default"][1]
    launches = {}

    def drive(path, fn):
        _build.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t0
        launches[path] = dict(_build.LAUNCHES)
        _check_launches(path, kernels, launches[path])
        return out, wall

    cfg = EngineConfig(width=1920, height=1080)
    for path, seq in (("bench", 1), ("bench/seq16", 16)):
        res, wall = drive(path, lambda: bench.run(cfg, device, seq=seq))
        print(f"[5] {path} ({wall:.1f} s): {json.dumps(res)}", flush=True)

    with tempfile.TemporaryDirectory() as out_dir:
        png = os.path.join(out_dir, "frame.png")
        with _env(MO_WIDTH=1920, MO_HEIGHT=1080, MO_FRAMES=3, MO_OUT=png):
            res, wall = drive("sponza_scale",
                              lambda: sponza_scale.main(device))
        print(f"[5] sponza_scale.main 1920x1080 ({wall:.1f} s): "
              f"{res['fps']:.3f} fps, {res['tris']} triangles, sky "
              f"{res['sky']}; on {line}", flush=True)
        with _env(MO_WIDTH=1280, MO_HEIGHT=720, MO_OUT=png):
            res, wall = drive("dynamic_spawn",
                              lambda: dynamic_spawn.main(device))
        if not res["bit_exact"] or res["prepares"] != 1:
            raise AssertionError(f"dynamic_spawn: {res}")
        print(f"[5] dynamic_spawn.main 1280x720 ({wall:.1f} s): 6 spawns "
              f"in {res['spawn_seconds']:.3f} s, no full prepare, the "
              f"despawn restored the frame bit for bit; sky {res['sky']}; "
              f"on {line}", flush=True)
        with _env(MO_WIDTH=3840, MO_HEIGHT=2160, MO_VIEWS=8, MO_FRAMES=8,
                  MO_OUT=png):
            res, wall = drive("multi_view_flythrough",
                              lambda: multi_view_flythrough.main(device))
        if res["captures"] != 1 or res["devices"] != 1:
            raise AssertionError(f"multi_view_flythrough: {res}")
        print(f"[5] multi_view_flythrough.main 3840x2160 ({wall:.1f} s): "
              f"{res['n_frames']} steps x {res['views']} views, "
              f"{res['frames_per_dispatch']} steps a call, "
              f"{res['views_per_s']:.3f} views/s, {res['captures']} "
              f"capture; sky {res['sky']}; on {line}", flush=True)

        eval_out = os.path.join(out_dir, "eval.json")
        names = "ibl_preprocess,sponza_1080p,multi_view_4k,stress_200k_1080p"
        with _env(MO_EVAL_ONLY=names, MO_EVAL_STRESS=1, MO_EVAL_FRAMES=5,
                  MO_EVAL_MV_FRAMES=8, MO_EVAL_OUT=eval_out):
            rc, wall = drive("eval_configs",
                             lambda: eval_configs.main(device))
        with open(eval_out) as f:
            res = json.load(f)
    ran = [n for n in names.split(",") if "skipped" not in res[n]]
    if rc != 0 or res["failed"] or len(ran) != 4 or not res[
            "ibl_preprocess"]["ok"] or res["multi_view_4k"]["captures"] != 1:
        raise AssertionError(f"eval_configs: rc {rc}, {res}")
    print(f"[5] eval_configs ({wall:.1f} s): {json.dumps(res)}", flush=True)
    return launches


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "mo_renderer_tpu_torch")):
        print("chip_smoke.py must run from a checkout of the repository "
              "(mo_renderer_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs the port on a card",
              file=sys.stderr)
        return 1
    from mo_renderer_tpu_torch.device import card

    device = "cuda"
    line = card(device)
    print(f"[0] {line}", flush=True)
    print(f"[0] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    from mo_renderer_tpu_torch.config import EngineConfig
    from mo_renderer_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    print(f"[1] built {len(_build.sources())} CUDA sources in "
          f"{_build.build_seconds:.1f} s (load {time.perf_counter() - t0:.1f}"
          f" s total)", flush=True)
    for kernel, res in sass_report(_build.build()).items():
        print(f"[1] {kernel}: {json.dumps(res)}", flush=True)
    for kernel, res in sass_report(_build.build(), instances=True).items():
        if kernel.startswith("gbuffer_ref_kernel<"):  # Lb1: dense tables
            print(f"[1] {kernel}: {json.dumps(res)}", flush=True)

    kernels = check_kernels(EngineConfig(width=1920, height=1080), device)
    kernels["shading"]["option_sets"] = check_shading_options(
        EngineConfig(width=1920, height=1080), device)
    kernels["shading@lit"]["option_sets"] = check_shading_options(
        EngineConfig(width=1920, height=1080), device, lit=True)
    kernels["shading_ref"]["option_sets"] = check_shading_ref_options(
        EngineConfig(width=1920, height=1080), device)
    kernels["gbuffer_ref"]["option_sets"] = check_gbuffer_ref_options(
        EngineConfig(width=1920, height=1080), device)
    setup_binning = check_setup_binning(device)
    check_small_frames(device)
    check_topology(device)
    check_window_loop(device)
    check_render_pass(device)
    check_sequences(device)
    # the row-sharded frame's process groups: a world of one, NCCL for the
    # card, and a gloo group of the same world for the CPU comparison
    from mo_renderer_tpu_torch.parallel import make_rank_group

    with nccl_world_of_one() as group:
        check_sharded_frames(device, group, make_rank_group(backend="gloo"))
        check_views(device, group)
        check_interactive(device, group)
        # kernel (or kernel@grid) -> {path: launches during that path's
        # run}, and {path: its launches in one replay of the frame graph}
        launches = {name: {} for name in [*kernels, *SETUP_KERNELS]}
        replays = {name: {} for name in [*kernels, *SETUP_KERNELS]}
        for path, n_frames in (("default", 16), ("reference", 8),
                               ("megakernel", 8), ("stacks", 8),
                               ("default@grid", 4), ("reference@grid", 4),
                               ("megakernel@grid", 4),
                               ("default@lit", 4), ("reference@lit", 4),
                               ("megakernel@lit", 4), ("rows", 8),
                               ("rows@grid", 4), ("rows@lit", 4)):
            counts, _, replay = run_full_frame(device, line, path, n_frames,
                                               group)
            if path in ROWS_PATHS:
                tag = path[path.index("@"):] if "@" in path else ""
                names = [(f"{name}{tag}", name) for name in ROWS_KERNELS]
            elif path in GRID_PATHS:
                names = [(f"{name}@grid", name) for name in
                         set(GRID_PATHS[path][1]) & set(GRID_KERNELS)]
            elif path in LIT_PATHS:
                names = [(f"{name}@lit", name) for name in LIT_PATHS[path][1]]
            else:
                names = [(name, name) for name in set(kernels) & set(KERNELS)
                         if name in PATHS[path][1]]
            # every path sets up and bins: one entry each, by path
            names += [(name, name) for name in SETUP_KERNELS]
            for entry, name in names:
                if entry in launches:
                    launches[entry][path] = counts[name]
                    replays[entry][path] = replay.get(name, 0)
        # camera-path sequences (CUDA graph replay) and multi-view; the
        # profiles each took of its 2-step call (run_sequence_path)
        profiles = {}
        for path, n_steps in (("sequence", 16), ("sequence@grid", 8)):
            counts, _, profiles[path] = run_sequence_path(device, line,
                                                          path, n_steps)
            tag = "@grid" if path.endswith("@grid") else ""
            for name in PATHS["default"][1]:
                if f"{name}{tag}" in launches:
                    launches[f"{name}{tag}"][path] = counts[name]
        counts, _ = run_views_path(device, line, group)
        for name in PATHS["default"][1]:
            launches[name]["views"] = counts[name]
        # the interactive loop: the window on the tiny scene, spawns on
        # the stress scene (its raster and SSAO launches go to the @grid
        # entries)
        for divisor in (1, 2):
            counts, _ = run_window_path(device, line, divisor)
            for name in PATHS["default"][1]:
                launches[name]["window" if divisor == 1
                               else f"window/{divisor}"] = counts[name]
        counts, _ = run_spawn_path(device, line)
        for name in PATHS["default"][1]:
            if f"{name}@grid" in launches:
                launches[f"{name}@grid"]["spawn@grid"] = counts[name]
        # phase 5: the oracle, the bench, the examples and the eval
        # configs (multi-view on this world of one); their launches go
        # to each kernel's own entry, whatever their scene
        check_oracle(device)
        for path, counts in check_surface(device, line).items():
            for name in PATHS["default"][1]:
                launches[name][path] = counts[name]

    # each kernel on the tiny scene's inputs, then the raster modes and
    # SSAO on the stress scene's; launches are those of the paths that ran
    # on the same scene
    summary = {"kernels": [
        {
            "name": name, "route": "cuda",
            "source": KERNELS[name.split("@")[0]][0],
            "replaces": KERNELS[name.split("@")[0]][1],
            "launches": sum(launches[name].values()),
            "launches_by_path": launches[name],
            "replay_launches_by_path": replays[name], **result,
        }
        for name, result in kernels.items()
    ] + [
        {
            "name": name, "route": "cuda", "source": SETUP_SOURCE,
            "replaces": SETUP_REPLACES,
            "launches": sum(launches[name].values()),
            "launches_by_path": launches[name],
            "replay_launches_by_path": replays[name],
        }
        for name in SETUP_KERNELS
    ], "setup_binning": setup_binning,
        "sequence_profile_attempts": profiles}
    print(json.dumps(summary))
    print(line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
