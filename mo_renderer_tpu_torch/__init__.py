"""mo_renderer_tpu_torch — the deferred PBR frame of ``mo_renderer_tpu`` in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The JAX package ``mo_renderer_tpu`` stays the reference; this package
mirrors its layout (``kernels/``, ``passes/``, ``device/``, ``scene/``,
``assets/``, ``app/``, ``math/``, ``config``) and keeps its public names
and array layouts, so the same inputs can be fed to both.  It imports
nothing of the JAX package and never imports ``jax``: the scene API
(``config``, ``math``, ``scene.{world,components,camera,input,timer}``,
``assets.{procedural,model,gltf,materials,...}``, ``app``) is its own copy.

The entry points (``App.new``, ``Renderer``) run on the card
(``device="cuda"``) unless the caller passes ``device="cpu"``.  Three
frame paths: the default (fast sampling, checkerboard), the reference
sampling path (``fast_sampling=False`` or a UV1 material) and the raster
megakernel (``raster_interp_attrs=True``).  A ``RenderPass`` given to
``Renderer`` (or ``App.add_render_pass``) runs between shading and present;
``Renderer.render_sequence_device`` renders a camera path by replaying one
captured CUDA graph of the frame.  ``parallel.TileShardedRenderer`` splits
one frame's rows over the ranks of a ``torch.distributed`` group, and
``parallel.MultiViewRenderer`` a batch of cameras.

Their kernels, each written in CUDA C++ under ``csrc/`` and built with
``nvcc`` at first use (``kernels/_build.py``):

- the tile rasterizer in its visibility, full (barycentrics) and
  depth-only modes (the first and the last also for one band of rows),
  and the megakernel that interpolates attributes,
- ``attr_planes`` (per-pixel attribute interpolation),
- the SSAO tile kernel (also for one band with its neighbours' rows),
- the checkerboard reconstruct-and-interleave kernel.

Each has a plain PyTorch twin in the same module; the twin runs only for
tensors on the CPU.  A CUDA tensor always goes to the kernel.

The package exports the JAX package's top-level names, each its own
class, and carries its programs: ``bench`` and ``eval_configs`` (``python
-m mo_renderer_tpu_torch.bench``, ``.eval_configs``), the four examples
(``examples/``), ``utils`` and the oracle rasterizer
(``kernels/raster_reference``).
"""

# every public name of mo_renderer_tpu/__init__.py, each resolved to the
# port's own class, and the port's Renderer and RenderPass
_EXPORTS = {
    "App": ".app.application",
    "AppError": ".app.application",
    "FColor": ".app.color",
    "Transform": ".math.transform",
    "DirectionalLight": ".scene.components",
    "PointLight": ".scene.components",
    "Camera": ".scene.camera",
    "CameraSettings": ".scene.camera",
    "Input": ".scene.input",
    "Timer": ".scene.timer",
    "Model": ".assets.model",
    "DefaultTextures": ".assets.default_textures",
    "GlobalSamplers": ".assets.samplers",
    "IBLResource": ".assets.ibl_resource",
    "EngineConfig": ".config",
    "Renderer": ".passes.frame_graph",
    "RenderPass": ".passes.frame_graph",
}


def __getattr__(name):
    # lazy exports (PEP 562), as in mo_renderer_tpu/__init__.py
    if name in _EXPORTS:
        import importlib

        val = getattr(importlib.import_module(_EXPORTS[name], __name__), name)
        globals()[name] = val
        return val
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = list(_EXPORTS)

__version__ = "0.1.0"
