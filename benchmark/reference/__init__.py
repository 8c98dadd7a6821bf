"""The plain reference the benchmark holds the port to.

``plain/`` is a frozen copy of the port's plain PyTorch versions (the
ops each hand kernel is checked against, which the port itself runs only
for CPU tensors), taken from ``mo_renderer_tpu_torch`` with every CUDA
dispatch, ctypes binding and kernel build removed, so that a CUDA tensor
runs the same plain ops as a CPU one.  ``render.ReferenceRenderer`` works
out from the benchmark's own inputs everything the port's set-up
derives: the packed scene, the IBL maps, the shadow map (rasterized in
every frame, not memoized) and, after an edit, the edited scene (packed
afresh).  Nothing here imports the port, JAX or the JAX package."""
