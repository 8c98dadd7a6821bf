"""Present pass (port of ``mo_renderer_tpu/passes/present.py``): quantize
the tonemapped colour to rgba8, one packed word per pixel
(R | G<<8 | B<<16 | A<<24, held as int32 bits on the device).

The frames that are not checkerboarded call ``present_pass``.  A
checkerboard frame is quantised inside the reconstruct kernel instead
(``checkerboard.reconstruct_present``, ``csrc/interleave.cu``), with this
function's arithmetic: clamp to [0, 1], one rounding for the product with
255, round half to even, alpha 0xFF; there ``present_pass`` is the plain
version the kernel is held to.

``unpack_rgba8`` fetches a frame to the host: a card's frame through
page-locked memory (``_fetch_pinned``)."""

from __future__ import annotations

import numpy as np
import torch

from ..utils import trace

ALPHA_BITS = -16777216  # 0xFF000000 as an int32 bit pattern


def present_pass(color):
    """color (H, W, 3) float [0, 1] -> (H, W) int32 packed rgba8 bits."""
    v = torch.round(torch.clamp(color, 0.0, 1.0) * 255.0).to(torch.int32)
    return v[..., 0] | (v[..., 1] << 8) | (v[..., 2] << 16) | ALPHA_BITS


def _fetch_pinned(packed):
    """A CUDA tensor's copy in page-locked host memory from PyTorch's
    caching host allocator: one asynchronous copy on the current stream of
    its device (the stream that produced it), then one wait on an event
    recorded after the copy, which waits for that stream's work alone.
    Once the caller drops the copy, its block goes back to the cache, so
    in the steady state a fetch allocates no host memory."""
    stream = torch.cuda.current_stream(packed.device)
    with trace.span("fetch_issue"):
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    with trace.span("fetch_wait"):
        done.synchronize()
    return host


def unpack_rgba8(packed) -> np.ndarray:
    """Host side: (..., H, W) packed words -> (..., H, W, 4) uint8 — a
    byte view of the little-endian words.

    A CUDA tensor comes through ``_fetch_pinned``, and the array returned
    views its pinned copy and keeps it alive, so a frame the caller holds
    is never overwritten.  A CPU tensor or a numpy array is viewed as it
    is (copied only where it is not contiguous).  Counters: ``fetch_bytes``
    the bytes of every tensor fetched, ``fetch_pinned`` the fetches of a
    CUDA tensor."""
    if torch.is_tensor(packed):
        trace.count("fetch_bytes", packed.numel() * packed.element_size())
        if packed.is_cuda:
            trace.count("fetch_pinned")
            packed = _fetch_pinned(packed)
        packed = packed.cpu().numpy()
    packed = np.ascontiguousarray(np.asarray(packed).view("<u4"))
    return packed.view(np.uint8).reshape(packed.shape + (4,))
