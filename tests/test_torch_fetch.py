"""The frame's fetch to host memory (``passes/present.py`` ``unpack_rgba8``)
and the drain of its dropped-pair counts after it (``Renderer.render``)
on the CPU: host input keeps the plain byte view, frames stay apart and
held frames unchanged, an overflow raises on the frame that dropped
geometry, and the fetch counters (``fetch_bytes``, ``fetch_pinned``).

CPU frames at 128x32 with one computed IBL for the module; no JAX.  The
card's cases (the pinned path) are in ``tests/test_torch_cuda.py``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from mo_renderer_tpu_torch import App, scenes  # noqa: E402
from mo_renderer_tpu_torch.assets.procedural import procedural_model  # noqa: E402
from mo_renderer_tpu_torch.math.transform import Transform  # noqa: E402
from mo_renderer_tpu_torch.passes.present import unpack_rgba8  # noqa: E402
from mo_renderer_tpu_torch.scene.camera import Camera  # noqa: E402
from mo_renderer_tpu_torch.utils import trace  # noqa: E402


@pytest.fixture(scope="module")
def ibl():
    res = scenes.tiny_ibl("cpu")
    res.ensure_computed()
    return res


def _plain_unpack(packed):
    """The byte view as the host path has always made it."""
    if torch.is_tensor(packed):
        packed = packed.cpu().numpy()
    packed = np.ascontiguousarray(np.asarray(packed).view("<u4"))
    return packed.view(np.uint8).reshape(packed.shape + (4,))


def _words(shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("form", ["numpy", "tensor", "tensor_strided",
                                  "tensor_batched"])
def test_host_input_keeps_the_plain_byte_view(form):
    words = _words((3, 32, 130) if form == "tensor_batched" else (32, 130))
    packed = {"numpy": words,
              "tensor": torch.from_numpy(words),
              "tensor_strided": torch.from_numpy(words)[:, 1:129],
              "tensor_batched": torch.from_numpy(words)}[form]
    before = trace.snapshot()["counters"].get("fetch_pinned", 0)
    got = unpack_rgba8(packed)
    want = _plain_unpack(packed)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert got.shape == tuple(packed.shape) + (4,)
    np.testing.assert_array_equal(got, want)
    # little-endian words: R is the low byte
    w = np.asarray(packed).astype(np.int64) & 0xFFFFFFFF
    np.testing.assert_array_equal(got[..., 0], w & 0xFF)
    np.testing.assert_array_equal(got[..., 3], w >> 24)
    if form in ("numpy", "tensor"):  # a contiguous host frame is viewed
        assert np.shares_memory(got, np.asarray(packed))
    assert trace.snapshot()["counters"].get("fetch_pinned", 0) == before


def _app(ibl, **overrides):
    """A CPU App on the tiny scene whose camera turns 0.3 rad a frame."""
    cfg = scenes.tiny_config(width=128, height=32, **overrides)
    app = App.new(config=cfg, device="cpu")
    app.world = scenes.tiny_world()
    app.world.insert_resource(ibl)
    app.insert_resource(scenes.camera(cfg))
    turn = {"i": 0}

    def orbit(world):
        cam, pose = world.resource(Camera), scenes.camera(cfg,
                                                          0.3 * turn["i"])
        cam.transform.translation = pose.transform.translation
        cam.transform.rotation = pose.transform.rotation
        cam.refresh_view()
        turn["i"] += 1

    app.add_runtime_system(orbit)
    app.resumed()
    return app


def test_frames_are_distinct_and_a_held_frame_is_kept(ibl):
    app = _app(ibl)
    first = app.render_frame()
    second = app.render_frame()
    assert not np.shares_memory(first, second)
    assert not np.array_equal(first, second)  # the camera moved
    held = first.copy()
    later = [app.render_frame() for _ in range(3)]
    np.testing.assert_array_equal(first, held)
    assert all(not np.shares_memory(first, f) for f in later)


def test_overflow_raises_on_the_frame_that_dropped_pairs(ibl):
    """Under a small pair capacity the tiny scene fits; a sphere spawned in
    view does not, and the frame after the spawn raises, with the message
    that names the dropped pairs and the capacity."""
    app = _app(ibl, binned_cap=512, shadow_enabled=False)
    for _ in range(2):
        app.render_frame()
    app.world.spawn((Transform.from_xyz(0.6, 0.5, 0.6),
                     procedural_model("sphere")))
    index = app.frame_index
    with pytest.raises(RuntimeError, match=(
            r"rasterizer bin overflow: [1-9]\d* G-buffer and 0 shadow "
            r"\(tile, triangle\) pairs dropped — geometry is missing from "
            r"the frame\.  Raise EngineConfig\.binned_cap \(current 512\) "
            r"and re-prepare\.")):
        app.render_frame()
    assert app.frame_index == index  # raised inside that frame
    assert app.renderer._pending_overflow == []  # every count drained


def test_fetch_counters_on_the_cpu(ibl):
    app = _app(ibl)
    app.render_frame()
    before = trace.snapshot()["counters"]
    n = 3
    for _ in range(n):
        app.render_frame()
    after = trace.snapshot()["counters"]
    h, w = app.config.height, app.config.width
    assert (after["fetch_bytes"] - before.get("fetch_bytes", 0)
            == n * h * w * 4)
    assert after.get("fetch_pinned", 0) == before.get("fetch_pinned", 0)
