"""Whole 256x128 frames of the port under the fast path's texture and
SSAO options against the JAX frame of the same scene and config: the
texture-stack path (attrs kernel off, stack kernel on) and both plane
kernels on, on the all-slots scene; SSAO without the tile kernel; the
specular taps from separate rows.  Also: the stack kernel on vs off in
the port itself, and the paths that never run it.

Bar: the golden bar of tests/test_golden.py:99-107 (mean |diff| < 2/255,
fewer than 0.5% of channels above 16/255) against the JAX frame; stack
kernel on vs off <= 1 LSB (tests/test_stack_planes.py:78).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from mo_renderer_tpu_torch.passes import gbuffer as G  # noqa: E402

from test_torch_frame import _check, _jax_frame, _port_frame  # noqa: E402

STACKS = dict(attrs_plane_kernel=False, stack_plane_kernel=True)


@pytest.mark.parametrize("overrides,all_slots", [
    (STACKS, True),
    (dict(attrs_plane_kernel=True, stack_plane_kernel=True), True),
    (dict(ssao_pallas=False), False),
    (dict(spec_merged_trilinear=False), False),
], ids=["stacks", "both-plane-kernels", "ssao-no-kernel", "spec-unmerged"])
def test_option_frame_matches_reference(overrides, all_slots):
    frame, r = _port_frame(with_renderer=True, all_slots=all_slots,
                           **overrides)
    if all_slots:
        assert r._slot_map == (0, 1, 2, 3, 4)
    _check(frame, _jax_frame(all_slots=all_slots, **overrides),
           f"{overrides} vs JAX frame")


def test_stack_kernel_on_vs_off_within_one_lsb(monkeypatch):
    """The stack kernel's planes vs the torch-op slot sampling in the
    port's own frame (all-slots scene); and it runs on that path."""
    calls = []
    real = G.stack_planes

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(G, "stack_planes", counted)
    off = _port_frame(all_slots=True, attrs_plane_kernel=False)
    assert not calls
    on = _port_frame(all_slots=True, **STACKS)
    assert calls
    diff = np.abs(on.astype(int) - off.astype(int))
    print(f"stack kernel on vs off: max {diff.max()} LSB")
    assert diff.max() <= 1


@pytest.mark.parametrize("overrides", [
    dict(fast_sampling=False),
    dict(raster_interp_attrs=True, ssao_res_divisor=1),
], ids=["reference-path", "megakernel"])
def test_other_paths_never_run_the_stack_kernel(monkeypatch, overrides):
    """As in the reference, only the fast path's attrs-setup G-buffer
    takes stack_plane_kernel; the reference path and the megakernel
    ignore it."""
    def no_kernel(*args, **kw):
        raise AssertionError("stack_planes called off the fast path")

    monkeypatch.setattr(G, "stack_planes", no_kernel)
    frame = _port_frame(all_slots=True, stack_plane_kernel=True, **overrides)
    assert frame[..., :3].max() > 0
