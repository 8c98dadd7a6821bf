"""Whole 256x128 frames of the port under the fast path's shading
options against the JAX frame of the same scene and config: the two
other PCF table layouts, the parent-mip tap at full rate, and the
mirror tap at full rate (which needs the checkerboard off).

Bar: the golden bar of tests/test_golden.py:99-107 (mean |diff| < 2/255,
fewer than 0.5% of channels above 16/255) against the JAX frame.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402

from mo_renderer_tpu_torch.device import sampling as S  # noqa: E402

from test_torch_frame import _check, _jax_frame, _port_frame  # noqa: E402


@pytest.mark.parametrize("overrides,builder", [
    (dict(pcf_u16=False), S.build_window_rows_2x4),
    (dict(pcf_half_anchor=False), S.build_pcf_window_u16),
    (dict(spec_parent_mip_half_res=False), S.build_pcf_window_u16_half),
    (dict(spec_mirror_half_res=False, checkerboard=False),
     S.build_pcf_window_u16_half),
], ids=["pcf-f32", "pcf-u16-full", "spec-parent-full", "spec-mirror-full"])
def test_option_frame_matches_reference(overrides, builder):
    frame, r = _port_frame(with_renderer=True, **overrides)
    # the memoized shadow table is the layout the config picks
    quads = r._shadow_quads
    s = r.config.shadow_map_size
    want_rows = (s // 2) ** 2 if builder is S.build_pcf_window_u16_half \
        else s * s
    assert quads.shape[0] == want_rows
    assert (quads.dtype.is_floating_point
            == (builder is S.build_window_rows_2x4))
    _check(frame, _jax_frame(**overrides), f"{overrides} vs JAX frame")
