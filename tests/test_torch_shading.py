"""The host side of the shading kernel K9 (``csrc/shading.cu``), on the
CPU: the argument block the wrapper packs (``shading.shade_args``: the
domain and even-grid sizes, strides of views, the light count, the PCF
layout code, the IBL level tables), the ctypes layout against the C
struct, the constant tables the kernel keeps against the Python ones, and
that a CPU G-buffer runs the PyTorch ops without touching the library.
The kernel itself runs only on a card (tests/test_torch_cuda.py,
chip_smoke.py phase 2).
"""

import ctypes
import os
import re
import sys
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from mo_renderer_tpu_torch import scenes  # noqa: E402
from mo_renderer_tpu_torch.device import sampling as S  # noqa: E402
from mo_renderer_tpu_torch.kernels import _build  # noqa: E402
from mo_renderer_tpu_torch.kernels.env_brdf_coeffs import COEFFS  # noqa: E402
from mo_renderer_tpu_torch.kernels.ibl import _SH_C  # noqa: E402
from mo_renderer_tpu_torch.passes import shading as Sh  # noqa: E402
from mo_renderer_tpu_torch.passes.gbuffer import GBuffer  # noqa: E402

SOURCE = os.path.join(os.path.dirname(_build.CSRC), "csrc", "shading.cu")
# the device helpers and constants K9 shares with K11
COMMON = os.path.join(os.path.dirname(SOURCE), "shading_common.cuh")


def _source():
    """The unit's text with the shared header it includes."""
    text = []
    for path in (COMMON, SOURCE):
        with open(path) as f:
            text.append(f.read())
    return "\n".join(text)


def _floats(text):
    """The float literals of a C initializer, as float32."""
    vals = re.findall(r"\(float\)\s*(-?[0-9.e+-]+)|(-?[0-9.]+(?:e[+-]?\d+)?)f",
                      text)
    return np.array([float(a or b) for a, b in vals], np.float32)


def _initializer(name):
    m = re.search(name + r"[^=]*=\s*\{(.*?)\};", _source(), re.S)
    assert m, name
    return _floats(m.group(1))


def test_constant_tables_match_the_python_ones():
    """The environment BRDF's 338 coefficients, the Poisson taps and the
    SH basis constants in __constant__ memory are the float32 roundings
    of the plain version's Python scalars."""
    np.testing.assert_array_equal(
        _initializer("kEnvBrdf"), np.float32(COEFFS).reshape(-1))
    np.testing.assert_array_equal(
        _initializer("kPoisson"), np.float32(Sh.POISSON).reshape(-1))
    np.testing.assert_array_equal(_initializer("kSh"), np.float32(_SH_C))


_C_TYPES = {"const float*": ctypes.c_void_p, "float*": ctypes.c_void_p,
            "uint8_t*": ctypes.c_void_p, "const int*": ctypes.c_void_p,
            "int*": ctypes.c_void_p,
            "const void*": ctypes.c_void_p, "long long": ctypes.c_longlong,
            "int": ctypes.c_int}


def test_ctypes_layout_follows_the_c_struct():
    """ShadeArgs has csrc/shading.cu's fields in its order, with its
    types and array sizes (the card checks sizeof as well)."""
    body = re.search(r"struct ShadeArgs \{(.*?)\n\};", _source(), re.S)
    want = []
    for decl in re.sub(r"//[^\n]*", "", body.group(1)).split(";"):
        decl = " ".join(decl.split())
        if not decl:
            continue
        ctype = max((t for t in _C_TYPES if decl.startswith(t + " ")),
                    key=len)
        names = decl[len(ctype) + 1:]
        for name in names.split(", "):
            dims = [int(d) for d in re.findall(r"\[(\d+)\]", name)]
            want.append((name.split("[")[0], _C_TYPES[ctype],
                         int(np.prod(dims)) if dims else 1))
    got = []
    for name, ctype in Sh.ShadeArgs._fields_:
        if hasattr(ctype, "_length_"):  # an array field
            ctype, n = ctype._type_, ctype._length_
        else:
            n = 1
        got.append((name, ctype, n))
    assert [(n.rstrip("_"), t, k) for n, t, k in want] == got


def _gbuf(h, w, seed=0):
    rng = np.random.default_rng(seed)

    def plane(*shape):
        return torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32))

    return GBuffer(base_color=plane(h, w, 3), position=plane(h, w, 3),
                   normal=plane(h, w, 3), emissive=plane(h, w, 3),
                   orm=plane(h, w, 3), velocity=plane(h, w, 2),
                   depth=plane(h, w), mask=torch.ones(h, w, dtype=bool))


@pytest.fixture(scope="module")
def ibl():
    return scenes.tiny_ibl("cpu").maps()


def _params():
    return {"eye_pos": torch.tensor([0.0, 1.0, -3.0]),
            "light_proj_view": torch.eye(4),
            "right": torch.tensor([1.0, 0.0, 0.0]),
            "up": torch.tensor([0.0, 1.0, 0.0]),
            "direction": torch.tensor([0.0, 0.0, 1.0]),
            "near": torch.tensor(0.1),
            "near_wh": torch.tensor([0.2, 0.1])}


def _args(gbuf, ssao, rows, s, lights, n, ibl, divisor=4, parent=True,
          mirror=True, merged=True, cb=True, row_offset=0, full_height=None):
    return (gbuf, ssao, rows, s, lights, n, _params(), ibl, divisor, parent,
            mirror, merged, cb, row_offset, full_height)


@pytest.mark.parametrize("cb,divisor,h,w,even,pcf", [
    (True, 4, 16, 24, (8, 24), (4, 12)),
    (True, 2, 15, 24, (8, 24), (8, 24)),
    (False, 4, 16, 48, (8, 24), (4, 12)),
    (False, 1, 17, 47, (9, 24), (17, 47)),
])
def test_shade_args_sizes(ibl, cb, divisor, h, w, even, pcf):
    """Domain, even grid and PCF grid (the whole domain at divisor 1); the
    planes the kernel writes (the even-grid samples and the PCF factors
    with ``debug``)."""
    s = 64
    rows = S.build_pcf_window_u16_half(torch.rand(s, s))
    a, keep = Sh.shade_args(*_args(
        _gbuf(h, w), torch.rand(h, w), rows, s, torch.zeros(3, 20), 2, ibl,
        divisor=divisor, cb=cb), debug=True)
    assert (a.h, a.w, a.hh, a.wh) == (h, w) + even
    assert keep["out"].shape == (h, w, 3) and a.out == keep["out"].data_ptr()
    assert keep["c0h"].shape == keep["c1h"].shape == even + (3,)
    assert keep["skyh"].dtype == torch.uint8
    assert keep["rows_h"].shape == even + (2,)
    assert keep["rows_h"].dtype == torch.int32
    if pcf is None:
        assert keep["pcf"] is None and a.pcf is None
    else:
        assert (a.hq, a.wq) == pcf and keep["pcf"].shape == pcf
    assert a.sky_w == (2 * w if cb else w)
    assert a.full_height == h and a.row_offset == 0


def test_shade_args_strides_lights_and_tables(ibl):
    """Views are read where they are (their strides, no copy); the light
    count is capped at the table's rows; the level tables are the
    chain's cached device tables; the environment is mip 0."""
    gb = _gbuf(32, 40)
    big = torch.rand(40, 48)
    ssao = big[4:36, 2:42]  # a view, as the frame's SSAO slice is
    gb.depth = big.t()[:32, :40]  # a transposed view
    lights = torch.rand(3, 20)
    a, keep = Sh.shade_args(*_args(
        gb, ssao, None, 64, lights, 7, ibl, row_offset=8, full_height=64))
    assert a.ssao == ssao.data_ptr() and tuple(a.ssao_strides) == (48, 1)
    assert a.depth == gb.depth.data_ptr()
    assert tuple(a.depth_strides) == (1, 48)
    assert list(a.strides) == [120, 3, 1] * 5
    assert a.n_lights == 3 and a.light_stride == 20
    assert a.lights == lights.data_ptr()
    sizes, offsets = S._level_tables(ibl.specular_quad, "cpu")
    assert (a.sizes, a.offsets) == (sizes.data_ptr(), offsets.data_ptr())
    assert a.num_levels == ibl.specular_quad.num_levels
    assert (a.env_size, a.env_off) == (int(ibl.specular_quad.sizes[0]), 0)
    assert a.merged_rows == ibl.specular_quad_merged.rows.data_ptr()
    assert (a.row_offset, a.full_height) == (8, 64)
    assert a.pcf_layout == Sh.PCF_NONE and a.pcf_rows is None


@pytest.mark.parametrize("flags,want", [
    ((True, True, True), (1, 1, 1, 0)),
    ((True, True, False), (1, 1, 0, 0)),
    ((False, True, True), (1, 0, 0, 0)),
    ((True, False, False), (0, 1, 0, 0)),
    ((False, False, False), (0, 0, 0, 0)),
])
def test_shade_args_specular_flags(ibl, flags, want):
    """Which even-grid taps run and which table the mirror tap reads; the
    merged table only when both taps are on the even grid.  The even-grid
    samples stay in shared memory: only ``debug`` gives them planes."""
    parent, mirror, merged = flags
    args = _args(_gbuf(8, 16), torch.rand(8, 16), None, 64,
                 torch.zeros(1, 20), 1, ibl, parent=parent, mirror=mirror,
                 merged=merged, cb=False)
    a, keep = Sh.shade_args(*args, debug=True)
    assert (a.mirror_half, a.parent_half, bool(a.merged_rows),
            a.has_ibl - 1) == want
    assert (keep["c0h"] is not None) == mirror
    assert (keep["c1h"] is not None) == parent
    assert (keep["rows_h"] is not None) == bool(parent or mirror)
    a, keep = Sh.shade_args(*args)
    assert all(keep[k] is None and getattr(a, k) is None
               for k in ("c0h", "c1h", "skyh", "rows_h", "pcf"))


def test_debug_channels_follow_the_c_constants(ibl):
    """The full-rate choices' channels (FAST_DEBUG) are csrc/shading.cu's
    kDbg* in their order; ``debug`` gives every pixel its channels, int32,
    and the frame's call (no ``debug``) passes a null pointer."""
    consts = {name: int(v) for name, v in re.findall(
        r"constexpr int kDbg(\w+) = (\d+);", _source())}
    channels = consts.pop("Channels")
    snake = {re.sub(r"(?<!^)([A-Z])", r"_\1", k).lower(): v
             for k, v in consts.items()}
    assert sorted(snake, key=snake.get) == list(Sh.FAST_DEBUG)
    assert channels == len(Sh.FAST_DEBUG) == 4
    args = _args(_gbuf(9, 14), torch.rand(9, 14), None, 64,
                 torch.zeros(1, 20), 1, ibl, cb=False)
    a, keep = Sh.shade_args(*args, debug=True)
    assert keep["dbg"].shape == (9, 14, channels)
    assert keep["dbg"].dtype == torch.int32
    assert a.dbg == keep["dbg"].data_ptr()
    a, keep = Sh.shade_args(*args)
    assert keep["dbg"] is None and a.dbg is None


def test_shade_args_without_ibl_or_shadow():
    a, keep = Sh.shade_args(*_args(
        _gbuf(8, 16), torch.rand(8, 16), None, 64, torch.zeros(1, 20), 1,
        None), debug=True)
    assert not a.has_ibl
    assert a.spec_rows is None and a.sh9 is None
    assert all(keep[k] is None for k in ("c0h", "c1h", "skyh", "pcf"))


def test_pcf_layout_codes():
    """Each builder's table gives its code; a table of no layout raises."""
    s = 32
    img = torch.rand(s, s)
    assert Sh.pcf_layout(None, s) == Sh.PCF_NONE
    assert Sh.pcf_layout(S.build_pcf_window_u16_half(img), s) == \
        Sh.PCF_U16_HALF
    assert Sh.pcf_layout(S.build_pcf_window_u16(img), s) == Sh.PCF_U16_FULL
    assert Sh.pcf_layout(S.build_window_rows_2x4(img), s) == Sh.PCF_F32_WIDE
    with pytest.raises(ValueError, match="no layout"):
        Sh.pcf_layout(S.build_window_rows_2x4(img)[:-1], s)
    with pytest.raises(ValueError, match="no layout"):
        Sh.pcf_layout(S.build_pcf_window_u16(img).to(torch.int64), s)


def test_shade_args_refuses_what_the_kernel_does_not_take(ibl):
    gb = _gbuf(8, 16)
    with pytest.raises(NotImplementedError, match="spec_mirror_half_res"):
        Sh.shade_args(*_args(gb, torch.rand(8, 16), None, 64,
                             torch.zeros(1, 20), 1, ibl, mirror=False))
    with pytest.raises(ValueError, match="shadow_res_divisor"):
        Sh.shade_args(*_args(gb, torch.rand(8, 16), None, 64,
                             torch.zeros(1, 20), 1, ibl, divisor=3))
    with pytest.raises(ValueError, match="ssao"):
        Sh.shade_args(*_args(gb, torch.rand(8, 15), None, 64,
                             torch.zeros(1, 20), 1, ibl))


def test_cpu_gbuffer_runs_the_plain_version(ibl, monkeypatch):
    """A CPU G-buffer never loads the library: shading_pass_fast is the
    PyTorch ops, equal to _shading_fast_plain."""
    def boom():
        raise AssertionError("the CPU path loaded the CUDA library")

    monkeypatch.setattr(_build, "library", boom)
    args = _args(_gbuf(8, 16), torch.rand(8, 16),
                 S.build_pcf_window_u16_half(torch.rand(64, 64)), 64,
                 torch.rand(2, 20), 2, ibl)
    got = Sh.shading_pass_fast(*args[:7], ibl=ibl, shadow_res_divisor=4,
                               cb=True)
    assert torch.equal(got, Sh._shading_fast_plain(*args))


def test_shared_memory_limits_follow_the_c_constants(ibl):
    """The constants shade_args packs for are the kernel's own: the light
    columns it copies to shared memory, the rows of the chunk a longer
    table streams through, the specular levels; a light table past one
    chunk (539 rows) or two (1025, 1024 point lights and a sun) builds
    its arguments with every row, and too many levels still raise."""
    consts = {}
    for name, v in re.findall(r"constexpr int (k\w+) = ([^;]+);", _source()):
        consts[name] = eval(v.replace("/", "//"), {}, dict(consts))
    assert (consts["kLightCols"], consts["kLightChunkRows"],
            consts["kMaxLevels"]) == (Sh.LIGHT_COLS, Sh.LIGHT_CHUNK_ROWS,
                                      Sh.MAX_LEVELS)
    assert Sh.LIGHT_CHUNK_ROWS * Sh.LIGHT_COLS * 4 <= 40 * 1024
    for n in (Sh.LIGHT_CHUNK_ROWS + 1, 1025):
        lights = torch.zeros(n + 3, 20)
        a, keep = Sh.shade_args(*_args(_gbuf(8, 16), torch.rand(8, 16), None,
                                       64, lights, n, None))
        assert (a.n_lights, a.light_stride) == (n, 20)
        assert a.lights == lights.data_ptr() == keep["lights"].data_ptr()
    mq = ibl.specular_quad
    extra = Sh.MAX_LEVELS + 1 - mq.num_levels
    deep = types.SimpleNamespace(**vars(ibl))
    deep.specular_quad = types.SimpleNamespace(
        rows=mq.rows, num_levels=Sh.MAX_LEVELS + 1,
        sizes=list(mq.sizes) + [1] * extra,
        offsets=list(mq.offsets) + [int(mq.offsets[-1])] * extra)
    with pytest.raises(ValueError, match="specular levels"):
        Sh.shade_args(*_args(_gbuf(8, 16), torch.rand(8, 16), None, 64,
                             torch.zeros(5, 20), 5, deep))
